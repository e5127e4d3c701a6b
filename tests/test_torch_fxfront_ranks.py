"""The per-rank programs that the multi-rank frontend tests spawn on gloo
(`tests/test_torch_fxfront_e2e.py`, `tests/test_torch_fxfront_emit.py`).

Holds no tests of its own.  It imports torch, numpy and the port only,
so a spawned process never loads JAX.  Every process group gets a
`FileStore` in the test's own directory (no TCP port to collide on
between xdist workers), one intra-op thread, CPU discovery, no
persistent caches outside that directory, and the cost constants the
caller hands it.  Each rank pickles what it returns to
`<out>/rank<r>.pkl`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

RTOL_LOSS, ATOL_LOSS = 1e-4, 1e-6
RTOL_PARAM, ATOL_PARAM = 1e-4, 1e-5


def spawn(scenario: str, world: int, tmp_path, timeout: float = 300.0,
          **kw):
    """Run `scenario(rank, world, **kw)` on `world` gloo ranks (a function
    of this module, or "module:function" of another); returns
    each rank's result.  A rank that fails stops the others (their
    collectives time out after 120 s at most); ranks still running after
    `timeout` seconds are killed and the call raises."""
    import time

    import torch.multiprocessing as mp

    out = str(tmp_path)
    ctx = mp.spawn(_entry, args=(world, scenario, out, kw), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{scenario} on {world} ranks ran past "
                               f"{timeout} s")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, world, scenario, out, kw):
    torch.set_num_threads(1)
    import datetime

    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from easydist_tpu_torch import config as edconfig

    edconfig.discovery_device = "cpu"
    edconfig.discovery_cache_dir = os.path.join(out, "discovery")
    edconfig.compile_cache_dir = os.path.join(out, "compile")
    edconfig.prof_db_path = os.path.join(out, f"perf{rank}.db")
    for name, value in kw.pop("constants", {}).items():
        setattr(edconfig, name, value)
    try:
        result = _scenario(scenario)(rank, world, out=out, **kw)
    finally:
        from easydist_tpu_torch.fxfront import set_device_mesh

        set_device_mesh(None)
        dist.barrier()
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _scenario(name: str):
    """A scenario of this module, or "module:function" of another."""
    if ":" not in name:
        return globals()[name]
    import importlib

    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _max_err(got, want):
    """max |got - want| / (atol + rtol |want|) over the leaves (<= 1
    passes) at the parameter bars."""
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        g = _full(g).double()
        w = w.double()
        tol = ATOL_PARAM + RTOL_PARAM * w.abs()
        worst = max(worst, float(((g - w).abs() / tol).max()))
    return worst


def _any_mm_sharded(result) -> bool:
    return any(n.startswith("mm") and not s.is_all_replicate()
               for chosen in result.strategies for n, s in chosen.items())


def _mlp_data(sizes=(256, 512, 256), batch=2048):
    from easydist_tpu_torch.models import mlp as tmlp

    params = tmlp.mlp_init(torch.Generator().manual_seed(0), sizes,
                           device="cpu")
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(batch, sizes[0]).astype(np.float32))
    y = torch.from_numpy(rs.randn(batch, sizes[-1]).astype(np.float32))
    return params, x, y


def _train(compiled, step, state, args, steps):
    """(compiled losses, eager losses, compiled state, eager state)."""
    eager = pytree.tree_map(torch.clone, state)
    losses, eager_losses = [], []
    for _ in range(steps):
        state, loss = compiled(state, *args)
        losses.append(float(loss))
        eager, loss = step(eager, *args)
        eager_losses.append(float(loss))
    return losses, eager_losses, state, eager


# ------------------------------------------------------------ scenarios

def mlp_1d(rank, world, out):
    """The JAX package's e2e tests on a (world,) mesh, on the port's MLP
    train step (`tests/test_jaxfront/test_e2e.py`)."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models import mlp as tmlp

    mesh = make_device_mesh((world,), ("d",), device_type="cpu")
    step = tmlp.make_mlp_train_step()
    params, x, y = _mlp_data()
    res = {}

    compiled = easydist_compile(step, mesh=mesh, donate_state=False)
    losses, eager, state, eager_state = _train(compiled, step, params,
                                               (x, y), 3)
    result = compiled.get_compiled(state, x, y)
    res["train"] = dict(losses=losses, eager=eager,
                        err=_max_err(state, eager_state),
                        mm_sharded=_any_mm_sharded(result),
                        inputs_sharded=any(
                            p.is_shard() for pl in result.in_placements
                            for p in pl),
                        signatures=compiled.cache_stats()["size"])

    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    xi = torch.randn(32, 8, generator=torch.Generator().manual_seed(2))

    def fwd(w, x):
        return torch.relu(x @ w)

    got = easydist_compile(fwd, mesh=mesh)(w, xi)
    res["inference"] = float((got - fwd(w, xi)).abs().max())

    def f(a, b):
        return a @ b

    comp = easydist_compile(f, mesh=mesh)
    a1, b1 = torch.ones(8, 16), torch.ones(16, 8)
    a2, b2 = torch.ones(16, 32), torch.ones(32, 16)
    res["recompile"] = dict(
        errs=[float((comp(a1, b1) - a1 @ b1).abs().max()),
              float((comp(a2, b2) - a2 @ b2).abs().max())],
        size=comp.cache_stats()["size"])

    only = easydist_compile(f, mesh=mesh, compile_only=True)(
        torch.ones(8, 8), torch.ones(8, 8))
    res["compile_only"] = dict(
        type=type(only).__name__, has=all(
            hasattr(only, k) for k in ("strategies", "in_placements",
                                       "graph_module", "collectives")),
        n_axes=len(only.strategies))

    edconfig.solver_backend = "beam"
    try:
        beam = easydist_compile(step, mesh=mesh, donate_state=False)
        (_, loss_b) = beam(params, x, y)
        _, loss_e = step(params, x, y)
        res["beam"] = dict(loss=float(loss_b), eager=float(loss_e),
                           mm_sharded=_any_mm_sharded(
                               beam.get_compiled(params, x, y)))
    finally:
        edconfig.solver_backend = "milp"

    edconfig.enable_compile_cache = True
    try:
        first = easydist_compile(step, mesh=mesh, compile_only=True)(
            params, x, y)
        again = easydist_compile(step, mesh=mesh, donate_state=False)
        second = again.get_compiled(params, x, y)
        (_, loss_c) = again(params, x, y)
        res["cache"] = dict(
            files=sorted(f for f in os.listdir(edconfig.compile_cache_dir)
                         if f.startswith("strategies_")),
            first_solved="solve" in first.timings,
            second_solved="solve" in second.timings,
            same=[{k: repr(v) for k, v in c.items()}
                  for c in first.strategies]
            == [{k: repr(v) for k, v in c.items()}
                for c in second.strategies],
            loss=float(loss_c), eager=float(step(params, x, y)[1]))
    finally:
        edconfig.enable_compile_cache = False

    donated = easydist_compile(step, mesh=mesh)
    placed = donated.get_compiled(params, x, y)
    born = placed.materialize(
        lambda: tmlp.mlp_init(torch.Generator().manual_seed(0),
                              (256, 512, 256), device="cpu"))
    ref = tmlp.mlp_init(torch.Generator().manual_seed(0), (256, 512, 256),
                        device="cpu")
    equal = all(torch.equal(_full(b), r) for b, r in
                zip(pytree.tree_leaves(born), pytree.tree_leaves(ref)))
    local_before = [t.to_local().clone() for t in pytree.tree_leaves(born)]
    new_state, loss_m = donated(born, x, y)
    res["materialize"] = dict(
        equal=equal,
        local_numel=[t.to_local().numel() for t in pytree.tree_leaves(born)],
        full_numel=[r.numel() for r in pytree.tree_leaves(ref)],
        placements=[[repr(p) for p in t.placements]
                    for t in pytree.tree_leaves(born)],
        in_place=all(n is b for n, b in zip(pytree.tree_leaves(new_state),
                                            pytree.tree_leaves(born))),
        changed=any(not torch.equal(t.to_local(), b) for t, b in
                    zip(pytree.tree_leaves(born), local_before)),
        loss=float(loss_m), eager=float(step(ref, x, y)[1]))
    return res


def mesh_2d(rank, world, out, gpt_state=None, steps=3):
    """(2, 2) "dp" x "tp": the MLP step, then the tiny GPT (einsum and
    flash) from the state in `gpt_state` (numpy leaves), 3 steps each."""
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models import gpt as tg
    from easydist_tpu_torch.models import mlp as tmlp

    mesh = make_device_mesh((2, 2), ("dp", "tp"), device_type="cpu")
    res = {}
    step = tmlp.make_mlp_train_step()
    params, x, y = _mlp_data()
    compiled = easydist_compile(step, mesh=mesh, donate_state=False)
    losses, eager, state, eager_state = _train(compiled, step, params,
                                               (x, y), steps)
    res["mlp"] = dict(losses=losses, eager=eager,
                      err=_max_err(state, eager_state),
                      mm_sharded=_any_mm_sharded(
                          compiled.get_compiled(state, x, y)))
    with open(gpt_state, "rb") as f:
        blob = pickle.load(f)
    tok, tgt = (torch.from_numpy(a) for a in blob["tokens"])
    for attention in ("einsum", "flash"):
        cfg = tg.GPTConfig(**blob["cfg"], attention=attention)
        step_t, _ = tg.make_gpt_train_step(cfg)
        state0 = tuple(tg.params_from_numpy(blob["state"], device="cpu"))
        compiled = easydist_compile(step_t, mesh=mesh)
        losses, eager, state, eager_state = _train(compiled, step_t, state0,
                                                   (tok, tgt), steps)
        result = compiled.get_compiled(state, tok, tgt)
        res[attention] = dict(
            losses=losses, eager=eager,
            mm_sharded=_any_mm_sharded(result),
            collectives=len(result.collectives),
            replicated=result.replicated_flops_fraction,
            failed=list(result.replicated_on_failure))
    return res


# ------------------------------------------------- emission, op by op

def _op_cases():
    """name -> (fn, inputs): one aten op per preset target, at shapes
    whose dims divide by 2."""
    aten = torch.ops.aten
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.rand(s, generator=g) + 0.5

    def ids(n, *s):
        return torch.randint(0, n, s, generator=g)

    return {
        "add": (lambda a, b: aten.add.Tensor(a, b), (r(4, 6), r(6))),
        "sub": (lambda a, b: aten.sub.Tensor(a, b), (r(4, 6), r(4, 6))),
        "mul": (lambda a, b: aten.mul.Tensor(a, b), (r(4, 6), r(4, 1))),
        "div": (lambda a, b: aten.div.Tensor(a, b), (r(4, 6), r(4, 6))),
        "rsub": (lambda a: aten.rsub.Scalar(a, 1), (r(4, 6),)),
        "pow": (lambda a: aten.pow.Tensor_Scalar(a, 3), (r(4, 6),)),
        "pow_scalar": (lambda a: aten.pow.Scalar(0.9, a), (r(4, 6),)),
        "neg": (lambda a: aten.neg.default(a), (r(4, 6),)),
        "sqrt": (lambda a: aten.sqrt.default(a), (r(4, 6),)),
        "rsqrt": (lambda a: aten.rsqrt.default(a), (r(4, 6),)),
        "tanh": (lambda a: aten.tanh.default(a), (r(4, 6),)),
        "gelu": (lambda a: aten.gelu.default(a, approximate="tanh"),
                 (r(4, 6),)),
        "gelu_backward": (lambda g_, a: aten.gelu_backward.default(
            g_, a, approximate="tanh"), (r(4, 6), r(4, 6))),
        "where": (lambda c, a, b: aten.where.self(c, a, b),
                  (r(4, 6) > 1.0, r(4, 6), r(4, 6))),
        "le": (lambda a, b: aten.le.Tensor(a, b), (r(4, 6), r(4, 6))),
        "clone": (lambda a: aten.clone.default(a), (r(4, 6),)),
        "detach": (lambda a: aten.detach.default(a), (r(4, 6),)),
        "to_copy": (lambda a: aten._to_copy.default(
            a, dtype=torch.float64), (r(4, 6),)),
        "ones_like": (lambda a: aten.ones_like.default(a), (r(4, 6),)),
        "mm": (lambda a, b: aten.mm.default(a, b), (r(4, 6), r(6, 8))),
        "addmm": (lambda c, a, b: aten.addmm.default(c, a, b),
                  (r(8), r(4, 6), r(6, 8))),
        "bmm": (lambda a, b: aten.bmm.default(a, b),
                (r(2, 4, 6), r(2, 6, 8))),
        "t": (lambda a: aten.t.default(a), (r(4, 6),)),
        "transpose": (lambda a: aten.transpose.int(a, 1, 2),
                      (r(2, 4, 6),)),
        "permute": (lambda a: aten.permute.default(a, [2, 0, 1]),
                    (r(2, 4, 6),)),
        "expand": (lambda a: aten.expand.default(a, [4, 6]), (r(1, 6),)),
        "expand_new_dim": (lambda a: aten.expand.default(a, [2, 4, 6]),
                           (r(4, 6),)),
        "squeeze": (lambda a: aten.squeeze.dim(a, 1), (r(4, 1, 6),)),
        "unsqueeze": (lambda a: aten.unsqueeze.default(a, 1), (r(4, 6),)),
        "view": (lambda a: aten.view.default(a, [2, 2, 6]), (r(4, 6),)),
        "view_merge": (lambda a: aten.view.default(a, [8, 6]),
                       (r(2, 4, 6),)),
        "unsafe_view": (lambda a: aten._unsafe_view.default(a, [4, 2, 4]),
                        (r(4, 8),)),
        "reshape": (lambda a: aten.reshape.default(a, [4, 3, 2]),
                    (r(4, 6),)),
        "sum_dim": (lambda a: aten.sum.dim_IntList(a, [0], True),
                    (r(4, 6),)),
        "sum_all": (lambda a: aten.sum.default(a), (r(4, 6),)),
        "mean_dim": (lambda a: aten.mean.dim(a, [-1], True), (r(4, 6),)),
        "mean_all": (lambda a: aten.mean.default(a), (r(4, 6),)),
        "var": (lambda a: aten.var.correction(a, [-1], correction=0,
                                              keepdim=True), (r(4, 6),)),
        "amax": (lambda a: aten.amax.default(a, [1], False), (r(4, 6),)),
        "split": (lambda a: list(aten.split.Tensor(a, 2, -1)),
                  (r(4, 6),)),
        "cat": (lambda a, b: aten.cat.default([a, b], 1),
                (r(4, 6), r(4, 2))),
        "gather": (lambda a, i: aten.gather.default(a, -1, i),
                   (r(4, 6), ids(6, 4, 2))),
        "scatter_add": (lambda a, i, s: aten.scatter_add.default(
            a, -1, i, s), (r(4, 6), ids(6, 4, 2), r(4, 2))),
        "index": (lambda w, i: aten.index.Tensor(w, [i]),
                  (r(10, 6), ids(10, 4, 2))),
        "index_put": (lambda i, v: aten.index_put.default(
            aten.zeros.default([10, 6]), [i], v, True),
                      (ids(10, 4, 2), r(4, 2, 6))),
        "embedding": (lambda w, i: aten.embedding.default(w, i),
                      (r(10, 6), ids(10, 4, 2))),
        "embedding_backward": (
            lambda g_, i: aten.embedding_dense_backward.default(
                g_, i, 10, -1, False), (r(4, 2, 6), ids(10, 4, 2))),
        "softmax": (lambda a: aten._softmax.default(a, -1, False),
                    (r(4, 6),)),
        "log_softmax": (lambda a: aten._log_softmax.default(a, -1, False),
                        (r(4, 6),)),
        "softmax_backward": (
            lambda g_, o: aten._softmax_backward_data.default(
                g_, o, -1, torch.float32), (r(4, 6), r(4, 6))),
        "log_softmax_backward": (
            lambda g_, o: aten._log_softmax_backward_data.default(
                g_, o, -1, torch.float32), (r(4, 6), r(4, 6))),
        "zeros": (lambda a: aten.add.Tensor(aten.zeros.default([4, 6]), a),
                  (r(4, 6),)),
        "new_zeros": (lambda a: aten.new_zeros.default(a, [2, 6]),
                      (r(4, 6),)),
        "arange": (lambda a: aten.mul.Tensor(
            aten.arange.start(0, 6, dtype=torch.float32), a), (r(4, 6),)),
        "flash": (lambda q, k, v: list(torch.ops.easydist_tpu_torch.flash_fwd(
            q, k, v, True, 0.5)), (r(2, 2, 8, 4), r(2, 2, 8, 4),
                                   r(2, 2, 8, 4))),
    }


def op_cases_names():
    return list(_op_cases())


def emit_ops(rank, world, out):
    """Each case's op, emitted under every strategy of its pool on a
    (world,) mesh, against the op run whole: {case: [(strategy, max abs
    error or None when exact, exact-or-close flag)]}."""
    import easydist_tpu_torch.ops.flash_attention  # noqa: F401
    from torch.fx.experimental.proxy_tensor import make_fx

    from easydist_tpu_torch.fxfront.bridge import fx_to_metagraph
    from easydist_tpu_torch.fxfront.emit import emit_sharded_fn
    from easydist_tpu_torch.fxfront.interpreter import (
        ShardingAnalyzer, _inject_partial_propagation)
    from easydist_tpu_torch.fxfront.mesh import make_device_mesh
    from easydist_tpu_torch.metashard.metair import NodeStrategy, Placement

    mesh = make_device_mesh((world,), ("x",), device_type="cpu")
    info = {"names": ["x"], "sizes": [world],
            "coords": list(mesh.get_coordinate()),
            "groups": [mesh.get_group(0).group_name]}
    res = {}
    for name, (fn, inputs) in _op_cases().items():
        with torch.no_grad():
            gm = make_fx(fn, tracing_mode="fake")(*inputs)
            want = pytree.tree_leaves(fn(*inputs))
        rules, shapes = ShardingAnalyzer(gm, world).run()
        graph = fx_to_metagraph(gm, rules, shapes, world)
        _inject_partial_propagation(graph, world)
        ops = [n for n in graph.ops if n.op_key not in ("aten.zeros",
                                                         "aten.arange")]
        op = ops[-1]
        placeholders = [n.name for n in graph.inputs]
        rows = []
        for s in op.strategy_pool(world):
            chosen = {op.name: s}
            for v, p in zip(op.invars, s.in_placements):
                if v.name in placeholders:
                    chosen[v.name] = NodeStrategy(
                        [], [p if p.is_shard() else Placement.replicate()])
            local_gm, colls = emit_sharded_fn(gm, [chosen], info, {})
            local = [x.narrow(p.dim, info["coords"][0]
                              * (x.shape[p.dim] // world),
                              x.shape[p.dim] // world).contiguous()
                     if (p := chosen.get(ph, NodeStrategy([], [
                         Placement.replicate()])).out_placements[0]
                         ).is_shard() else x
                     for ph, x in zip(placeholders, inputs)]
            with torch.no_grad():
                got = pytree.tree_leaves(local_gm(*local))
            err = 0.0
            for gv, wv in zip(got, want):
                if gv.shape != wv.shape:
                    err = float("inf")
                elif wv.is_floating_point():
                    err = max(err, float(((gv - wv).abs()
                                          / (1e-6 + 1e-5 * wv.abs())).max()))
                elif not torch.equal(gv, wv):
                    err = float("inf")
            rows.append((repr(s), err, [c.kind for c in colls]))
        res[name] = rows
    return res


# ------------------------------------------------- attention across ranks

def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def long_context(rank, world, out, qkv=None):
    """`ring_attention` (einsum and flash blocks, the flash kernels'
    plain versions on the CPU) and `ulysses_attention` on a (world,) "sp"
    mesh from the numpy q, k, v in `qkv`: per (program, causal), the
    output and the gradients of mean(out ** 2) as numpy arrays, and the
    ring's permute count; under "emit", `emit_seq`'s results."""
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.parallel import ring_attention, ulysses_attention
    from easydist_tpu_torch.parallel.ring_attention import ring_hop

    mesh = make_device_mesh((world,), ("sp",), device_type="cpu")
    arrays = _load(qkv)
    programs = {
        "ring": lambda c: lambda q, k, v: ring_attention(
            q, k, v, mesh, "sp", causal=c, block_impl="einsum"),
        "flash": lambda c: lambda q, k, v: ring_attention(
            q, k, v, mesh, "sp", causal=c, block_impl="flash"),
        "ulysses": lambda c: lambda q, k, v: ulysses_attention(
            q, k, v, mesh, "sp", causal=c)}
    res = {}
    for name, make in programs.items():
        for causal in (False, True):
            q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
            ring_hop.permutes = 0
            o = make(causal)(q, k, v)
            grads = torch.autograd.grad((o ** 2).mean(), (q, k, v))
            res[(name, causal)] = dict(
                out=o.detach().numpy(), grads=[g.numpy() for g in grads],
                hops=ring_hop.permutes)
    res["emit"] = emit_seq(rank, world, out, mesh=mesh)
    return res


def attention_pick(strategy) -> str:
    """"R", "S(d)" or "S(d):variant" of an attention node's strategy."""
    if strategy.is_all_replicate():
        return "R"
    meta = getattr(strategy, "meta", None) or {}
    pick = f"S({strategy.out_placements[0].dim})"
    return f"{pick}:{meta['variant']}" if meta.get("variant") else pick


def emitted_and_priced(result):
    """Per axis: ({kind: [count, wire bytes]} emitted, the same priced),
    both by the solver's formulas on the solver's sizes."""
    from easydist_tpu_torch.autoflow.cost_model import collective_wire_bytes

    table = {}
    for a, spec in enumerate(result.axis_specs):
        if spec.size == 1:
            continue
        emitted, priced = {}, {}
        for c in result.collectives:
            if c.axis == spec.name:
                row = emitted.setdefault(c.kind, [0, 0.0])
                row[0] += 1
                row[1] += collective_wire_bytes(c.kind, c.priced_bytes,
                                                spec.size)
        for kind, _, nbytes in result.priced[a]:
            row = priced.setdefault(kind, [0, 0.0])
            row[0] += 1
            row[1] += collective_wire_bytes(kind, nbytes, spec.size)
        table[spec.name] = (emitted, priced)
    return table


def gpt_auto(rank, world, out, gpt_state=None, shape=None, names=None,
             steps=3):
    """The tiny GPT with attention="auto" from the state in `gpt_state`,
    compiled for `shape` / `names`: losses (compiled and eager), the
    attention nodes' picks per axis, emitted and priced collectives, and
    the ring's permutes over the compiled steps."""
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models import gpt as tg
    from easydist_tpu_torch.parallel.ring_attention import ring_hop

    mesh = make_device_mesh(tuple(shape), tuple(names), device_type="cpu")
    blob = _load(gpt_state)
    tok, tgt = (torch.from_numpy(a) for a in blob["tokens"])
    cfg = tg.GPTConfig(**blob["cfg"], attention="auto")
    step, _ = tg.make_gpt_train_step(cfg)
    state0 = tuple(tg.params_from_numpy(blob["state"], device="cpu"))
    compiled = easydist_compile(step, mesh=mesh, donate_state=False)
    result = compiled.get_compiled(state0, tok, tgt)
    ring_hop.permutes = ring_hop.bytes = 0
    losses, eager, state, eager_state = _train(compiled, step, state0,
                                               (tok, tgt), steps)
    hops, hop_bytes = ring_hop.permutes, ring_hop.bytes
    picks = [sorted((n.split("_")[2], attention_pick(s))
                    for n, s in chosen.items() if "ed_attention" in n)
             for chosen in result.strategies]
    return dict(losses=losses, eager=eager, picks=picks,
                err=_max_err(state, eager_state),
                table=emitted_and_priced(result), hops=hops,
                hop_bytes=hop_bytes)


# ------------------------------------------------------- the user surface

def pins(rank, world, out):
    """`fix_sharding` on a (world,) "d" mesh (the JAX package's
    test_fix_sharding_scope) and, at world 4, on a (2, 2) "dp" x "tp"
    mesh; `scoped_region` at world 4: a (4,) region inside a step
    compiled on the (2, 2) mesh (test_scoped_region_multi_mesh)."""
    from easydist_tpu_torch.fxfront import (easydist_compile, fix_sharding,
                                            make_device_mesh, scoped_region)

    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 32, generator=g)
    x = torch.randn(8, 16, generator=g)
    res = {}
    meshes = [((world,), ("d",), "d")]
    if world == 4:
        meshes.append(((2, 2), ("dp", "tp"), "tp"))
    for shape, names, axis in meshes:
        mesh = make_device_mesh(shape, names, device_type="cpu")

        def fwd(w, x, axis=axis):
            w = fix_sharding(w, None, axis)  # column sharding
            return torch.tanh(x @ w)

        compiled = easydist_compile(fwd, mesh=mesh)
        got = compiled(w, x)
        result = compiled.get_compiled(w, x)
        pin = [[repr(s.out_placements[0]) for n, s in chosen.items()
                if n.startswith("fix_sharding")]
               for chosen in result.strategies]
        mm = [[repr(s.out_placements[0]) for n, s in chosen.items()
               if n.startswith("mm")] for chosen in result.strategies]
        res[shape] = dict(
            err=float((got - torch.tanh(x @ w)).abs().max()), pin=pin,
            mm=mm, collectives=[(c.axis, c.kind, c.var)
                                for c in result.collectives],
            table=emitted_and_priced(result),
            plain=float((fwd(w, x) - torch.tanh(x @ w)).abs().max()))
    if world == 4:
        from torch.distributed.device_mesh import init_device_mesh

        outer = make_device_mesh((2, 2), ("dp", "tp"), device_type="cpu")
        inner = init_device_mesh("cpu", (4,), mesh_dim_names=("d",))
        g = torch.Generator().manual_seed(0)
        w1 = torch.randn(256, 512, generator=g) / 16
        w2 = torch.randn(512, 256, generator=g) / 22
        xs = torch.randn(2048, 256, generator=g)

        def inner_fn(h, w2):
            return torch.tanh(h) @ w2

        scoped = scoped_region(inner_fn, inner)

        def step(w1, w2, x):
            return scoped(x @ w1, w2).sum()

        compiled = easydist_compile(step, mesh=outer, donate_state=False)
        got = compiled(w1, w2, xs)
        region = compiled.get_compiled(w1, w2, xs)
        want = step(w1, w2, xs)
        ref = (torch.tanh(xs @ w1) @ w2).sum()
        res["scoped"] = dict(
            got=float(got), want=float(want), ref=float(ref),
            nodes=[str(n.target) for n in region.traced.graph.nodes
                   if "scoped" in str(n.target)])
    return res


class SmallMLP(torch.nn.Module):
    """The JAX package's torchfront test MLP (tests/test_torchfront/
    test_convert.py:23)."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(16, 32)
        self.ln = torch.nn.LayerNorm(32)
        self.fc2 = torch.nn.Linear(32, 8)

    def forward(self, x):
        return self.fc2(torch.relu(self.ln(self.fc1(x))))


class TinyTransformer(torch.nn.Module):
    """A pre-norm transformer block over [b, t, 32] (causal SDPA, 4 heads,
    a GELU MLP) with a linear head: the JAX package's convert handles
    each of its ops (test_convert.py:34)."""

    def __init__(self, dim=32, heads=4):
        super().__init__()
        self.ln1 = torch.nn.LayerNorm(dim)
        self.qkv = torch.nn.Linear(dim, 3 * dim)
        self.proj = torch.nn.Linear(dim, dim)
        self.ln2 = torch.nn.LayerNorm(dim)
        self.fc = torch.nn.Linear(dim, 4 * dim)
        self.out = torch.nn.Linear(4 * dim, dim)
        self.head = torch.nn.Linear(dim, 8)
        self.heads = heads

    def forward(self, x):
        b, t, d = x.shape
        qkv = self.qkv(self.ln1(x)).reshape(b, t, 3, self.heads,
                                            d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
        x = x + self.proj(a.transpose(1, 2).reshape(b, t, d))
        x = x + self.out(torch.nn.functional.gelu(self.fc(self.ln2(x))))
        return self.head(x)


TORCH_MODULES = {"mlp": (SmallMLP, (64, 16), (64, 8)),
                 "transformer": (TinyTransformer, (8, 16, 32), (8, 16, 8))}


def torch_module_inputs(name, seed: int = 1):
    """(module, x, y) of `TORCH_MODULES[name]`, weights from torch seed
    `seed`, data from a numpy seed."""
    cls, x_shape, y_shape = TORCH_MODULES[name]
    torch.manual_seed(seed)
    module = cls()
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*x_shape).astype(np.float32))
    y = torch.from_numpy(rs.randn(*y_shape).astype(np.float32))
    return module, x, y


def _mse(pred, target):
    return ((pred - target) ** 2).mean()


def torch_modules(rank, world, out, shape=None, names=None, steps=3):
    """`make_torch_train_step` (Adam, lr 1e-2) on each module of
    `TORCH_MODULES` over a `shape` / `names` mesh: compiled and eager
    torch losses, and the worst parameter error against eager torch."""
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.torchfront import make_torch_train_step

    mesh = make_device_mesh(tuple(shape), tuple(names), device_type="cpu")
    res = {}
    for name in TORCH_MODULES:
        module, x, y = torch_module_inputs(name)
        step, init_state = make_torch_train_step(
            module, (x,), _mse, optimizer="adam", lr=1e-2, mesh=mesh,
            donate_state=False)
        state = init_state()
        losses = []
        for _ in range(steps):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        opt = torch.optim.Adam(module.parameters(), lr=1e-2)
        eager = []
        for _ in range(steps):
            opt.zero_grad()
            loss = _mse(module(x), y)
            loss.backward()
            opt.step()
            eager.append(float(loss))
        res[name] = dict(losses=losses, eager=eager, err=_max_err(
            [state[0][k] for k, _ in module.named_parameters()],
            [p.detach() for _, p in module.named_parameters()]))
    return res


def emit_seq(rank, world, out, mesh=None):
    """The attention composite's forward and backward ops, each emitted on
    a (world,) mesh with every input seq-sharded and the node on its seq
    strategy, once per variant (the solver picks Ulysses only on axes of
    8 or more at the JAX package's constants, so the variant is set here
    as the strategy's meta): {(variant, op): (max abs error against the
    op run whole, [collective kinds recorded])}."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from easydist_tpu_torch.fxfront.emit import emit_sharded_fn
    from easydist_tpu_torch.fxfront.mesh import make_device_mesh
    from easydist_tpu_torch.metashard.metair import NodeStrategy, Placement

    if mesh is None:
        mesh = make_device_mesh((world,), ("sp",), device_type="cpu")
    info = {"names": ["sp"], "sizes": [world],
            "coords": list(mesh.get_coordinate()),
            "groups": [mesh.get_group(0).group_name]}
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 4, 16, 8, generator=g) for _ in range(4))
    ops = torch.ops.easydist_tpu_torch
    cases = {"fwd": (lambda q, k, v: ops.ed_attention_fwd(q, k, v, True,
                                                           0.25),
                     (q, k, v)),
             "bwd": (lambda q, k, v, do: list(ops.ed_attention_bwd(
                 q, k, v, do, True, 0.25)), (q, k, v, do))}
    s2 = Placement.shard(2)
    res = {}
    for variant in ("ring", "ulysses"):
        for name, (fn, inputs) in cases.items():
            with torch.no_grad():
                gm = make_fx(fn, tracing_mode="fake")(*inputs)
                want = pytree.tree_leaves(fn(*inputs))
            node = next(n for n in gm.graph.nodes if "ed_attention" in
                        str(n.target))
            n_out = 3 if name == "bwd" else 1
            strategy = NodeStrategy([s2] * len(inputs), [s2] * n_out)
            strategy.meta = {"variant": variant}
            chosen = {node.name: strategy}
            for ph in gm.graph.nodes:
                if ph.op == "placeholder":
                    chosen[ph.name] = NodeStrategy([], [s2])
            local_gm, colls = emit_sharded_fn(gm, [chosen], info, {})
            size = 16 // world
            local = [x.narrow(2, info["coords"][0] * size, size).contiguous()
                     for x in inputs]
            with torch.no_grad():
                got = pytree.tree_leaves(local_gm(*local))
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            res[(variant, name)] = (err, [c.kind for c in colls])
    return res
