"""The per-rank programs that the comm / runtime tests spawn on gloo
(`tests/test_torch_{comm_quant,overlap,checkpoint,calibrate}.py`), through
`tests.test_torch_fxfront_ranks.spawn("tests.test_torch_comm_ranks:
<scenario>", ...)`.

Holds no tests of its own and imports torch, numpy and the port only, so
a spawned process never loads JAX.  Inputs arrive as numpy arrays made
from seeds by the test; every result goes back as numpy.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from tests.test_torch_parallel_ranks import _mesh, from_numpy, to_numpy

_COLLECTIVES = ("all_reduce", "reduce_scatter_tensor",
                "all_gather_into_tensor", "all_to_all_single")


def mse_mlp(params, x, y):
    from easydist_tpu_torch.models.mlp import mlp_apply

    return torch.mean((mlp_apply(params, x) - y) ** 2)


def _set(**knobs):
    from easydist_tpu_torch import config as edconfig

    for k, v in knobs.items():
        setattr(edconfig, k, v)


def _exact():
    _set(comm_quant_dtype="none", comm_bucket_bytes=0, comm_overlap=False,
         grad_accum_microbatches=0, comm_quant_min_numel=2048)


class WireLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Bytes each functional collective sends from this rank, from the
    tensors it is given at run time: an all_reduce 2 (n-1)/n of its input,
    a reduce_scatter (n-1)/n of its input, an all_gather (n-1)/n of its
    output, an equal-split all_to_all (n-1)/n of its input."""

    def __init__(self, n: int):
        super().__init__()
        self.n, self.bytes, self.calls = n, 0.0, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        kind = next((k for k in _COLLECTIVES if name.startswith(k + ".")),
                    None)
        if kind is not None:
            n = self.n
            nb = args[0].numel() * args[0].element_size()
            factor = {"all_reduce": 2.0 * (n - 1) / n}.get(kind,
                                                          (n - 1) / n)
            if kind == "all_gather_into_tensor":
                nb *= n
            self.bytes += factor * nb
            self.calls[kind] = self.calls.get(kind, 0) + 1
        return out


# ------------------------------------------------ quantized collectives

def quant_cases(rank, world, out, vec, vec_bf16, scat, vec5):
    """quantized_psum / pmean (bf16 input) / psum_scatter / bf16_psum of
    each rank's row, with the exact sums beside them."""
    from easydist_tpu_torch import comm

    mesh = _mesh((world,), ("dp",))
    g = mesh.get_group("dp")
    v = torch.from_numpy(vec[rank])
    vb = torch.from_numpy(vec_bf16[rank]).to(torch.bfloat16)
    sc = torch.from_numpy(scat[rank])
    v5 = torch.from_numpy(vec5[rank])
    res = {
        "psum": comm.quantized_psum(v, g, world),
        "psum_exact": comm.all_reduce_sum(v, g),
        "pmean_bf16": comm.quantized_psum(vb, g, world, mean=True),
        "pmean_bf16_exact": comm.all_reduce_sum(vb.float(), g) / world,
        "scatter": comm.quantized_psum_scatter(sc, g, world, mean=True),
        "scatter_exact": comm.reduce_scatter_sum(sc, g, world) / world,
        "bf16": comm.bf16_psum(v5, g),
        "bf16_exact": comm.all_reduce_sum(v5, g),
        "psum_again": comm.quantized_psum(v, g, world),
    }
    res["dtype_bf16"] = str(res["pmean_bf16"].dtype)
    res["pmean_bf16"] = res["pmean_bf16"].float()
    log = WireLog(world)
    comm.comm_counters.reset()
    _set(comm_quant_dtype="int8")
    with log:
        comm.fence_psum(v, g, world)
    res["fence_wire"] = (log.bytes, comm.comm_counters.snapshot())
    _exact()
    return to_numpy(res)


def _dp_run(world, mode, params, x, y, steps):
    """(losses, final rank state, comm counters) of `steps` steps of one
    mode: ddp SGD lr 0.05, zero2 / zero3 Adam lr 1e-2."""
    from easydist_tpu_torch import comm

    comm.comm_counters.reset()
    losses, state = (_ddp(world, params, x, y, steps) if mode == "ddp"
                     else _zero(world, mode, params, x, y, steps))
    return losses, state, comm.comm_counters.snapshot()


def comm_cases(rank, world, out, quant, data, steps=3):
    """`quant_cases` on `quant`, then ddp / zero2 / zero3 under int8 and
    bf16 (256 KiB buckets, min numel 512) and exact, on each mode's own
    numpy `data`: {mode: (losses, state, counters)} per setting."""
    res = {"quant": quant_cases(rank, world, out, **quant)}
    for setting, knobs in (("int8", dict(comm_quant_dtype="int8",
                                         comm_bucket_bytes=256 << 10,
                                         comm_quant_min_numel=512)),
                           ("bf16", dict(comm_quant_dtype="bf16",
                                         comm_bucket_bytes=256 << 10,
                                         comm_quant_min_numel=512)),
                           ("exact", {})):
        _exact()
        _set(**knobs)
        res[setting] = {m: _dp_run(world, m, *data[m], steps)
                        for m in ("ddp", "zero2", "zero3")}
    _exact()
    return res


# ---------------------------------------------------------------- overlap

def _ddp(world, params, x, y, steps=3, **kw):
    from easydist_tpu_torch.parallel import ddp_step

    mesh = _mesh((world,), ("dp",))
    step = ddp_step(mse_mlp, mesh, lr=0.05, **kw)
    p, losses = from_numpy(params), []
    for _ in range(steps):
        p, loss = step(p, from_numpy(x), from_numpy(y))
        losses.append(float(loss))
    return losses, to_numpy(p)


def _zero(world, mode, params, x, y, steps=3, **kw):
    from easydist_tpu_torch.parallel import zero2_step, zero3_step

    mesh = _mesh((world,), ("dp",))
    maker = zero2_step if mode == "zero2" else zero3_step
    st, init = maker(mse_mlp, mesh, lr=1e-2, **kw)
    q = from_numpy(params)
    state = ((q, init(q), torch.zeros((), dtype=torch.int32))
             if mode == "zero2" else init(q))
    losses = []
    for _ in range(steps):
        state, loss = st(state, from_numpy(x), from_numpy(y))
        losses.append(float(loss))
    return losses, to_numpy(state)


def _traced_order(world, params, x, y):
    """In the make_fx graph of the overlapped ddp step (8 KiB buckets, so
    the plan has several): the index of the first collective and of the
    last matmul (the first layer's weight gradient, the backward's last
    product)."""
    from easydist_tpu_torch.parallel import ddp_step
    from torch.fx.experimental.proxy_tensor import make_fx

    mesh = _mesh((world,), ("dp",))
    step = ddp_step(mse_mlp, mesh, lr=0.05)
    p = from_numpy(params)
    leaves, spec = pytree.tree_flatten(p)

    def flat(*xs):
        return pytree.tree_leaves(step(pytree.tree_unflatten(
            list(xs[:len(leaves)]), spec), *xs[len(leaves):]))

    gm = make_fx(flat)(*leaves, from_numpy(x), from_numpy(y))
    names = [getattr(n.target, "__name__", "") for n in gm.graph.nodes
             if n.op == "call_function"]
    first = next(i for i, nm in enumerate(names)
                 if nm.startswith("all_reduce."))
    last_mm = max(i for i, nm in enumerate(names)
                  if nm.startswith(("mm.", "addmm.")))
    return first, last_mm


def overlap_cases(rank, world, out, params, x, y, int8_data):
    """The overlapped flushes against the sequential ones (quantization
    off, so bitwise at world 2), the traced step's order, and the int8
    overlapped losses with the exact sequential ones."""
    res = {}
    for bucket in (0, 256 << 10):
        _exact()
        _set(comm_bucket_bytes=bucket)
        seq = _ddp(world, params, x, y)
        _set(comm_overlap=True)
        ovl = _ddp(world, params, x, y)
        res[f"ddp_{bucket}"] = (seq, ovl)
    _exact()
    _set(comm_bucket_bytes=256 << 10)
    seq = _ddp(world, params, x, y, grad_accum_microbatches=4)
    _set(comm_overlap=True)
    ovl = _ddp(world, params, x, y, grad_accum_microbatches=4)
    res["ddp_accum4"] = (seq, ovl)
    for mode in ("zero2", "zero3"):
        for accum in (0, 4):
            _exact()
            _set(comm_bucket_bytes=256 << 10)
            seq = _zero(world, mode, params, x, y,
                        grad_accum_microbatches=accum)
            _set(comm_overlap=True)
            ovl = _zero(world, mode, params, x, y,
                        grad_accum_microbatches=accum)
            res[f"{mode}_accum{accum}"] = (seq, ovl)
    _exact()
    _set(comm_overlap=True, comm_bucket_bytes=8 << 10)
    res["traced"] = _traced_order(world, params, x, y)
    for mode in ("ddp", "zero2", "zero3"):
        p, xx, yy = int8_data[mode]
        _exact()
        exact = (_ddp(world, p, xx, yy) if mode == "ddp"
                 else _zero(world, mode, p, xx, yy))[0]
        _set(comm_quant_dtype="int8", comm_bucket_bytes=256 << 10,
             comm_quant_min_numel=512, comm_overlap=True)
        q = (_ddp(world, p, xx, yy) if mode == "ddp"
             else _zero(world, mode, p, xx, yy))[0]
        res[f"int8_{mode}"] = (q, exact)
    _exact()
    return res


# ------------------------------------------------------- auto path (fault)

def auto_int8(rank, world, out, params, x, y, steps=3):
    """`easydist_compile(mesh=)` of an SGD step under int8 (min numel 512):
    the bytes the emitted program's collectives send at run time, the
    emitted and priced wire bytes, the comm counters, and the compiled
    and eager losses."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.optim import value_and_grad

    _exact()
    _set(comm_quant_dtype="int8", comm_quant_min_numel=512)

    def step(p, xb, yb):
        loss, grads = value_and_grad(mse_mlp, p, xb, yb)
        return pytree.tree_map(lambda w, g: w - 0.05 * g, p, grads), loss

    mesh = _mesh((world,), ("dp",))
    p0, xs, ys = from_numpy(params), from_numpy(x), from_numpy(y)
    comm.comm_counters.reset()
    compiled = easydist_compile(step, mesh=mesh, donate_state=False)
    result = compiled.get_compiled(p0, xs, ys)
    counters = comm.comm_counters.snapshot()
    p_c = pytree.tree_map(torch.clone, p0)
    p_e = pytree.tree_map(torch.clone, p0)
    losses_c, losses_e, runtime = [], [], []
    for _ in range(steps):
        log = WireLog(world)
        with log:
            p_c, l_c = compiled(p_c, xs, ys)
        runtime.append(log.bytes)
        p_e, l_e = step(p_e, xs, ys)
        losses_c.append(float(l_c))
        losses_e.append(float(l_e))
    # (getattr: the tree before the fence's repair lacks these fields, and
    # its run-time bytes are what the test must catch there)
    emitted = [(c.axis, c.kind, c.var, getattr(c, "wire_bytes", None),
                getattr(c, "route", None)) for c in result.collectives]
    _exact()
    return {"losses_c": losses_c, "losses_e": losses_e,
            "runtime_wire": runtime, "emitted": emitted,
            "priced": [list(p) for p in result.priced],
            "priced_wire": [list(p) for p in getattr(result, "priced_wire",
                                                     [])],
            "axes": [s.name for s in result.axis_specs],
            "counters": counters}


# ------------------------------------------------------- calibration

def calibrate_cases(rank, world, out):
    """`calibrate(group)` and `calibrate_overlap(group)` at small sizes,
    then `apply_calibration` reading them back from the PerfDB."""
    import importlib

    from easydist_tpu_torch import config as edconfig

    cal = importlib.import_module("easydist_tpu_torch.runtime.calibrate")
    mesh = _mesh((world,), ("dp",))
    g = mesh.get_group("dp")
    res = {"calibrate": cal.calibrate(g, big_elems=1 << 18,
                                      hbm_elems=1 << 20)}
    res["overlap"] = cal.calibrate_overlap(g, n_elems=1 << 16)
    edconfig.comm_overlap_ratio_measured = None
    edconfig.nvlink_latency = -1.0
    cal._applied = None
    res["applied"] = cal.apply_calibration()
    res["after"] = (edconfig.nvlink_latency,
                    edconfig.comm_overlap_ratio_measured)
    return res


# ------------------------------------------------ guard and checkpoints

def _guard_mode(world, mode, params, x, y):
    """One clean step, then one whose batch holds NaN rows in the last
    rank's block only, under the guarded `mode` step: (state after the
    clean step, state after the poisoned one, guard state, losses)."""
    from easydist_tpu_torch.parallel import ddp_step, zero2_step, zero3_step
    from easydist_tpu_torch.resilience import init_guard_state

    mesh = _mesh((world,), ("dp",))
    q = from_numpy(params)
    if mode == "ddp":
        step, state = ddp_step(mse_mlp, mesh, lr=0.05, step_guard=True), q
    elif mode == "zero2":
        step, init = zero2_step(mse_mlp, mesh, lr=1e-2, step_guard=True)
        state = (q, init(q), torch.zeros((), dtype=torch.int32))
    else:
        step, init = zero3_step(mse_mlp, mesh, lr=1e-2, step_guard=True)
        state = init(q)
    carry = (state, init_guard_state())
    xs, ys = from_numpy(x), from_numpy(y)
    carry, l1 = step(carry, xs, ys)
    clean = to_numpy(carry[0])
    bad = xs.clone()
    bad[-1] = float("nan")
    carry, l2 = step(carry, bad, ys)
    return clean, to_numpy(carry[0]), to_numpy(carry[1]), [float(l1),
                                                           float(l2)]


def runtime_cases(rank, world, out, params, x, y, steps=2):
    """The guarded dp / ZeRO steps over the group, then zero2's state
    (moments [1, d0/n] on every rank) saved through one commit, restored
    bitwise, and a checkpoint saved on another world without a stated
    layout refused."""
    import os

    from easydist_tpu_torch.parallel import zero2_step
    from easydist_tpu_torch.runtime import checkpoint as ck

    _exact()
    guard = {m: _guard_mode(world, m, params, x, y)
             for m in ("ddp", "zero2", "zero3")}
    mesh = _mesh((world,), ("dp",))
    st, init = zero2_step(mse_mlp, mesh, lr=1e-2)
    q = from_numpy(params)
    state = (q, init(q), torch.zeros((), dtype=torch.int32))
    for _ in range(steps):
        state, _ = st(state, from_numpy(x), from_numpy(y))
    root = os.path.join(out, "ckpt")
    ck.save_checkpoint(root, state, step=steps, meta={"batches_consumed": 2})
    like = pytree.tree_map(torch.zeros_like, state)
    back, step, meta = ck.load_checkpoint(root, like, with_meta=True)
    same = all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(back),
                                                 pytree.tree_leaves(state)))
    files = sorted(os.listdir(os.path.join(root, f"step_{steps}",
                                           ck.ARRAYS_SUBDIR)))
    refused = None
    bad = os.path.join(out, "ckpt_bad")
    ck.save_checkpoint(bad, state, step=1)
    if rank == 0:
        import json

        man = os.path.join(bad, "step_1", ck.MANIFEST_NAME)
        with open(man) as f:
            m = json.load(f)
        m["meta"]["mesh"]["n_devices"] = world * 2
        with open(man, "w") as f:
            json.dump(m, f)
    torch.distributed.barrier()
    try:
        ck.load_checkpoint(bad, like, verify=False)
    except ValueError as e:
        refused = str(e)
    return {"same": same, "step": step, "meta": meta, "files": files,
            "refused": refused, "latest": ck.latest_step(root),
            "guard": guard}
