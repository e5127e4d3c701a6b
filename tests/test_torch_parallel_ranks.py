"""The per-rank programs that the manual-parallel-mode tests spawn on gloo
(`tests/test_torch_{dp,pipeline,pp_compile,moe}.py`, and
`tests/test_torch_{pp_tp,gpt_remat,partial_regions,serve_mesh}.py`), through
`tests.test_torch_fxfront_ranks.spawn("tests.test_torch_parallel_ranks:
<scenario>", ...)`.

Holds no tests of its own and imports torch, numpy and the port only, so
a spawned process never loads JAX.  Weights and batches arrive as numpy
arrays (made from seeds by the test, which runs the JAX package on the
same arrays); every result goes back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

CPU = "cpu"


def to_numpy(tree):
    return pytree.tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else x, tree)


def from_numpy(tree):
    return pytree.tree_map(
        lambda x: torch.from_numpy(np.array(x))
        if isinstance(x, np.ndarray) else x, tree)


def _mesh(shape, names):
    from easydist_tpu_torch.fxfront import make_device_mesh

    return make_device_mesh(tuple(shape), tuple(names), device_type=CPU)


def collective_counts(fn, *args):
    """{kind: (count, bytes)} of the functional collectives in the
    `make_fx` graph of fn(*args) (bytes of each collective's input)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat, spec = pytree.tree_flatten(args)

    def flat_fn(*xs):
        return pytree.tree_leaves(fn(*pytree.tree_unflatten(list(xs),
                                                            spec)))

    gm = make_fx(flat_fn, tracing_mode="fake")(*flat)
    out = {}
    for n in gm.graph.nodes:
        name = getattr(n.target, "__name__", "")
        for kind in ("all_reduce", "reduce_scatter_tensor",
                     "all_gather_into_tensor", "all_to_all_single"):
            if n.op == "call_function" and name.startswith(kind + "."):
                x = n.args[0].meta["val"]
                c, b = out.get(kind, (0, 0))
                out[kind] = (c + 1, b + x.numel() * x.element_size())
    return out


# ------------------------------------------------------------- dp / ZeRO

def mse_mlp(params, x, y):
    from easydist_tpu_torch.models.mlp import mlp_apply

    return torch.mean((mlp_apply(params, x) - y) ** 2)


def dp_modes(rank, world, out, params, x, y, steps):
    """ddp (SGD lr 0.1), zero2 and zero3 (Adam lr 1e-3), each also with
    K=2 accumulation: {mode: (losses, final rank state as numpy)}, the
    collectives of each step's graph, and the comm counters' bytes."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch.parallel import ddp_step, zero2_step, zero3_step

    mesh = _mesh((world,), ("dp",))
    p0, xs, ys = from_numpy(params), from_numpy(x), from_numpy(y)
    res = {}
    for k in (None, 2):
        tag = "" if k is None else f"_k{k}"
        step = ddp_step(mse_mlp, mesh, lr=0.1, grad_accum_microbatches=k)
        p, losses = pytree.tree_map(torch.clone, p0), []
        comm.comm_counters.reset()
        for _ in range(steps):
            p, loss = step(p, xs, ys)
            losses.append(float(loss))
        res["ddp" + tag] = (losses, to_numpy(p))
        res["counters_ddp" + tag] = comm.comm_counters.snapshot()
        if k is None:
            res["graph_ddp"] = collective_counts(step, p, xs, ys)

        step2, init_opt = zero2_step(mse_mlp, mesh, lr=1e-3,
                                     grad_accum_microbatches=k)
        p = pytree.tree_map(torch.clone, p0)
        state = (p, init_opt(p), torch.zeros((), dtype=torch.int32))
        losses = []
        comm.comm_counters.reset()
        for _ in range(steps):
            state, loss = step2(state, xs, ys)
            losses.append(float(loss))
        res["zero2" + tag] = (losses, to_numpy(state))
        res["counters_zero2" + tag] = comm.comm_counters.snapshot()
        if k is None:
            res["graph_zero2"] = collective_counts(step2, state, xs, ys)

        step3, init3 = zero3_step(mse_mlp, mesh, lr=1e-3,
                                  grad_accum_microbatches=k)
        state = init3(pytree.tree_map(torch.clone, p0))
        losses = []
        for _ in range(steps):
            state, loss = step3(state, xs, ys)
            losses.append(float(loss))
        res["zero3" + tag] = (losses, to_numpy(state))
        if k is None:
            res["graph_zero3"] = collective_counts(step3, state, xs, ys)
    res["torchfront"] = torchfront_modes(mesh, params, x, y, steps)
    return res


def mlp_module(params):
    """An nn.Sequential MLP holding the numpy MLP `params`."""
    layers = []
    for i, layer in enumerate(params):
        lin = torch.nn.Linear(*layer["w"].shape)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(np.array(layer["w"])).T)
            lin.bias.copy_(torch.from_numpy(np.array(layer["b"])))
        layers.append(lin)
        if i < len(params) - 1:
            layers.append(torch.nn.Tanh())
    return torch.nn.Sequential(*layers)


def torchfront_modes(mesh, params, x, y, steps):
    """`make_torch_train_step(parallel_mode=...)` on the MLP module:
    eval export (ddp SGD lr 0.1, zero2 / zero3 Adam lr 1e-3) and
    train=True with Adam lr 1e-3 under each mode: {mode: losses}."""
    from easydist_tpu_torch.torchfront import make_torch_train_step

    xs, ys = from_numpy(x), from_numpy(y)
    res = {}
    for mode, opt, lr in (("ddp", "sgd", 0.1), ("zero2", "adam", 1e-3),
                          ("zero3", "adam", 1e-3)):
        step, init = make_torch_train_step(
            mlp_module(params), (xs,), mse, optimizer=opt, lr=lr, mesh=mesh,
            parallel_mode=mode)
        state, losses = init(), []
        for _ in range(steps):
            state, loss = step(state, xs, ys)
            losses.append(float(loss))
        res[mode] = losses
        step, init = make_torch_train_step(
            mlp_module(params), (xs,), mse, optimizer="adam", lr=1e-3,
            mesh=mesh, parallel_mode=mode, train=True)
        state, losses = init(), []
        rng = torch.Generator().manual_seed(0)
        for _ in range(steps):
            state, loss = step(state, rng, xs, ys)
            losses.append(float(loss))
        res[mode + "_train"] = losses
    return res


# -------------------------------------------------------------- pipeline

def tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def mse(out, tgt):
    return torch.mean((out - tgt) ** 2)


def _tp_stage(group, n):
    """Column-parallel stage: w cut on dim 1 over tp, the product's
    columns all_gathered, the bias whole."""
    from easydist_tpu_torch import comm

    def stage(p, x):
        h = x @ p["w"]
        h = comm.all_gather_dim0(h.movedim(-1, 0).contiguous(), group, n)
        return torch.tanh(h.movedim(0, -1) + p["b"])

    return stage


def pipeline_modes(rank, world, out, stages4, stages8, x, tgt, gpt):
    """The stacked pipelines on (4,) "pp": forward (plain and interleaved
    V=2), gradients under gpipe / remat / 1f1b (V=1 and 2), each rank's
    P2P counts and live residual sets; (2, 2) "pp" x "dp" 1f1b with
    data_axis; (2, 2) "pp" x "tp" forward with param_spec; the tiny GPT's
    pipelined steps (gpipe; 1f1b with n_virtual=2)."""
    from easydist_tpu_torch.parallel import (PipelineConfig, spmd_pipeline,
                                             spmd_pipeline_grad)
    from easydist_tpu_torch.parallel._axes import mesh_axis

    S, M = 4, x.shape[0]
    st4, st8 = from_numpy(stages4), from_numpy(stages8)
    xs, ts = from_numpy(x), from_numpy(tgt)
    res = {}
    mesh = _mesh((4,), ("pp",))
    res["fwd"] = to_numpy(spmd_pipeline(
        tanh_stage, mesh, PipelineConfig(S, M))(st4, xs))
    res["fwd_v2"] = to_numpy(spmd_pipeline(
        tanh_stage, mesh, PipelineConfig(S, M, n_virtual=2))(st8, xs))
    for sched, V in (("gpipe", 1), ("remat", 1), ("1f1b", 1), ("1f1b", 2),
                     ("gpipe", 2)):
        fn = spmd_pipeline_grad(tanh_stage, mse, mesh, PipelineConfig(
            S, M, schedule=sched, n_virtual=V))
        loss, grads = fn(st4 if V == 1 else st8, xs, ts)
        res[f"{sched}_v{V}"] = (float(loss), to_numpy(grads),
                                fn.stats[0], fn.tables["ring"])
    mesh_dp = _mesh((2, 2), ("pp", "dp"))
    fn = spmd_pipeline_grad(tanh_stage, mse, mesh_dp, PipelineConfig(
        2, M, schedule="1f1b", data_axis="dp"))
    two = pytree.tree_map(lambda a: a[:2], st4)
    loss, grads = fn(two, xs, ts)
    res["dp_1f1b"] = (float(loss), to_numpy(grads))
    mesh_tp = _mesh((2, 2), ("pp", "tp"))
    tp = mesh_axis(mesh_tp, "tp")
    res["tp_fwd"] = to_numpy(spmd_pipeline(
        _tp_stage(tp.group, tp.size), mesh_tp,
        PipelineConfig(2, M, param_spec={"b": (), "w": (None, "tp")}))(
            two, xs))
    res["gpt"] = gpt_pipeline(mesh, **gpt)
    return res


def gpt_pipeline(mesh, params, cfg, tokens, targets, steps, runs):
    """3 steps of `make_gpt_pipeline_step` per (schedule, n_virtual):
    {run: (losses, final rank params, the rank's layers)}."""
    from easydist_tpu_torch.models.gpt import (GPTConfig,
                                               make_gpt_pipeline_step,
                                               params_from_numpy)

    cfg = GPTConfig(**cfg)
    full = params_from_numpy(params, device=CPU)
    tok, tgt = from_numpy(tokens), from_numpy(targets)
    out = {}
    for sched, V in runs:
        step, init = make_gpt_pipeline_step(cfg, mesh, tok.shape[0],
                                            lr=1e-4, schedule=sched,
                                            n_virtual=V)
        state, losses = init(params=full), []
        for _ in range(steps):
            state, loss = step(state, tok, tgt)
            losses.append(float(loss))
        out[f"{sched}_v{V}"] = (losses, to_numpy(state[0]), step.layers)
    return out


# ------------------------------------------------------------ pp_compile

N_LAYERS = 4


def pp_loss(params, x, y):
    h = x
    for i in range(N_LAYERS):
        h = torch.tanh(h @ params[f"w{i}"])
    return torch.mean((h - y) ** 2)


def pp_marked_loss(params, x, y):
    """pp_loss with a split_point after the first layer."""
    from easydist_tpu_torch.parallel import split_point

    h = x
    for i in range(N_LAYERS):
        h = torch.tanh(h @ params[f"w{i}"])
        if i == 0:
            h = split_point(h)
    return torch.mean((h - y) ** 2)


def pp_skip_loss(params, x, y):
    """The first layer's output rejoins after the last: a residual that
    skips every stage boundary between them."""
    h0 = torch.tanh(x @ params["w0"])
    h = h0
    for i in range(1, N_LAYERS):
        h = torch.tanh(h @ params[f"w{i}"])
    return torch.mean((h + h0 - y) ** 2)


def _pp_train(mesh, loss_fn, params, batches, steps=3, **kw):
    from easydist_tpu_torch.fxfront import easydist_compile

    compiled = easydist_compile(loss_fn, mesh=mesh, pp_stages=2,
                                n_microbatches=4, **kw)
    state = compiled.init_state(params, *batches[0])
    losses = []
    for x, y in batches[:steps]:
        state, loss = compiled(state, x, y)
        losses.append(float(loss))
    return compiled, state, losses


def pp_compile_modes(rank, world, out, params, batches):
    """easydist_compile(pp_stages=2) on (2,) "pp" (world 2) or (2, 2)
    "pp" x "dp" (world 4): 3-step losses and exported params per
    schedule (Adam lr 1e-2; gpipe also with SGD), the split_point run,
    the errors of a changed and of an indivisible batch; on world 4 also
    the skip residual over a 4-stage (4,) "pp" pipeline against the
    unsplit loss and gradients, and make_torch_pp_train_step (world 2)."""
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.parallel.auto_pipeline import pipeline_grad

    shape, names = ((2,), ("pp",)) if world == 2 else ((2, 2), ("pp", "dp"))
    mesh = _mesh(shape, names)
    p0 = from_numpy(params)
    bs = [tuple(from_numpy(b)) for b in batches]
    res = {}
    for sched, opt in (("gpipe", "adam"), ("remat", "adam"),
                       ("1f1b", "adam"), ("gpipe", "sgd")):
        compiled, state, losses = _pp_train(mesh, pp_loss, p0, bs,
                                            schedule=sched, lr=1e-2,
                                            optimizer=opt)
        res[f"{sched}_{opt}"] = (losses,
                                 to_numpy(compiled.export_state_dict(state)),
                                 compiled.pipe.stats[0])
        if sched == "gpipe" and opt == "adam":
            plan = compiled.stage_plan
            res["split"] = (plan.ends, plan.stage_flops)
            res["state_bytes"] = sum(
                t.numel() * t.element_size()
                for t in pytree.tree_leaves(state[0]))
            res["row_elems"] = compiled.pipe.prep.row_elems
            res["layouts"] = compiled.pipe.prep.layouts
            half = tuple(t[: t.shape[0] // 2] for t in bs[0])
            try:
                compiled(state, *half)
            except ValueError as e:
                res["changed_batch"] = str(e)
    compiled, state, losses = _pp_train(mesh, pp_marked_loss, p0, bs,
                                        schedule="1f1b", lr=1e-2)
    res["marked"] = (losses, compiled.stage_plan.ends,
                     len(compiled.stage_plan.stage_nodes[0]))
    odd = tuple(t[:-2] for t in bs[0])
    try:
        easydist_compile(pp_loss, mesh=mesh, pp_stages=2,
                         n_microbatches=4).init_state(p0, *odd)
    except ValueError as e:
        res["indivisible"] = str(e)
    if world == 4:
        mesh4 = _mesh((4,), ("pp",))
        x, y = bs[0]
        mb = (x.reshape(4, -1, x.shape[-1]), y.reshape(4, -1, y.shape[-1]))
        leaves, spec = pytree.tree_flatten(p0)
        pg, pack = pipeline_grad(
            lambda p, b: pp_skip_loss(pytree.tree_unflatten(p, spec), *b),
            leaves, (mb[0][0], mb[1][0]), mesh4, 4, 4, schedule="1f1b")
        loss, (d_row, d_shared) = pg(pack(leaves), mb)
        plan = pg.plan
        res["skip"] = (float(loss), to_numpy(d_row), [
            len(b) for b in plan.boundaries], pg.prep.layouts, rank)
    else:
        res["torchfront"] = torch_pp_losses(mesh, params, batches)
        res["typed"] = typed_boundary(mesh, p0, bs[0][0])
    return res


def typed_fn(params, x):
    """A bool mask and an int64 count made at stage 0 and read at stage
    1, across the split_point."""
    from easydist_tpu_torch.parallel import split_point

    mask = x > 0
    count = mask.long().sum(-1, keepdim=True)
    h = split_point(torch.tanh(x @ params["w0"]))
    h = torch.tanh(h @ params["w1"])
    return torch.where(mask, h, -h) + count


def typed_boundary(mesh, params, x):
    """pipeline_forward of typed_fn on (2,) "pp": (output, the direct
    output, the boundary's dtypes)."""
    from easydist_tpu_torch.parallel import pipeline_forward

    mbs = x.reshape(4, -1, x.shape[-1])
    pipe = pipeline_forward(typed_fn, params, mbs[0], mesh, 2, 4)
    want = torch.stack([typed_fn(params, mb) for mb in mbs])
    dtypes = sorted(str(n.meta["val"].dtype)
                    for n in pipe.plan.boundaries[0])
    return to_numpy(pipe(params, mbs)), to_numpy(want), dtypes


def torch_pp_losses(mesh, params, batches):
    """make_torch_pp_train_step over an nn.Sequential of the layers."""
    from easydist_tpu_torch.torchfront import make_torch_pp_train_step

    layers = []
    for i in range(N_LAYERS):
        lin = torch.nn.Linear(*params[f"w{i}"].shape, bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(params[f"w{i}"]).T)
        layers += [lin, torch.nn.Tanh()]
    bs = [tuple(from_numpy(b)) for b in batches]
    compiled, p0 = make_torch_pp_train_step(
        torch.nn.Sequential(*layers), (bs[0][0],), mse, mesh, pp_stages=2,
        n_microbatches=4, lr=1e-2)
    state = compiled.init_state(p0, *bs[0])
    losses = []
    for x, y in bs:
        state, loss = compiled(state, x, y)
        losses.append(float(loss))
    return losses


# -------------------------------------------------------------------- MoE

def moe_modes(rank, world, out, params, x, cfgs):
    """moe_layer on (world,) "ep" per config: this rank's output block,
    the aux loss, the port's moe_reference, and the gradients of the
    global loss mean(y^2) + 0.01 aux (each rank's share of it, the
    router's gradient summed over the ranks); the all_to_all bytes from
    the layer's graph."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch.parallel.moe import (MoEConfig, moe_layer,
                                                 moe_params_from_numpy,
                                                 moe_reference)
    from easydist_tpu_torch.parallel._axes import mesh_axis

    mesh = _mesh((world,), ("ep",))
    ax = mesh_axis(mesh, "ep")
    res = {}
    for name, kw in cfgs.items():
        cfg = MoEConfig(**kw)
        p = moe_params_from_numpy(params[name], device=CPU)
        xs = from_numpy(x)
        with torch.no_grad():
            y, aux = moe_layer(p, xs, mesh, cfg)
            y_ref, aux_ref = moe_reference(p, xs, cfg, n_devices=world)
        live = {k: v.clone().requires_grad_() for k, v in p.items()}
        y_g, aux_g = moe_layer(live, xs, mesh, cfg)
        loss = torch.mean(y_g ** 2) / world + 0.01 * aux_g / world
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        grads["router"] = comm.all_reduce_sum(grads["router"], ax.group)
        res[name] = dict(y=to_numpy(y), aux=float(aux), y_ref=to_numpy(y_ref),
                         aux_ref=float(aux_ref), grads=to_numpy(grads),
                         graph=collective_counts(
                             lambda p_, x_: moe_layer(p_, x_, mesh, cfg),
                             p, xs))
    return res


# ------------------------------------------ tensor parallelism in stages

def wide_loss(params, x, y):
    """4 tanh layers, wide enough that the tp solve shards them."""
    h = x
    for i in range(N_LAYERS):
        h = torch.tanh(h @ params[f"w{i}"])
    return torch.mean((h - y) ** 2)


def mixed_loss(params, x, y):
    """Two wide layers and a narrow head the tp solve keeps replicated."""
    h = torch.tanh(x @ params["w0"])
    h = torch.tanh(h @ params["w1"])
    return torch.mean((h @ params["head"] - y) ** 2)


GPT_TP_KW = dict(vocab=128, seq=64, dim=64, heads=4, layers=2)


def gpt_tp_loss(params, tokens, targets):
    """The tiny GPT's loss with flash attention (the kernel's custom op
    stays replicated over tp)."""
    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_loss

    cfg = GPTConfig.tiny(attention="flash", **GPT_TP_KW)
    return gpt_loss(params, cfg, tokens, targets)


def pp_tp_modes(rank, world, out, shape, cases):
    """easydist_compile(pp_stages=2, tp_axes=("tp",)) on a "pp" x "dp" x
    "tp" mesh of `shape`, per case (loss name, params, x, y, schedule,
    M): 3 Adam steps (lr 1e-2) on one batch, the losses, the tp plan's
    summary, its strategies' operand counts and
    sharded nodes, the tp collectives this rank issued in the steps
    ({kind: [count, bytes]}) and what the plan's conversions give for one
    microbatch."""
    from easydist_tpu_torch.fxfront import easydist_compile

    mesh = _mesh(shape, ("pp", "dp", "tp"))
    losses_fn = {"wide": wide_loss, "mixed": mixed_loss, "pp": pp_loss,
                 "gpt": gpt_tp_loss}
    res = {}
    for key, (loss, params, x, y, schedule, M) in cases.items():
        compiled = easydist_compile(losses_fn[loss], mesh=mesh, pp_stages=2,
                                    n_microbatches=M, lr=1e-2,
                                    tp_axes=("tp",), schedule=schedule)
        p0, xt, yt = from_numpy(params), torch.from_numpy(x), \
            torch.from_numpy(y)
        state = compiled.init_state(p0, xt, yt)
        prep = compiled.pipe.prep
        tp_group = prep.tp[1].group.group_name
        losses, seen = [], {}
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "_c10d_functional" \
                        and tp_group in args:
                    c = seen.setdefault(func.__name__.split(".")[0], [0, 0])
                    c[0] += 1
                    c[1] += args[0].numel() * args[0].element_size()
                return func(*args, **(kwargs or {}))

        for _ in range(3):
            with Count():
                state, lv = compiled(state, xt, yt)
            losses.append(float(lv))
        s = prep.pp.index
        res[key] = dict(
            losses=losses, summary=compiled.tp_summary(),
            operands=[len(st.in_placements)
                      for st in compiled.tp_plan.values()],
            sharded_ops=sorted(
                name for name, st in compiled.tp_plan.items()
                if any(q is not None and q.is_shard()
                       for q in list(st.in_placements)
                       + list(st.out_placements))),
            seen=seen, per_mb=prep.tp_collectives(s), steps_mb=3 * M,
            stage=s)
    return res


# ------------------------------------------------- sessions over a mesh

def serve_mesh_modes(rank, world, out, params, cfg_kw, prompts, n_new,
                     runs):
    """GenerationSession.for_gpt(mesh=) on (world,) "tp", per run (name:
    ServeConfig keywords): every prompt's ids, the solver's placements of
    each program's first two inputs (the cache or arena leaves), and the
    verify steps taken."""
    from easydist_tpu_torch.models.gpt import GPTConfig, params_from_numpy
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    mesh = _mesh((world,), ("tp",))
    cfg = GPTConfig.tiny(**cfg_kw)
    p = params_from_numpy(params, device=CPU)
    res = {}
    for name, kw in runs.items():
        sess = GenerationSession.for_gpt(p, cfg, config=ServeConfig(**kw),
                                         device=CPU, mesh=mesh)
        futs = [sess.submit(pr, max_new_tokens=n_new) for pr in prompts]
        sess.run_until_drained()
        ids = [f.result()["ids"] for f in futs]
        picks = {}
        progs = {"decode": sess._decode_c, **sess._programs}
        for prog_name, fn in progs.items():
            for result in fn._cache.values():
                picks[prog_name] = [[repr(q) for q in pl]
                                    for pl in result.in_placements[:2]]
        res[name] = dict(ids=ids, picks=picks,
                         verify_steps=sess.metrics.counter("verify_steps"))
    return res


# ------------------------------------------------ GPTConfig.remat on dp

def gpt_remat_modes(rank, world, out, params, tokens, cfg_kw, modes):
    """The GPT train step under each GPTConfig(remat=...) mode compiled on
    (world,) "dp": the emitted collectives (kind, bytes) and one step's
    loss from the JAX weights."""
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.gpt import (GPTConfig,
                                               make_gpt_train_step,
                                               params_from_numpy)
    from easydist_tpu_torch.models.optim import adam_init

    mesh = _mesh((world,), ("dp",))
    tok = torch.from_numpy(tokens)
    res = {}
    for mode in modes:
        step, _ = make_gpt_train_step(GPTConfig.tiny(remat=mode, **cfg_kw))
        p = params_from_numpy(params, device=CPU)
        compiled = easydist_compile(step, mesh=mesh)
        state = (p, adam_init(p))
        result = compiled.get_compiled(state, tok, tok)
        _, loss = compiled(state, tok, tok)
        res[mode] = dict(collectives=[(c.kind, c.group_bytes)
                                      for c in result.collectives],
                         loss=float(loss))
    return res


# ------------------------------------- P-placed chains (partial regions)

def chain_deferral(x, w1, w2):
    """mm with a contracted-sharded pin -> elementwise -> mm -> sum."""
    from easydist_tpu_torch.fxfront import fix_sharding

    x = fix_sharding(x, None, "tp")
    w1 = fix_sharding(w1, "tp", None)
    return torch.sum(-(x @ w1) @ w2)


def chain_hybrid(x, w1, w2):
    """The deferral chain batch-sharded over dp, contracted over tp; the
    (batch,) sums come back."""
    from easydist_tpu_torch.fxfront import fix_sharding

    x = fix_sharding(x, "dp", "tp")
    w1 = fix_sharding(w1, "tp", None)
    return torch.sum(-(x @ w1) @ w2, dim=1)


def chain_scatter(x, w):
    """A partial chain whose consumer wants row shards: the fence is a
    reduce_scatter."""
    from easydist_tpu_torch.fxfront import fix_sharding

    x = fix_sharding(x, None, "tp")
    w = fix_sharding(w, "tp", None)
    z = fix_sharding((x @ w) * 2.0, "tp", None)
    return torch.sum(z)


CHAINS = {"deferral": (chain_deferral, ("tp",)),
          "hybrid": (chain_hybrid, ("dp", "tp")),
          "scatter": (chain_scatter, ("tp",))}


def partial_chains(rank, world, out, cases):
    """Each chain compiled with the partial pools on and off on its mesh
    (case: chain name, mesh shape, numpy inputs): the outputs and the
    emitted collectives (kind, bytes of the value across the group)."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import easydist_compile

    res = {}
    for key, (chain, shape, inputs) in cases.items():
        fn, names = CHAINS[chain]
        mesh = _mesh(shape, names)
        args = [torch.from_numpy(a) for a in inputs]
        res[key] = {}
        for pools in (False, True):
            edconfig.enable_partial_pools = pools
            compiled = easydist_compile(fn, mesh=mesh, state_io={})
            result = compiled.get_compiled(*args)
            res[key][pools] = dict(
                out=to_numpy(compiled(*args)),
                collectives=[(c.kind, c.group_bytes)
                             for c in result.collectives])
        edconfig.enable_partial_pools = True
    return res
