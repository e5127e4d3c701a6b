"""User API for torch modules: the port of easydist_tpu/torchfront/api.py.

`easydist_compile_torch(module, example_args)` compiles a module's
forward; `make_torch_train_step(module, example_args, loss_fn, ...)` builds
a whole train step (forward, `torch.autograd.grad`, the optimizer update)
and compiles it with `easydist_compile`.  The JAX package converts the
module's exported graph to jax (`torchfront/convert.py`); the port needs
no converter: it runs the module's own aten graph, with the parameters
and buffers passed in as a dict, through `torch.func.functional_call`,
and `make_fx` traces that.

State layouts follow the JAX package: in eval export
`state = (params, opt_state)` (`params` alone for plain SGD), in
training-mode export `state = ((trainable, buffers), opt_state)`; `params`
is a {qualified name: tensor} dict of parameters and buffers.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from easydist_tpu_torch.fxfront.api import easydist_compile
from easydist_tpu_torch.models.optim import (adagrad_init, adagrad_update,
                                             adam_init, adam_update,
                                             rmsprop_init, rmsprop_update,
                                             sgd_init, sgd_update,
                                             value_and_grad)

_MANUAL_MODES = ("ddp", "zero2", "zero3")


class _ModuleFn:
    """`module`'s forward as a function of a {name: tensor} dict of its
    parameters and buffers, in eval or training mode whatever the
    module's own flags (they are restored after each call)."""

    def __init__(self, module, train: bool):
        self.module = module
        self.train = train
        self.buffer_names = frozenset(n for n, _ in module.named_buffers())

    def params(self):
        """A detached copy of the module's parameters and buffers."""
        return {**{n: p.detach().clone()
                   for n, p in self.module.named_parameters()},
                **{n: b.detach().clone()
                   for n, b in self.module.named_buffers()}}

    def __call__(self, params, *inputs):
        flags = [(m, m.training) for m in self.module.modules()]
        self.module.train(self.train)
        try:
            return torch.func.functional_call(self.module, params, inputs)
        finally:
            for m, flag in flags:
                m.training = flag


def easydist_compile_torch(module, example_args, mesh=None, **kwargs):
    """Auto-parallel inference callable for a torch module (eval mode).

    Returns (compiled_fn, params): compiled_fn(params, *inputs) runs the
    compiled forward; params is a {name: tensor} dict of the module's
    parameters and buffers (replace leaves to load new weights).
    `example_args` are accepted for the JAX signature: the compile
    happens at the first call, per signature."""
    del example_args
    fwd = _ModuleFn(module, train=False)
    return easydist_compile(fwd, mesh=mesh, state_io={}, **kwargs), \
        fwd.params()


def _translate_torch_optimizer(optimizer, module):
    """torch.optim instance -> (kind, hyperparameters, state translator).
    Kinds: Adam, AdamW, SGD, RMSprop, Adagrad.

    Several param groups give per-parameter lr / weight_decay (and for
    Adam, betas) trees, which `models/optim.py` broadcasts leafwise; a
    parameter in no group gets lr 0 (torch would never step it).  The
    other hyperparameters must be uniform across groups."""
    name_of = {id(p): n for n, p in module.named_parameters()}
    groups = optimizer.param_groups
    kind = type(optimizer).__name__.lower()
    if kind not in ("adam", "adamw", "sgd", "rmsprop", "adagrad"):
        raise NotImplementedError(
            f"torch optimizer {type(optimizer).__name__} not supported "
            f"(Adam, AdamW, SGD, RMSprop and Adagrad are)")

    def uniform(key, default=None):
        vals = {repr(g.get(key, default)) for g in groups}
        if len(vals) != 1:
            raise NotImplementedError(
                f"per-group {key} not supported (groups have {vals})")
        return groups[0].get(key, default)

    lr_tree = {n: 0.0 for n in name_of.values()}
    wd_tree = {n: 0.0 for n in name_of.values()}
    for g in groups:
        for p in g["params"]:
            qual = name_of.get(id(p))
            if qual is None:
                raise ValueError(
                    "optimizer param not found among module parameters")
            lr_tree[qual] = float(g["lr"])
            wd_tree[qual] = float(g.get("weight_decay", 0.0))
    multi = len(groups) > 1
    lr_h = lr_tree if multi else groups[0]["lr"]
    wd_h = wd_tree if multi else groups[0].get("weight_decay", 0.0)

    if kind in ("adam", "adamw"):
        if uniform("amsgrad", False) or uniform("maximize", False):
            raise NotImplementedError("Adam amsgrad/maximize not supported")
        betas = {repr(g["betas"]) for g in groups}
        if len(betas) == 1:
            b1, b2 = groups[0]["betas"]
        else:  # per-group betas -> per-leaf trees (default where unlisted)
            b1 = {n: 0.9 for n in name_of.values()}
            b2 = {n: 0.999 for n in name_of.values()}
            for g in groups:
                for p in g["params"]:
                    qual = name_of[id(p)]
                    b1[qual], b2[qual] = map(float, g["betas"])
        hyper = {"lr": lr_h, "b1": b1, "b2": b2, "eps": uniform("eps"),
                 "weight_decay": wd_h, "decoupled": kind == "adamw"}
    elif kind == "rmsprop":
        hyper = {"lr": lr_h, "alpha": float(uniform("alpha", 0.99)),
                 "eps": float(uniform("eps", 1e-8)),
                 "momentum": float(uniform("momentum", 0.0) or 0.0),
                 "centered": bool(uniform("centered", False)),
                 "weight_decay": wd_h}
    elif kind == "adagrad":
        adagrad_iav = float(uniform("initial_accumulator_value", 0.0))
        hyper = {"lr": lr_h, "lr_decay": float(uniform("lr_decay", 0.0)),
                 "eps": float(uniform("eps", 1e-10)),
                 "weight_decay": wd_h,
                 "initial_accumulator_value": adagrad_iav}
    else:  # sgd
        hyper = {"lr": lr_h,
                 "momentum": float(uniform("momentum", 0.0) or 0.0),
                 "nesterov": bool(uniform("nesterov", False)),
                 "weight_decay": wd_h}

    def translate_state(params0):
        """Carry a warm optimizer's buffers over: exp_avg / exp_avg_sq /
        step (Adam), momentum buffers (SGD), square_avg / momentum /
        grad_avg (RMSprop), sum / step (Adagrad)."""
        def t(tensor):
            return tensor.detach().clone()

        def count(n):
            return torch.tensor(n, dtype=torch.int32,
                                device=next(iter(params0.values())).device)

        if kind == "sgd":
            if not hyper["momentum"]:
                return None
            opt = sgd_init(dict(params0))
            for p, st in optimizer.state.items():
                qual = name_of.get(id(p))
                if qual is not None and st.get("momentum_buffer") is not None:
                    opt["buf"][qual] = t(st["momentum_buffer"])
            return opt
        if kind == "rmsprop":
            opt = rmsprop_init(dict(params0), momentum=hyper["momentum"],
                               centered=hyper["centered"])
            for p, st in optimizer.state.items():
                qual = name_of.get(id(p))
                if qual is None or "square_avg" not in st:
                    continue
                opt["sq"][qual] = t(st["square_avg"])
                if "buf" in opt and st.get("momentum_buffer") is not None:
                    opt["buf"][qual] = t(st["momentum_buffer"])
                if "gavg" in opt and st.get("grad_avg") is not None:
                    opt["gavg"][qual] = t(st["grad_avg"])
            return opt
        if kind == "adagrad":
            # hyper's copy is popped by _stateful_opt_fns before init runs
            opt = adagrad_init(dict(params0),
                               initial_accumulator_value=adagrad_iav)
            steps = 0
            for p, st in optimizer.state.items():
                qual = name_of.get(id(p))
                if qual is None or "sum" not in st:
                    continue
                opt["sum"][qual] = t(st["sum"])
                steps = int(st["step"])
            opt["count"] = count(steps)
            return opt
        opt = adam_init(dict(params0))
        steps = 0
        for p, st in optimizer.state.items():
            qual = name_of.get(id(p))
            if qual is None or "exp_avg" not in st:
                continue
            opt["mu"][qual] = t(st["exp_avg"])
            opt["nu"][qual] = t(st["exp_avg_sq"])
            steps = int(st["step"])
        opt["count"] = count(steps)
        return opt

    # AdamW rides the Adam update (the decoupled flag in hyper)
    return ("adam" if kind == "adamw" else kind), hyper, translate_state


def _stateful_opt_fns(optimizer, hyper):
    """(init(params), update(params, grads, state, lr, **hyper)) of the
    stateful optimizer kinds; None for SGD (without momentum it is
    stateless, so it is handled on its own)."""
    if optimizer == "adam":
        return adam_init, adam_update
    if optimizer == "rmsprop":
        mom = hyper.get("momentum", 0.0)
        cen = hyper.get("centered", False)
        return (lambda p: rmsprop_init(p, momentum=mom, centered=cen),
                rmsprop_update)
    if optimizer == "adagrad":
        iav = hyper.pop("initial_accumulator_value", 0.0)
        return (lambda p: adagrad_init(p, initial_accumulator_value=iav),
                adagrad_update)
    return None


def _optimizer_fns(optimizer, lr, hyper, translate_state):
    """(init(trainable) -> opt state or None, update(trainable, grads,
    opt) -> (new trainable, new opt state))."""
    opt_fns = _stateful_opt_fns(optimizer, hyper)
    if opt_fns is not None:
        opt_init, opt_update = opt_fns

        def update(tp, grads, opt):
            return opt_update(tp, grads, opt, lr=lr, **hyper)
    elif optimizer == "sgd" and hyper.get("momentum"):
        opt_init = sgd_init

        def update(tp, grads, opt):
            return sgd_update(tp, grads, lr=lr, state=opt, **hyper)
    elif optimizer == "sgd":
        def opt_init(tp):
            return None

        def update(tp, grads, opt):
            return sgd_update(tp, grads, lr=lr, **hyper), None
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    def init(trainable):
        opt = translate_state(trainable) if translate_state else None
        return opt if opt is not None else opt_init(trainable)

    return init, update


def make_torch_train_step(module, example_args, loss_fn: Callable,
                          optimizer="adam", lr: float = 1e-3,
                          mesh=None, parallel_mode: str = "auto",
                          train: Optional[bool] = None, **kwargs):
    """Build an auto-parallel train step from a torch module.

    loss_fn(outputs, *targets) -> scalar torch loss.
    optimizer: "adam" / "sgd" / "rmsprop" / "adagrad", or a torch.optim
    Adam / AdamW / SGD / RMSprop / Adagrad INSTANCE built on this module:
    its hyperparameters (per-group lr / weight_decay / betas included) and
    warm buffers are carried into the functional update.
    parallel_mode: "auto" (the solver's SPMD plan) or the manual modes
    "ddp" / "zero2" / "zero3" (`parallel.dp`: per-rank steps on the
    mesh's first axis, which shards the batch; every rank passes the
    global batch).  In eval export ddp trains with SGD and zero2 / zero3
    with Adam, as in the JAX package: step(params, inputs, *targets) ->
    (params, loss) for ddp, step(state, inputs, *targets) -> (state,
    loss) with zero2's state (params, opt, count) and zero3's (param
    blocks, opt blocks, count).  With train=True any optimizer runs, its
    state sharded like the ZeRO mode's (see `_manual_train_step`).
    train: False (default) trains with eval-mode semantics whatever the
    module's flag; True trains in training mode (dropout active,
    batch-norm batch statistics, running statistics updated) and the
    step takes a torch.Generator whose state drives every random draw:
      compiled_step(state, rng, inputs, *targets) -> (new_state, loss)
      state = ((trainable, buffers), opt_state)
    In eval export:
      compiled_step(state, inputs, *targets) -> (new_state, loss)
      state = (params, opt_state), or params for plain SGD.
    Returns (compiled_step, init_state); init_state() builds the state
    from the module's current weights (and the optimizer's buffers).
    `kwargs` go to `easydist_compile`."""
    del example_args
    if parallel_mode not in ("auto",) + _MANUAL_MODES:
        raise ValueError(f"unknown parallel_mode {parallel_mode!r}")
    if parallel_mode != "auto":
        from easydist_tpu_torch.fxfront.mesh import get_device_mesh

        mesh = mesh if mesh is not None else get_device_mesh()
        if mesh is None:
            raise ValueError(f"parallel_mode={parallel_mode!r} needs a mesh")
    train = bool(train)
    translate_state = None
    hyper = {}
    if not isinstance(optimizer, str):
        optimizer, hyper, translate_state = _translate_torch_optimizer(
            optimizer, module)
        lr = hyper.pop("lr")
    opt_init, opt_update = _optimizer_fns(optimizer, lr, hyper,
                                          translate_state)
    fwd = _ModuleFn(module, train)
    params0 = fwd.params()
    buffer_names = fwd.buffer_names

    def split(params):
        return ({k: v for k, v in params.items() if k not in buffer_names},
                {k: v for k, v in params.items() if k in buffer_names})

    if train:
        if parallel_mode != "auto":
            return _manual_train_step(parallel_mode, fwd, loss_fn, opt_init,
                                      opt_update, params0, split, mesh,
                                      **kwargs)
        return _make_train_mode_step(fwd, loss_fn, opt_init, opt_update,
                                     params0, split, mesh, **kwargs)
    if parallel_mode != "auto":
        return _manual_eval_step(parallel_mode, fwd, loss_fn, optimizer, lr,
                                 params0, mesh, **kwargs)

    trainable0, _ = split(params0)
    stateless = optimizer == "sgd" and not hyper.get("momentum")

    def train_step(params, opt, inputs, targets):
        trainable, buffers = split(params)
        # buffers (eval-mode batch-norm statistics) are not weights: they
        # stay out of autodiff and the update
        loss, grads = value_and_grad(
            lambda tp: loss_fn(fwd({**tp, **buffers}, inputs), *targets),
            trainable)
        new_tp, new_opt = opt_update(trainable, grads, opt)
        return {k: new_tp.get(k, v) for k, v in params.items()}, new_opt, \
            loss

    if stateless:
        def step(params, inputs, *targets):
            new_params, _, loss = train_step(params, None, inputs, targets)
            return new_params, loss

        def init_state():
            return {k: v.clone() for k, v in params0.items()}
    else:
        def step(state, inputs, *targets):
            params, opt = state
            new_params, new_opt, loss = train_step(params, opt, inputs,
                                                   targets)
            return (new_params, new_opt), loss

        def init_state():
            return ({k: v.clone() for k, v in params0.items()},
                    opt_init(trainable0))

    return easydist_compile(step, mesh=mesh, **kwargs), init_state


@contextlib.contextmanager
def _drawing_from(rng: torch.Generator):
    """Make the default generator of `rng`'s device draw `rng`'s stream:
    its state goes in before and comes back out after (the traced step's
    random ops draw from the default generator)."""
    if rng.device.type == "cuda":
        default = torch.cuda.default_generators[
            rng.device.index if rng.device.index is not None
            else torch.cuda.current_device()]
    else:
        default = torch.default_generator
    saved = default.get_state()
    default.set_state(rng.get_state())
    try:
        yield
    finally:
        rng.set_state(default.get_state())
        default.set_state(saved)


def _make_train_mode_step(fwd, loss_fn, opt_init, opt_update, params0,
                          split, mesh, **kwargs):
    """Training-mode export: state = ((trainable, buffers), opt_state);
    step(state, rng, inputs, *targets) -> (state, loss).  Each dropout
    site draws its mask from `rng`'s stream in program order, as eager
    torch draws from its generator; batch-norm running statistics are
    updated on copies of the buffers, which come back in the new state.
    On a mesh the random draws stay replicated (every rank draws the
    whole mask, `fxfront/presets.py`), so ranks handed generators in one
    state agree with the one-device step."""
    trainable0, buffers0 = split(params0)

    def step(state, inputs, *targets):
        (trainable, buffers), opt = state
        new_buf = {k: v.clone() for k, v in buffers.items()}

        def objective(tp):
            return loss_fn(fwd({**tp, **new_buf}, inputs), *targets)

        loss, grads = value_and_grad(objective, trainable)
        new_tp, new_opt = opt_update(trainable, grads, opt)
        return ((new_tp, new_buf), new_opt), loss

    compiled = easydist_compile(step, mesh=mesh, **kwargs)

    def rng_step(state, rng, inputs, *targets):
        with _drawing_from(rng):
            return compiled(state, inputs, *targets)

    def init_state():
        tp = {k: v.clone() for k, v in trainable0.items()}
        return ((tp, {k: v.clone() for k, v in buffers0.items()}),
                opt_init(tp))

    return rng_step, init_state


def _manual_eval_step(mode, fwd, loss_fn, optimizer, lr, params0, mesh,
                      **kwargs):
    """The JAX package's eval-export manual modes: ddp_step (SGD),
    zero2_step / zero3_step (Adam) over every parameter and buffer."""
    from easydist_tpu_torch.parallel import ddp_step, zero2_step, zero3_step

    if kwargs:
        raise ValueError(f"{sorted(kwargs)} do not apply to "
                         f"parallel_mode={mode!r} (the manual modes bypass "
                         f"easydist_compile)")
    # manual modes carry their own optimizer: reject a contradictory one
    if mode == "ddp" and optimizer != "sgd":
        raise ValueError("parallel_mode='ddp' trains with SGD; pass "
                         "optimizer='sgd' (or use parallel_mode='auto')")
    if mode in ("zero2", "zero3") and optimizer != "adam":
        raise ValueError(f"parallel_mode={mode!r} trains with Adam; pass "
                         f"optimizer='adam'")
    axis = mesh.mesh_dim_names[0]

    def objective(p, inputs, *targets):
        return loss_fn(fwd(p, inputs), *targets)

    def fresh():
        return {k: v.clone() for k, v in params0.items()}

    if mode == "ddp":
        return ddp_step(objective, mesh, axis=axis, lr=lr), fresh
    if mode == "zero2":
        step, init_opt = zero2_step(objective, mesh, axis=axis, lr=lr)

        def init_state2():
            p = fresh()
            return (p, init_opt(p), torch.zeros(
                (), dtype=torch.int32, device=next(iter(p.values())).device))

        return step, init_state2
    step, init_state3 = zero3_step(objective, mesh, axis=axis, lr=lr)
    return step, lambda: init_state3(fresh())


def _manual_train_step(mode, fwd, loss_fn, opt_init, opt_update, params0,
                       split, mesh, **kwargs):
    """Training-mode export of the manual modes, per rank on the mesh's
    first axis: state = ((trainable, buffers), opt); step(state, rng,
    inputs, *targets) -> (state, loss).  Each rank runs its block of the
    batch with `rng`'s stream (dropout masks are the rank's own) and the
    optimizer runs leafwise (every optimizer of models/optim.py is
    elementwise):
      ddp    gradients all_reduce'd (mean), state replicated;
      zero2  gradients reduce_scatter'd, the optimizer state of a leaf
             whose dim 0 divides the axis holds the rank's dim-0 block,
             updated blocks all_gathered;
      zero3  trainable params held as blocks too, all_gathered at the
             start of each step.
    Batch-norm running statistics are the rank's block's, averaged over
    the axis after the step: where the JAX package's single program keeps
    global-batch statistics, this is torch DDP's per-rank normalisation
    with synchronised running statistics."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch.parallel._axes import local_block, mesh_axis

    if kwargs:
        raise ValueError(f"{sorted(kwargs)} do not apply to "
                         f"parallel_mode={mode!r} (the manual modes bypass "
                         f"easydist_compile)")
    ax = mesh_axis(mesh, mesh.mesh_dim_names[0])
    n = ax.size
    trainable0, buffers0 = split(params0)
    flags = {k: v.ndim > 0 and v.shape[0] % n == 0 and mode != "ddp"
             for k, v in trainable0.items()}

    def block(tree):
        return {k: local_block(v, 0, n, ax.index).clone() if flags[k]
                else v.clone() for k, v in tree.items()}

    def gather(tree):
        return {k: comm.all_gather_dim0(v, ax.group, n) if flags[k] else v
                for k, v in tree.items()}

    def reduce(grads):
        return {k: comm.reduce_scatter_grad(g, ax.group, n) if flags[k]
                else comm.all_reduce_grad(g, ax.group, n)
                for k, g in grads.items()}

    def init_state():
        tp = {k: v.clone() for k, v in trainable0.items()}
        opt = opt_init(block(tp))
        if mode == "zero3":
            tp = block(tp)
        return ((tp, {k: v.clone() for k, v in buffers0.items()}), opt)

    def step(state, rng, inputs, *targets):
        (tp, buffers), opt = state
        full = gather(tp) if mode == "zero3" else tp
        new_buf = {k: v.clone() for k, v in buffers.items()}
        inputs_l = local_block(inputs, 0, n, ax.index)
        targets_l = [local_block(t, 0, n, ax.index) for t in targets]

        def objective(t):
            return loss_fn(fwd({**t, **new_buf}, inputs_l), *targets_l)

        with _drawing_from(rng):
            loss, grads = value_and_grad(objective, full)
        g_blocks = reduce(grads)
        p_blocks = tp if mode == "zero3" else \
            {k: local_block(v, 0, n, ax.index) if flags[k] else v
             for k, v in tp.items()}
        new_blocks, new_opt = opt_update(p_blocks, g_blocks, opt)
        new_tp = new_blocks if mode == "zero3" else gather(new_blocks)
        new_buf = {k: comm.all_reduce_sum(v, ax.group) / n
                   if v.is_floating_point() else v
                   for k, v in new_buf.items()}
        loss = comm.all_reduce_sum(loss, ax.group) / n
        return ((new_tp, new_buf), new_opt), loss

    return step, init_state


def make_torch_pp_train_step(module, example_args, loss_fn: Callable,
                             mesh, pp_stages: int,
                             n_microbatches: Optional[int] = None,
                             lr: Optional[float] = None,
                             optimizer: str = "adam",
                             schedule: str = "gpipe", tp_axes=None,
                             train: bool = False, pp_axis: str = "pp"):
    """Pipeline-parallel training of a torch module: the torch frontend's
    entry to `easydist_compile(pp_stages=...)` (reference
    easydist/torch/experimental/pp/api.py).  The module's forward, its
    parameters passed in as a dict, is auto-split into `pp_stages`
    stages (`fxfront.pp_compile`).

    Returns (compiled, params0):
        state = compiled.init_state(params0, inputs, *targets)
        state, loss = compiled(state, inputs, *targets)

    loss_fn(outputs, *targets) -> scalar loss (mean reduction).
    train=True runs training-mode semantics; modules with batch-norm or
    active dropout are refused (their buffer updates and masks do not
    thread through the stages).  optimizer: 'adam' or 'sgd' (a
    torch.optim instance's per-group settings cannot address the packed
    stage rows).  pp_axis names the mesh axis the stages lie on; every
    other axis is a batch sibling, except a `tp_axes` axis, on which the
    solver picks tensor parallelism inside every stage."""
    if not isinstance(optimizer, str):
        raise NotImplementedError(
            "torch.optim instances are not supported with pp_stages: the "
            "pipeline optimizer runs on packed flat stage rows, which "
            "per-parameter-group hyperparameters cannot address; pass "
            "optimizer='adam'/'sgd' + lr=")
    if mesh is None:
        raise ValueError("make_torch_pp_train_step needs a mesh")
    if pp_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"pp_axis {pp_axis!r} is not a mesh axis (mesh has "
            f"{tuple(mesh.mesh_dim_names or ())}); pass pp_axis= matching "
            f"your mesh's pipeline axis name")
    del example_args
    if train:
        stateful = [type(m).__name__ for m in module.modules()
                    if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                    or (isinstance(m, torch.nn.modules.dropout._DropoutNd)
                        and m.p > 0)]
        if stateful:
            raise NotImplementedError(
                f"modules {sorted(set(stateful))} cannot pipeline in "
                f"training mode yet (running statistics and dropout masks "
                f"do not thread through the stages); use "
                f"make_torch_train_step(..., parallel_mode='auto')")
    fwd = _ModuleFn(module, train=bool(train))
    params0 = fwd.params()
    # buffers are not weights: they stay out of the pipeline optimizer
    buffers0 = {k: v for k, v in params0.items() if k in fwd.buffer_names}
    params0 = {k: v for k, v in params0.items()
               if k not in fwd.buffer_names}

    def loss(params, inputs, *targets):
        return loss_fn(fwd({**params, **buffers0}, inputs), *targets)

    compiled = easydist_compile(
        loss, mesh=mesh, pp_stages=pp_stages,
        n_microbatches=n_microbatches or pp_stages * 2, lr=lr,
        optimizer=optimizer, schedule=schedule, pp_axis=pp_axis,
        tp_axes=tp_axes)
    return compiled, params0
