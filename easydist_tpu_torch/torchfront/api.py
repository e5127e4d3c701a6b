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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the manual data-parallel and pipeline "
        f"modes come with ROADMAP queue A item 6b; use parallel_mode='auto'")


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
    parallel_mode: "auto" (the solver's SPMD plan); the manual modes
    "ddp" / "zero2" / "zero3" are not ported yet (ROADMAP 6b).
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
    if parallel_mode in _MANUAL_MODES:
        raise _not_ported(f"parallel_mode={parallel_mode!r}")
    if parallel_mode != "auto":
        raise ValueError(f"unknown parallel_mode {parallel_mode!r}")
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
        return _make_train_mode_step(fwd, loss_fn, opt_init, opt_update,
                                     params0, split, mesh, **kwargs)

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


def make_torch_pp_train_step(module, example_args, loss_fn: Callable,
                             mesh, pp_stages: int, **kwargs):
    """Pipeline-parallel training of a torch module (reference
    easydist_tpu/torchfront/api.py:483): not ported yet."""
    raise _not_ported("make_torch_pp_train_step")

