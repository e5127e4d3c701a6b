"""Functional optimizers over trees of tensors: the port of
easydist_tpu/models/optim.py.

Like the JAX module they take and return nested dict/list trees (the
models' parameter layout), never update in place, and run as plain
tensor arithmetic, so a traced train step holds the update as aten ops
beside the forward and backward.  Semantics are torch.optim's.

Hyperparameters (`lr`, `weight_decay`, Adam's betas) accept a scalar or
a tree matching `params` (per-parameter-group settings).  Step counts
are int32 0-d tensors, as in the JAX package's state.

`value_and_grad` is the port's `jax.value_and_grad` for a train step:
it differentiates with `torch.autograd.grad` inside `enable_grad()`
(which `make_fx` traces even under an outer `no_grad`), not with
`torch.func`, whose transforms refuse the custom ops' autograd.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _map(fn, tree, *rest):
    return pytree.tree_map(fn, tree, *rest)


def _hyper_tree(val, params):
    """Broadcast a scalar hyperparameter to every param leaf; pass trees
    through (they must match the params structure)."""
    if isinstance(val, (int, float)) or getattr(val, "ndim", None) == 0:
        return _map(lambda _: val, params)
    return val


def _keyed_like(state, new):
    """`new` with `state`'s key order: torch's pytrees (unlike JAX's) key
    a dict's structure by its key order, and a compiled step pairs a new
    state with its input only when the structures match."""
    return {k: new[k] for k in state}


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of `loss_fn(params, *args)` with grads a tree like
    params.  Differentiates fresh leaves (detached, requires_grad), so the
    caller's tensors are never marked."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(pytree.tree_unflatten(live, spec), *args)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def adam_init(params):
    return {"mu": _map(torch.zeros_like, params),
            "nu": _map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=pytree.tree_leaves(params)[0].device)}


def adam_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, decoupled=False):
    """torch.optim.Adam semantics; `decoupled=True` gives AdamW (weight
    decay applied directly to the parameter, not folded into the grad).
    `b1`/`b2` accept scalars or per-leaf trees (per-group betas)."""
    lr_t = _hyper_tree(lr, params)
    wd_t = _hyper_tree(weight_decay, params)
    b1_t = _hyper_tree(b1, params)
    b2_t = _hyper_tree(b2, params)
    if not decoupled:
        grads = _map(lambda g, p, wd: g + wd * p, grads, params, wd_t)
    count = state["count"] + 1
    fcount = count.to(torch.float32)
    mu = _map(lambda m, g, b1_: b1_ * m + (1 - b1_) * g,
              state["mu"], grads, b1_t)
    nu = _map(lambda v, g, b2_: b2_ * v + (1 - b2_) * g * g,
              state["nu"], grads, b2_t)
    if decoupled:
        new_params = _map(
            lambda p, m, v, lr_, wd_, b1_, b2_: p - lr_ * (
                (m / (1 - b1_ ** fcount))
                / (torch.sqrt(v / (1 - b2_ ** fcount)) + eps) + wd_ * p),
            params, mu, nu, lr_t, wd_t, b1_t, b2_t)
    else:
        new_params = _map(
            lambda p, m, v, lr_, b1_, b2_: p - lr_ * (m / (1 - b1_ ** fcount))
            / (torch.sqrt(v / (1 - b2_ ** fcount)) + eps),
            params, mu, nu, lr_t, b1_t, b2_t)
    return new_params, _keyed_like(state, {"mu": mu, "nu": nu,
                                           "count": count})


def adamw_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-2):
    return adam_update(params, grads, state, lr=lr, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, decoupled=True)


def rmsprop_init(params, momentum=0.0, centered=False):
    state = {"sq": _map(torch.zeros_like, params)}
    if momentum:
        state["buf"] = _map(torch.zeros_like, params)
    if centered:
        state["gavg"] = _map(torch.zeros_like, params)
    return state


def rmsprop_update(params, grads, state, lr=1e-2, alpha=0.99, eps=1e-8,
                   weight_decay=0.0, momentum=0.0, centered=False):
    """torch.optim.RMSprop semantics (square-avg EMA; optional heavy-ball
    momentum on the preconditioned grad; optional centered variant)."""
    lr_t = _hyper_tree(lr, params)
    wd_t = _hyper_tree(weight_decay, params)
    grads = _map(lambda g, p, wd: g + wd * p, grads, params, wd_t)
    sq = _map(lambda s, g: alpha * s + (1 - alpha) * g * g, state["sq"],
              grads)
    new_state = {"sq": sq}
    if centered:
        gavg = _map(lambda a, g: alpha * a + (1 - alpha) * g, state["gavg"],
                    grads)
        new_state["gavg"] = gavg
        denom = _map(lambda s, a: torch.sqrt(s - a * a) + eps, sq, gavg)
    else:
        denom = _map(lambda s: torch.sqrt(s) + eps, sq)
    if momentum:
        buf = _map(lambda b, g, d: momentum * b + g / d, state["buf"], grads,
                   denom)
        new_state["buf"] = buf
        new_params = _map(lambda p, b, lr_: p - lr_ * b, params, buf, lr_t)
    else:
        new_params = _map(lambda p, g, d, lr_: p - lr_ * g / d, params,
                          grads, denom, lr_t)
    return new_params, _keyed_like(state, new_state)


def adagrad_init(params, initial_accumulator_value=0.0):
    return {"sum": _map(lambda p: torch.full_like(
                p, initial_accumulator_value), params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=pytree.tree_leaves(params)[0].device)}


def adagrad_update(params, grads, state, lr=1e-2, lr_decay=0.0, eps=1e-10,
                   weight_decay=0.0):
    """torch.optim.Adagrad semantics (accumulated squared grads; lr decayed
    by 1/(1 + step*lr_decay) with step counted from 0)."""
    lr_t = _hyper_tree(lr, params)
    wd_t = _hyper_tree(weight_decay, params)
    grads = _map(lambda g, p, wd: g + wd * p, grads, params, wd_t)
    acc = _map(lambda s, g: s + g * g, state["sum"], grads)
    decay = 1.0 + state["count"].to(torch.float32) * lr_decay
    new_params = _map(
        lambda p, g, s, lr_: p - (lr_ / decay) * g / (torch.sqrt(s) + eps),
        params, grads, acc, lr_t)
    return new_params, _keyed_like(state, {"sum": acc,
                                           "count": state["count"] + 1})


def sgd_init(params):
    """Momentum buffers (torch initializes the buffer to the first grad —
    equivalent to momentum * 0 + g)."""
    return {"buf": _map(torch.zeros_like, params)}


def sgd_update(params, grads, lr=1e-2, momentum=0.0, nesterov=False,
               weight_decay=0.0, state=None):
    """torch.optim.SGD semantics.  Stateless (returns new params) when
    `state` is None and momentum is 0; with momentum pass `state` from
    `sgd_init` and receive `(new_params, new_state)`."""
    lr_t = _hyper_tree(lr, params)
    wd_t = _hyper_tree(weight_decay, params)
    grads = _map(lambda g, p, wd: g + wd * p, grads, params, wd_t)
    if momentum:
        if state is None:
            raise ValueError("sgd momentum requires state from sgd_init()")
        buf = _map(lambda b, g: momentum * b + g, state["buf"], grads)
        if nesterov:
            grads = _map(lambda g, b: g + momentum * b, grads, buf)
        else:
            grads = buf
        new_params = _map(lambda p, g, lr_: p - lr_ * g, params, grads, lr_t)
        return new_params, {"buf": buf}
    new_params = _map(lambda p, g, lr_: p - lr_ * g, params, grads, lr_t)
    if state is not None:
        return new_params, state
    return new_params
