"""NumPy implementation of the platform micro-API — hardware-free unit testing.

Gives the metashard engine a backend with no torch op at all: the engine
can be tested, and its torch backend held against it, op by op.
"""

import numpy as np

from easydist_tpu_torch import config as edconfig

Tensor = np.ndarray


def add(x, y):
    return np.add(x, y)


def equal(x, y):
    return x.shape == y.shape and bool(np.array_equal(x, y))


def allclose(x, y, equal_nan=False):
    if getattr(x, "shape", None) != getattr(y, "shape", None):
        return False
    return bool(np.allclose(x, y, rtol=edconfig.allclose_rtol,
                            atol=edconfig.allclose_atol, equal_nan=equal_nan))


def zeros_like(x):
    return np.zeros_like(x)


def minimum(x, y):
    return np.minimum(x, y)


def maximum(x, y):
    return np.maximum(x, y)


def concatenate(tensors, dim=0):
    return np.concatenate(tensors, axis=dim)


def chunk(tensor, chunks, dim=0):
    return np.split(tensor, chunks, axis=dim)


def narrow(tensor, dim, start, length):
    index = [slice(None)] * tensor.ndim
    index[dim] = slice(start, start + length)
    return tensor[tuple(index)]


def clone(x):
    return np.copy(x)


def stack(tensors, dim=0):
    return np.stack(tensors, axis=dim)


def batched_call(fn, flat_args, in_axes):
    """The numpy backend has no batched execution — raising here routes
    MetaOp back to its sequential per-shard loop (same results)."""
    raise RuntimeError("numpy backend has no batched probe execution")


def from_numpy(x):
    return np.asarray(x)


def to_numpy(x):
    return np.asarray(x)


def tree_flatten(tree):
    """Minimal pytree flatten over dict/list/tuple containers."""
    leaves = []

    def _flatten(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [_flatten(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), [_flatten(x) for x in node])
        leaves.append(node)
        return ("leaf",)

    spec = _flatten(tree)
    return leaves, spec


def tree_unflatten(leaves, spec):
    it = iter(leaves)

    def _unflatten(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            _, keys, children = node
            return {k: _unflatten(c) for k, c in zip(keys, children)}
        _, _, children = node
        seq = [_unflatten(c) for c in children]
        return seq if kind == "list" else tuple(seq)

    return _unflatten(spec)
