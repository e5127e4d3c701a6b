"""Tensor micro-API that the ShardCombine engine runs on.

The discovery engine (metashard/) only needs 17 tensor operations, so it
is kept framework-neutral behind this registry.  Backends: "torch" (the
default; discovery runs eagerly where its input tensors live, by default
on `config.discovery_device`) and "numpy" (tests of the engine with no
torch op at all).
"""

import importlib
import sys

_BACKEND_NAME = None
_BACKEND_MOD = None

# the operations every backend must provide
_API = [
    "Tensor", "add", "equal", "allclose", "zeros_like", "minimum", "maximum",
    "concatenate", "chunk", "narrow", "clone", "from_numpy", "to_numpy",
    "tree_flatten", "tree_unflatten", "stack", "batched_call",
]


def init_backend(name: str = "torch"):
    """Load a backend module and re-export its micro-API here."""
    global _BACKEND_NAME, _BACKEND_MOD
    mod = importlib.import_module(f"easydist_tpu_torch.platform.{name}_backend")
    for fn in _API:
        if not hasattr(mod, fn):
            raise RuntimeError(f"backend {name!r} is missing platform op {fn!r}")
        setattr(sys.modules[__name__], fn, getattr(mod, fn))
    _BACKEND_NAME = name
    _BACKEND_MOD = mod
    return mod


def get_backend() -> str:
    return _BACKEND_NAME


def backend_initialized() -> bool:
    return _BACKEND_NAME is not None


def writes_input(fn) -> bool:
    """True when `fn` is an operator whose schema marks an argument as
    written (aten's in-place and `out=` overloads: `add_`, `copy_`)."""
    schema = getattr(fn, "_schema", None)
    return schema is not None and any(
        a.alias_info is not None and a.alias_info.is_write
        for a in schema.arguments)


def __getattr__(name):
    """Lazily initialize the default (torch) backend on first API access,
    so importing the package stays cheap and the numpy backend can be
    selected first."""
    if name in _API and _BACKEND_NAME is None:
        init_backend("torch")
        return getattr(sys.modules[__name__], name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
