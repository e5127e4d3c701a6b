from .api import (easydist_compile_torch, make_torch_pp_train_step,
                  make_torch_train_step)

__all__ = ["easydist_compile_torch", "make_torch_pp_train_step",
           "make_torch_train_step"]
