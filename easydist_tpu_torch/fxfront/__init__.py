from .api import (CompiledFunction, CompileResult, easydist_compile,
                  infer_state_io)

__all__ = ["CompiledFunction", "CompileResult", "easydist_compile",
           "infer_state_io"]
