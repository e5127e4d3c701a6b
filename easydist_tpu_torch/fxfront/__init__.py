from .api import (CompiledFunction, CompileResult, compile_step,
                  easydist_compile, get_opt_strategy, infer_state_io,
                  solve_axes)
from .mesh import (get_axis_specs, get_device_mesh, make_device_mesh,
                   set_device_mesh)
from .scope import fix_sharding, scoped_region

__all__ = ["CompiledFunction", "CompileResult", "compile_step",
           "easydist_compile", "fix_sharding", "get_axis_specs",
           "get_device_mesh", "get_opt_strategy", "infer_state_io",
           "make_device_mesh", "scoped_region", "set_device_mesh",
           "solve_axes"]
