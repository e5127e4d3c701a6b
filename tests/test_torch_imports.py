"""The port stands alone: `easydist_tpu_torch`, `chip_smoke.py` and the
torch example twins (`examples/torch/`, TWINS) import neither JAX nor the
JAX package, and `chip_smoke.py` fails without the repository around
it."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "easydist_tpu_torch")
BANNED = ("jax", "jaxlib", "easydist_tpu")
TWINS = ("train_gpt", "simple_function", "moe_layer", "pipeline_gpt",
         "pipeline_1f1b_gpt", "hybrid_pp_tp", "serve_gpt")
TWIN_PATHS = [os.path.join(REPO, "examples", "torch", f"{n}.py")
              for n in TWINS]


def _port_modules():
    names = ["easydist_tpu_torch"]
    for info in pkgutil.walk_packages([PORT], prefix="easydist_tpu_torch."):
        names.append(info.name)
    return names


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _imported_names(path):
    """(line, module) of every absolute import statement in a file,
    those inside functions too."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _smoke_modules():
    """The modules `chip_smoke.py` imports (at the top and inside its
    phases), and those its `from easydist_tpu_torch... import x` names
    when x is a module."""
    port = set(_port_modules())
    names = set()
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names
                         if f"{node.module}.{a.name}" in port)
    return sorted(names)


def test_every_port_module_imports_with_jax_blocked():
    """Import every port module, `chip_smoke.py` and every module its
    phases import, and run its platform cases, in a fresh interpreter
    whose import system refuses jax, jaxlib and easydist_tpu."""
    modules = _port_modules()
    for name in ("serve.generation", "models.optim", "models.mlp",
                 "models.gpt", "ops.flash_attention", "fxfront.api",
                 "fxfront.mesh", "fxfront.interpreter", "fxfront.presets",
                 "fxfront.discovery", "fxfront.bridge", "fxfront.emit",
                 "runtime.op_profile", "fxfront.scope",
                 "ops.attention_prim", "parallel", "parallel.ring_attention",
                 "parallel.ulysses", "torchfront", "torchfront.api",
                 "platform.torch_backend", "metashard.metaop",
                 "metashard.metair", "autoflow.solver",
                 "schedule.memory_planner", "native", "kv.tier",
                 "serve.speculate", "serve.engine", "serve.batcher",
                 "serve.admission", "resilience", "resilience.faultinject",
                 "resilience.breaker", "comm", "comm.counters",
                 "comm.reduce", "comm.overlap", "parallel.dp",
                 "parallel.pipeline", "parallel.auto_pipeline",
                 "parallel.moe", "fxfront.pp_compile", "schedule.remat",
                 "schedule", "comm.quant", "comm.bucketer",
                 "resilience.guard", "resilience.preempt",
                 "runtime.checkpoint", "runtime.data", "runtime.elastic",
                 "runtime.profiler", "runtime.calibrate", "models.llama",
                 "reshard", "reshard.plan", "reshard.exec",
                 "reshard.restore", "fleet", "fleet.hashring",
                 "fleet.health", "fleet.failover", "fleet.transport",
                 "fleet.router", "sim", "sim.events", "sim.simulate",
                 "sim.capacity", "sim.autoscale", "analyze",
                 "analyze.findings", "analyze.strategy_rules",
                 "analyze.discovery_rules", "analyze.memory_rules",
                 "analyze.schedule_rules", "analyze.kv_rules",
                 "analyze.fleet_rules", "analyze.sim_rules",
                 "analyze.modelcheck", "analyze.protocol_rules",
                 "analyze.alias_rules", "analyze.driver",
                 "analyze.__main__", "utils", "utils.dump",
                 "analyze.fx_rules", "analyze.overlap_rules",
                 "analyze.resilience_rules", "analyze.serve_rules",
                 "analyze.kv_quant_rules", "analyze.reshard_rules",
                 "models.vit", "models.resnet", "models.gat",
                 "utils.timer"):
        assert f"easydist_tpu_torch.{name}" in modules
    code = f"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in {BANNED!r}):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
import chip_smoke
for m in {_smoke_modules()!r}:
    importlib.import_module(m)
for case in chip_smoke.BACKEND_CASES.values():
    case("cpu")
# the multi-device frontend end to end (discovery, solve, emission, the
# emitted program) against a fake group of 2, and the spawned ranks'
# module of the gloo tests
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from easydist_tpu_torch import config
from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
from easydist_tpu_torch.runtime.op_profile import profile_ops
config.discovery_device = "cpu"
config.discovery_persistent_cache = False
config.discovery_crosscheck = True
dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
mesh = make_device_mesh((2,), ("dp",), device_type="cpu")
res = easydist_compile(lambda a, b: (a @ b).sum(), mesh=mesh,
                       compile_only=True)(torch.ones(8, 4), torch.ones(4, 8))
res.graph_module(torch.ones(4, 4), torch.ones(4, 8))
dist.destroy_process_group()
importlib.import_module("tests.test_torch_fxfront_ranks")
importlib.import_module("tests.test_torch_parallel_ranks")
importlib.import_module("tests.test_torch_comm_ranks")
importlib.import_module("tests.test_torch_reshard_ranks")
importlib.import_module("tests.test_torch_examples")
import importlib.util
for path in {TWIN_PATHS!r}:
    spec = importlib.util.spec_from_file_location("twin", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in {BANNED!r})]
assert not loaded, loaded
print("imported", len({modules!r}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout


def test_analyze_cli_runs_with_jax_blocked(tmp_path):
    """`python -m easydist_tpu_torch.analyze --device cpu` over all three
    targets, in an interpreter that refuses jax, jaxlib and easydist_tpu:
    exit 0 against the committed empty baseline."""
    code = f"""
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in {BANNED!r}):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from easydist_tpu_torch import config
config.prof_db_path = {str(tmp_path / "p.db")!r}
config.discovery_cache_dir = {str(tmp_path / "disc")!r}
sys.argv = ["analyze", "--device", "cpu", "--targets",
            "ast,protocol,presets", "--cache-dir", {str(tmp_path / "c")!r}]
try:
    runpy.run_module("easydist_tpu_torch.analyze", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "0 error(s) (0 new, 0 baselined)" in proc.stdout
    assert "protocol[router]: 1048 states" in proc.stdout


def test_no_import_statement_names_jax():
    files = [os.path.join(REPO, "chip_smoke.py")] + TWIN_PATHS
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f"{os.path.relpath(path, REPO)}:{line} {name}"
                 for path in files for line, name in _imported_names(path)
                 if _banned(name)]
    assert not offenders, offenders


def test_chip_smoke_imports_only_the_port():
    """`chip_smoke.py` imports the standard library, numpy, torch and the
    port, and nothing of the tests (which import JAX)."""
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch",
                                              "easydist_tpu_torch"}
    offenders = [f"chip_smoke.py:{line} {name}" for line, name in
                 _imported_names(os.path.join(REPO, "chip_smoke.py"))
                 if name.split(".")[0] not in allowed]
    assert not offenders, offenders


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into an empty directory, chip_smoke.py must exit non-zero
    and print no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
