"""The port stands alone: `easydist_tpu_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, and `chip_smoke.py` fails without the
repository around it."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "easydist_tpu_torch")
BANNED = ("jax", "jaxlib", "easydist_tpu")


def _port_modules():
    names = ["easydist_tpu_torch"]
    for info in pkgutil.walk_packages([PORT], prefix="easydist_tpu_torch."):
        names.append(info.name)
    return names


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_every_port_module_imports_with_jax_blocked():
    """Import every port module in a fresh interpreter whose import
    system refuses jax, jaxlib and easydist_tpu."""
    modules = _port_modules()
    for name in ("serve.generation", "models.optim", "models.mlp",
                 "models.gpt", "ops.flash_attention", "fxfront.api"):
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
loaded = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in {BANNED!r})]
assert not loaded, loaded
print("imported", len({modules!r}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout


def test_no_import_statement_names_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                          for n in names if _banned(n)]
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
