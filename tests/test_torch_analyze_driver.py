"""The port's analyzer driver (`python -m easydist_tpu_torch.analyze`) on
a temporary tree: an inline suppression silences its finding, an unused
one is DRV001, the baseline gates only new errors (a stale entry is
DRV002), SARIF and JSON are written, a warm cache replays the findings
byte-identically, `EASYDIST_ANALYZE=0` skips every target and exits 0,
the `protocol` target reaches every committed state count, and the
`presets` target compiles on the CPU with `--device cpu` (and refuses to
fall back to it without the flag when no card answers)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from easydist_tpu_torch.analyze import driver
from easydist_tpu_torch.analyze.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BAD = ("def peek(router):\n"
       "    return len(router._inflight)\n")
SUPPRESSED = ("def peek(router):\n"
              "    return len(router._inflight)  "
              "# easydist: disable=PROTO004\n")
UNUSED = ("def peek(router):\n"
          "    return router.stats()  # easydist: disable=ALIAS001\n")


def tree(tmp_path, **files):
    root = tmp_path / "repo"
    pkg = root / "easydist_tpu_torch"
    pkg.mkdir(parents=True)
    (root / "examples" / "torch").mkdir(parents=True)
    for name, src in files.items():
        (pkg / f"{name}.py").write_text(src)
    return str(root)


def run(root, tmp_path, *extra, targets="ast"):
    return main(["--root", root, "--targets", targets, "--quiet",
                 "--cache-dir", str(tmp_path / "cache"), *extra])


def test_new_error_gates_and_suppression_silences(tmp_path):
    root = tree(tmp_path, bad=BAD)
    res = driver.run_driver(root, targets=("ast",), use_cache=False)
    assert [f.rule_id for f in res.new_errors] == ["PROTO004"]
    assert res.new_errors[0].path == os.path.join("easydist_tpu_torch",
                                                  "bad.py")
    assert run(root, tmp_path) == 1
    root2 = tree(tmp_path / "b", bad=SUPPRESSED)
    res = driver.run_driver(root2, targets=("ast",), use_cache=False)
    assert res.report.findings == [] and res.suppressed == 1
    assert run(root2, tmp_path) == 0


def test_unused_suppression_is_drv001(tmp_path):
    root = tree(tmp_path, unused=UNUSED)
    res = driver.run_driver(root, targets=("ast",), use_cache=False)
    assert [(f.rule_id, f.severity, f.line) for f in res.report.findings] \
        == [("DRV001", "warning", 2)]
    assert res.new_errors == []


def test_baseline_gates_only_new_errors(tmp_path):
    root = tree(tmp_path, bad=BAD)
    base = str(tmp_path / "baseline.json")
    assert run(root, tmp_path, "--baseline", base,
               "--refresh-baseline") == 0
    entries = json.load(open(base))["findings"]
    assert [e["rule_id"] for e in entries] == ["PROTO004"]
    assert run(root, tmp_path, "--baseline", base) == 0
    with open(os.path.join(root, "easydist_tpu_torch", "worse.py"),
              "w") as f:
        f.write("def poke(fleet, x):\n    fleet._handoffs.append(x)\n")
    assert run(root, tmp_path, "--baseline", base) == 1
    os.remove(os.path.join(root, "easydist_tpu_torch", "bad.py"))
    os.remove(os.path.join(root, "easydist_tpu_torch", "worse.py"))
    res = driver.run_driver(root, targets=("ast",), baseline_path=base,
                            use_cache=False)
    assert [f.rule_id for f in res.report.findings] == ["DRV002"]


def test_sarif_json_and_warm_cache(tmp_path):
    root = tree(tmp_path, bad=BAD, unused=UNUSED)
    sarif, out1, out2 = (str(tmp_path / n) for n in
                         ("a.sarif", "a.json", "b.json"))
    assert run(root, tmp_path, "--sarif", sarif, "--json", out1) == 1
    doc = json.load(open(sarif))
    assert doc["version"] == "2.1.0"
    results = doc["runs"][0]["results"]
    assert sorted(r["ruleId"] for r in results) == ["DRV001", "PROTO004"]
    assert run(root, tmp_path, "--json", out2) == 1
    cold, warm = json.load(open(out1)), json.load(open(out2))
    assert cold["cache"] == {"hits": 0, "misses": 2}
    assert warm["cache"] == {"hits": 2, "misses": 0}
    assert json.dumps(warm["findings"]) == json.dumps(cold["findings"])


def test_kill_switch_skips_everything(tmp_path):
    root = tree(tmp_path, bad=BAD)
    env = dict(os.environ, EASYDIST_ANALYZE="0", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "easydist_tpu_torch.analyze", "--root", root,
         "--targets", "ast,protocol,presets", "--cache-dir",
         str(tmp_path / "cache")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "skipped (EASYDIST_ANALYZE=0)" in proc.stdout


def test_protocol_target_reaches_committed_states(tmp_path):
    res = driver.run_driver(REPO, targets=("protocol",),
                            cache_dir=str(tmp_path / "cache"))
    assert res.report.findings == []
    assert {name: (st["states"], st["exhausted"])
            for name, st in res.protocol.items()} == {
        "health": (40, True), "router": (1048, True),
        "resume": (48, True), "transport": (552, True)}


def test_presets_target_on_the_cpu(tmp_path, monkeypatch):
    from easydist_tpu_torch import config as tconfig

    monkeypatch.setattr(tconfig, "prof_db_path", str(tmp_path / "p.db"))
    monkeypatch.setattr(tconfig, "discovery_cache_dir",
                        str(tmp_path / "disc"))
    out = str(tmp_path / "p.json")
    assert main(["--root", REPO, "--targets", "ast,presets", "--device",
                 "cpu", "--quiet", "--json", out, "--cache-dir",
                 str(tmp_path / "cache")]) == 0
    report = json.load(open(out))
    assert report["new_errors"] == []
    assert report["n_files"] > 100
    assert report["discovery"]["latest"]["rules_preset"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver.run_driver(REPO, targets=("presets",), use_cache=False)
