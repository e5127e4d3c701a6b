"""Analyzer driver: one entry point over the port's rule stack (the port
of easydist_tpu/analyze/driver.py).

`python -m easydist_tpu_torch.analyze` wraps the analyze layers behind a
single CLI with the shared infrastructure the per-layer hooks never had
(the Automap argument: compile-time analysis scales only when the
machinery — suppressions, baselines, artifact export, caching — is
shared, arXiv:2112.02958):

* **targets** — `ast` runs the layer-11 host-code donation lint AND the
  layer-12 concurrency sanitizer (PROTO004/005) over
  `easydist_tpu_torch/` + `examples/torch/`; `presets` compiles the MLP
  train step with `easydist_compile` on a (4, 2) "dp" x "tp" mesh
  against torch's fake process group of 8 and runs the
  `CompileResult.analyze()` stack (strategy, discovery, memory plan, and
  the program lint: COLL001/004 over every rank's emitted program,
  COLL002 across them, ALIAS001-003 over the traced program and its
  state pairs) over it — on the card unless `device="cpu"` is asked
  for; `protocol`
  exhaustively explores the four layer-12 protocol specs (health,
  router, resume, transport — analyze/modelcheck.py) and gates on
  PROTO001/002 plus committed state-count drift.
* **inline suppressions** — `# easydist: disable=ALIAS001` (comma list
  for several rules) on the flagged line silences a finding; a
  suppression that silences nothing is itself reported (DRV001) so
  stale escapes burn down instead of accreting.
* **baseline** — a committed JSON of finding fingerprints
  (`Finding.fingerprint()`: rule|path|node, message and line excluded
  so rewording and unrelated edits don't churn it).  Baselined findings
  still report but do not gate; NEW findings fail the run.
  `--refresh-baseline` rewrites the file from the current report.
* **SARIF + JSON export** — `--sarif`/`--json` emit CI artifacts
  (SARIF 2.1.0 minimal profile).
* **incremental cache** — results are cached under
  `<compile_cache_dir>/analyze/` keyed on (artifact content hash,
  rule-module version): per source file for the `ast` target, per
  package-source snapshot for `presets`.  A warm rerun on unchanged
  artifacts skips the lint/compile and replays the stored findings
  byte-identically; editing any rule module invalidates everything.

`EASYDIST_ANALYZE=0` skips every target (the driver reports
`skipped`); `EASYDIST_ANALYZE_RAISE` is irrelevant here — the driver
never raises, it exit-codes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import (RULES, SEV_ERROR, AnalysisReport, Finding,
                       make_finding)

# bump when the driver's own semantics change in a way that must
# invalidate cached results (cache keys include it alongside the rule
# module hashes)
DRIVER_VERSION = 1

_SUPPRESS_RE = re.compile(r"#\s*easydist:\s*disable=([A-Za-z0-9_, ]+)")

# the modules whose source forms the "rule version" half of every cache
# key: any edit to a rule (or to this driver) re-runs every layer
_RULE_MODULE_FILES = (
    "findings.py", "alias_rules.py", "strategy_rules.py",
    "memory_rules.py", "schedule_rules.py", "fleet_rules.py",
    "kv_rules.py", "sim_rules.py", "discovery_rules.py", "modelcheck.py",
    "protocol_rules.py", "fx_rules.py", "overlap_rules.py",
    "resilience_rules.py", "serve_rules.py", "kv_quant_rules.py",
    "reshard_rules.py", "driver.py",
)

# the trees the `ast` target lints, relative to the repo root
AST_SUBDIRS = ("easydist_tpu_torch", os.path.join("examples", "torch"))


def rule_version() -> str:
    """Content hash of every rule module + the driver itself."""
    h = hashlib.sha256(str(DRIVER_VERSION).encode())
    base = os.path.dirname(os.path.abspath(__file__))
    for name in _RULE_MODULE_FILES:
        path = os.path.join(base, name)
        try:
            with open(path, "rb") as f:
                h.update(name.encode())
                h.update(f.read())
        except OSError:
            h.update(f"missing:{name}".encode())
    return h.hexdigest()[:16]


def finding_to_dict(f: Finding) -> Dict[str, object]:
    return {"rule_id": f.rule_id, "severity": f.severity, "node": f.node,
            "message": f.message, "path": f.path, "line": f.line}


def finding_from_dict(d: Dict[str, object]) -> Finding:
    return Finding(str(d["rule_id"]), str(d["severity"]), str(d["node"]),
                   str(d["message"]), path=d.get("path"),
                   line=d.get("line"))


# ------------------------------------------------------------ suppressions


def collect_suppressions(source: str) -> Dict[int, Set[str]]:
    """{1-based line -> rule ids} for every `# easydist: disable=...`
    comment — real COMMENT tokens only (a docstring that *mentions* the
    syntax is not a suppression).  Unknown rule ids are kept (they still
    mark the suppression as present, and DRV001 will flag them as
    unused)."""
    import io
    import tokenize

    out: Dict[int, Set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if rules:
                out.setdefault(tok.start[0], set()).update(rules)
    return out


def apply_suppressions(findings: List[Finding],
                       suppressions: Dict[int, Set[str]],
                       rel_path: str) -> Tuple[List[Finding], int]:
    """Drop findings whose (line, rule) is suppressed; append one DRV001
    per suppression entry that silenced nothing.  Returns
    (kept + DRV001 findings, n_suppressed)."""
    used: Set[Tuple[int, str]] = set()
    kept: List[Finding] = []
    n_suppressed = 0
    for f in findings:
        rules = suppressions.get(f.line or -1, ())
        if f.rule_id in rules:
            used.add((f.line, f.rule_id))
            n_suppressed += 1
        else:
            kept.append(f)
    for line, rules in sorted(suppressions.items()):
        for rule in sorted(rules):
            if (line, rule) not in used:
                kept.append(make_finding(
                    "DRV001", f"{rel_path}:{line}",
                    f"suppression for {rule} silences nothing on this "
                    f"line — remove it (stale escapes hide future "
                    f"regressions)", path=rel_path, line=line))
    return kept, n_suppressed


# ---------------------------------------------------------------- baseline


def load_baseline(path: Optional[str]) -> Set[str]:
    """Fingerprints from a committed baseline file; {} when absent."""
    return {str(e.get("fingerprint"))
            for e in load_baseline_entries(path)
            if e.get("fingerprint")}


def load_baseline_entries(path: Optional[str]) -> List[Dict[str, object]]:
    """The baseline file's raw entry list ([] when absent/corrupt) —
    the DRV002 stale-entry audit needs the context fields, not just the
    fingerprints."""
    if not path or not os.path.exists(path):
        return []
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        entries = data.get("findings", [])
        return [e for e in entries if isinstance(e, dict)]
    except (OSError, ValueError, AttributeError, TypeError):
        return []


def stale_baseline_findings(baseline_path: Optional[str],
                            findings: Iterable[Finding]) -> List[Finding]:
    """One DRV002 warning per baseline entry whose fingerprint no
    longer matches ANY current finding — the debt was paid (or the code
    moved) and the escape now hides a future regression at the same
    coordinates.  `--refresh-baseline` prunes them."""
    entries = load_baseline_entries(baseline_path)
    if not entries:
        return []
    current = {f.fingerprint() for f in findings}
    out: List[Finding] = []
    for e in sorted(entries, key=lambda e: str(e.get("fingerprint", ""))):
        fp = str(e.get("fingerprint", ""))
        if not fp or fp in current:
            continue
        out.append(make_finding(
            "DRV002", f"baseline:{fp}",
            f"baseline entry {e.get('rule_id', '?')} at "
            f"{e.get('path') or e.get('node') or '?'} matches no "
            f"current finding — the finding was fixed or moved; run "
            f"--refresh-baseline to prune it"))
    return out


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Rewrite the baseline from the current (post-suppression) report.
    Entries keep human-readable context next to the fingerprint so a
    reader of the file can see WHAT was baselined, and are sorted for stable
    diffs."""
    entries = sorted(
        ({"fingerprint": f.fingerprint(), "rule_id": f.rule_id,
          "path": f.path, "node": f.node, "message": f.message}
         for f in findings),
        key=lambda e: (e["fingerprint"], e["message"]))
    seen: Set[str] = set()
    unique = [e for e in entries
              if not (e["fingerprint"] in seen or seen.add(e["fingerprint"]))]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "comment":
                   "legacy analyzer findings; new findings gate. "
                   "Refresh: python -m easydist_tpu_torch.analyze "
                   "--refresh-baseline (see README).",
                   "findings": unique}, f, indent=1, sort_keys=True)
        f.write("\n")


# ------------------------------------------------------------------- cache


class ResultCache:
    """Incremental result store: one JSON file per (unit key) under
    `<compile_cache_dir>/analyze/`.  Keys embed the artifact content
    hash AND the rule version, so both an artifact edit and a rule edit
    miss cleanly; stale entries are just dead files."""

    def __init__(self, cache_dir: Optional[str] = None,
                 enabled: bool = True):
        from easydist_tpu_torch import config as edconfig

        self.dir = cache_dir or os.path.join(edconfig.compile_cache_dir,
                                             "analyze")
        self.enabled = enabled
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.json")

    def get(self, key: str) -> Optional[Dict[str, object]]:
        if not self.enabled:
            return None
        try:
            with open(self._path(key), "r", encoding="utf-8") as f:
                payload = json.load(f)
            self.hits += 1
            return payload
        except (OSError, ValueError):
            self.misses += 1
            return None

    def put(self, key: str, payload: Dict[str, object]) -> None:
        if not self.enabled:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._path(key) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, self._path(key))
        except OSError:  # a read-only cache dir must not break analysis
            pass


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:24]


# ----------------------------------------------------------------- targets


def run_ast_target(root: str, cache: ResultCache,
                   rules_ver: str) -> Tuple[List[Finding], int, int]:
    """Layer-11 donation lint + layer-12 concurrency sanitizer over the
    repo, file by file, each file's (post-suppression) result cached on
    its content hash.  Returns (findings, n_files, n_suppressed)."""
    from .alias_rules import lint_file_donation
    from .protocol_rules import lint_file_concurrency

    findings: List[Finding] = []
    n_files = 0
    n_suppressed = 0
    for sub in AST_SUBDIRS:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                try:
                    with open(full, "rb") as f:
                        raw = f.read()
                except OSError:
                    continue
                n_files += 1
                key = f"ast-{_sha(raw + rules_ver.encode())}"
                hit = cache.get(key)
                if hit is not None:
                    findings.extend(finding_from_dict(d)
                                    for d in hit["findings"])
                    n_suppressed += int(hit.get("suppressed", 0))
                    continue
                source = raw.decode("utf-8", errors="replace")
                raw_findings = lint_file_donation(full, rel=rel,
                                                  source=source)
                raw_findings += lint_file_concurrency(full, rel=rel,
                                                      source=source)
                kept, n_sup = apply_suppressions(
                    raw_findings, collect_suppressions(source), rel)
                cache.put(key, {"findings": [finding_to_dict(f)
                                             for f in kept],
                                "suppressed": n_sup})
                findings.extend(kept)
                n_suppressed += n_sup
    return findings, n_files, n_suppressed


def _package_hash(root: str) -> str:
    """Content hash of every .py under easydist_tpu_torch/ — the `presets`
    target's artifact identity (unchanged source => identical compile
    => replay the cached report)."""
    h = hashlib.sha256()
    base = os.path.join(root, "easydist_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                try:
                    with open(full, "rb") as f:
                        h.update(os.path.relpath(full, root).encode())
                        h.update(f.read())
                except OSError:
                    pass
    return h.hexdigest()[:24]


def run_presets_target(root: str, cache: ResultCache, rules_ver: str,
                       device: str = "cuda") -> List[Finding]:
    """Compile the MLP train step (sizes 64-128-64, SGD) on a (4, 2)
    "dp" x "tp" mesh against torch's fake process group of 8 and run the
    `CompileResult.analyze()` stack over it (layers 1, 2, 3a, 10 and 11
    ride the same report: the program lint covers all 8 rank programs).
    Runs on `device`: the card by default, raising
    when no CUDA device answers rather than dropping to the CPU.  Builds
    and destroys its own process group, so the caller must hold none.
    Cached on the package source hash and the device."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("analyze presets: no CUDA device; pass "
                           "device='cpu' (--device cpu) to compile on the "
                           "CPU")
    key = (f"preset-mlp-{device}-"
           f"{_sha((_package_hash(root) + rules_ver).encode())}")
    hit = cache.get(key)
    if hit is not None:
        return [finding_from_dict(d) for d in hit["findings"]]

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.fxfront import (easydist_compile,
                                            make_device_mesh,
                                            set_device_mesh)
    from easydist_tpu_torch.models.mlp import make_mlp_train_step, mlp_init

    if dist.is_initialized():
        raise RuntimeError("analyze presets builds its own fake process "
                           "group; call it with none initialised")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mlp_init(gen, sizes=(64, 128, 64), device=dev)
    x = torch.randn(64, 64, generator=gen, device=dev)
    y = torch.randn(64, 64, generator=gen, device=dev)
    saved = edconfig.discovery_device
    edconfig.discovery_device = dev.type
    dist.init_process_group("fake", rank=0, world_size=8,
                            store=FakeStore())
    try:
        mesh = make_device_mesh((4, 2), ("dp", "tp"), device_type=dev.type)
        compiled = easydist_compile(make_mlp_train_step(lr=0.05),
                                    mesh=mesh, compile_only=True)
        compiled(params, x, y)
        report = compiled.analyze(raise_on_error=False, export=False)
    finally:
        edconfig.discovery_device = saved
        set_device_mesh(None)
        dist.destroy_process_group()
    findings = list(report.findings)
    cache.put(key, {"findings": [finding_to_dict(f) for f in findings]})
    return findings


def run_protocol_target(cache: ResultCache, rules_ver: str,
                        ) -> Tuple[List[Finding],
                                   Dict[str, Dict[str, object]]]:
    """Layer-12a: exhaustively explore the four shipped protocol specs
    (analyze/modelcheck.py) at their committed scope.  Findings are
    PROTO001/002 from the explorer plus one PROTO002-severity-free
    budget check: a spec whose exhaustive state count drifts more than
    BUDGET_DRIFT_FRAC from its committed budget fails loudly (the spec
    changed shape without a conscious re-commit).  Cached on the rule
    version alone — the specs have no other input."""
    from .modelcheck import (ALL_SPECS, BUDGET_DRIFT_FRAC,
                             COMMITTED_STATES, audit_spec)

    key = f"protocol-{_sha(rules_ver.encode())}"
    hit = cache.get(key)
    if hit is not None:
        return ([finding_from_dict(d) for d in hit["findings"]],
                dict(hit["stats"]))

    findings: List[Finding] = []
    stats: Dict[str, Dict[str, object]] = {}
    for spec in ALL_SPECS():
        fs, res = audit_spec(spec)
        findings.extend(fs)
        stats[spec.name] = res.to_json()
        committed = COMMITTED_STATES.get(spec.name)
        if not res.exhausted:
            findings.append(make_finding(
                "PROTO002", f"protocol:{spec.name}",
                f"exploration hit the state ceiling at {res.states} "
                f"states without exhausting — the spec no longer "
                f"terminates at its committed scope"))
        elif committed is not None and abs(res.states - committed) \
                > BUDGET_DRIFT_FRAC * committed:
            findings.append(make_finding(
                "PROTO003", f"protocol:{spec.name}",
                f"exhaustive state count {res.states} drifted more "
                f"than {BUDGET_DRIFT_FRAC:.0%} from the committed "
                f"budget {committed} — re-commit COMMITTED_STATES "
                f"consciously if the spec change is intended"))
    cache.put(key, {"findings": [finding_to_dict(f) for f in findings],
                    "stats": stats})
    return findings, stats


def discovery_counters() -> Dict[str, object]:
    """The latest compile's pruned-discovery telemetry out of the PerfDB
    side-car (runtime/perfdb.py `record_discovery`), for the driver's
    `--json` report.  {} when the side-car is absent/empty — the
    counters are observability, never a gate."""
    try:
        from easydist_tpu_torch.runtime.perfdb import PerfDB, discovery_db_path

        snap = PerfDB(path=discovery_db_path()).snapshot()
        traces = snap.get("discovery", {}).get("traces") or []
        if not traces:
            return {}
        return {"traces": len(traces), "latest": dict(traces[-1])}
    except Exception:
        return {}


# ------------------------------------------------------------------ driver


@dataclass
class DriverResult:
    report: AnalysisReport
    new_errors: List[Finding] = field(default_factory=list)
    baselined: int = 0
    suppressed: int = 0
    skipped: bool = False
    targets: Tuple[str, ...] = ()
    n_files: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    wall_s: float = 0.0
    # per-spec exploration stats from the `protocol` target ({} unless
    # it ran) and the pruned-discovery side-car counters
    protocol: Dict[str, Dict[str, object]] = field(default_factory=dict)
    discovery: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> Dict[str, object]:
        return {
            "skipped": self.skipped,
            "targets": list(self.targets),
            "counts": self.report.counts(),
            "rules": self.report.rule_counts(),
            "new_errors": [finding_to_dict(f) for f in self.new_errors],
            "baselined": self.baselined,
            "suppressed": self.suppressed,
            "n_files": self.n_files,
            "cache": {"hits": self.cache_hits,
                      "misses": self.cache_misses},
            "protocol": self.protocol,
            "discovery": self.discovery,
            "findings": [finding_to_dict(f)
                         for f in self.report.findings],
            "wall_s": round(self.wall_s, 3),
        }


def run_driver(root: str, targets: Iterable[str] = ("ast", "presets"),
               baseline_path: Optional[str] = None,
               use_cache: bool = True,
               cache_dir: Optional[str] = None,
               device: str = "cuda") -> DriverResult:
    """Run the requested targets, apply the baseline, and return the
    aggregated result (`device`: where `presets` compiles).  Never raises
    on findings — the exit decision (gate on `new_errors`) belongs to the
    caller."""
    from easydist_tpu_torch import config as edconfig

    t0 = time.perf_counter()
    targets = tuple(targets)
    if not edconfig.enable_analyze:
        return DriverResult(report=AnalysisReport(), skipped=True,
                            targets=targets,
                            wall_s=time.perf_counter() - t0)
    cache = ResultCache(cache_dir=cache_dir, enabled=use_cache)
    rules_ver = rule_version()
    report = AnalysisReport()
    n_files = 0
    n_suppressed = 0
    protocol_stats: Dict[str, Dict[str, object]] = {}
    for target in targets:
        if target == "ast":
            fs, n_files, n_sup = run_ast_target(root, cache, rules_ver)
            report.extend(fs)
            n_suppressed += n_sup
        elif target == "presets":
            report.extend(run_presets_target(root, cache, rules_ver,
                                             device=device))
        elif target == "protocol":
            fs, protocol_stats = run_protocol_target(cache, rules_ver)
            report.extend(fs)
        else:
            raise ValueError(f"unknown analyze target {target!r} "
                             f"(expected 'ast', 'presets' or "
                             f"'protocol')")
    # stale-baseline audit BEFORE gating: DRV002 entries are warnings,
    # so they report without flipping the exit code
    report.extend(stale_baseline_findings(baseline_path,
                                          report.findings))
    baseline = load_baseline(baseline_path)
    errors = report.errors()
    new_errors = [f for f in errors if f.fingerprint() not in baseline]
    baselined = len(errors) - len(new_errors)
    return DriverResult(report=report, new_errors=new_errors,
                        baselined=baselined, suppressed=n_suppressed,
                        targets=targets, n_files=n_files,
                        cache_hits=cache.hits,
                        cache_misses=cache.misses,
                        wall_s=time.perf_counter() - t0,
                        protocol=protocol_stats,
                        discovery=discovery_counters())


# ------------------------------------------------------------------- SARIF

_SARIF_LEVEL = {"error": "error", "warning": "warning", "info": "note"}


def export_sarif(findings: Iterable[Finding]) -> Dict[str, object]:
    """Minimal SARIF 2.1.0 document over the findings (rule metadata
    from the registry; findings without source coordinates anchor to
    their artifact node in the message only)."""
    findings = list(findings)
    used_rules = sorted({f.rule_id for f in findings})
    results = []
    for f in findings:
        res: Dict[str, object] = {
            "ruleId": f.rule_id,
            "level": _SARIF_LEVEL.get(f.severity, "warning"),
            "message": {"text": f"{f.node}: {f.message}"},
        }
        if f.path:
            res["locations"] = [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": int(f.line or 1)},
                }}]
        results.append(res)
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "easydist-analyze",
                "informationUri":
                    "https://github.com/alibaba/easydist",
                "rules": [{"id": rid,
                           "shortDescription": {"text": RULES[rid][1]},
                           "defaultConfiguration":
                               {"level": _SARIF_LEVEL.get(RULES[rid][0],
                                                          "warning")}}
                          for rid in used_rules],
            }},
            "results": results,
        }],
    }
