"""Structured findings of the port's static analyzer (the port of
easydist_tpu/analyze/findings.py, whole).

Every rule violation the analyzer detects is a `Finding(rule_id, severity,
node, message)`; a pass over one artifact (a solved MetaGraph axis, a
memory plan, a pipeline tick schedule, a fleet log) returns a list of
findings, and `AnalysisReport` aggregates them across passes with PerfDB
export and the raise-on-error gate (`edconfig.analyze_raise` is the
escape hatch).

The rule catalog is the JAX package's, every id with its severity and
layer, the rules of layers the port does not run yet included, so that
ids never change and findings, fingerprints and PerfDB payloads compare
across the two packages.  A rule module emitting an unregistered id is
itself a bug and raises immediately.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

# rule_id -> (default severity, one-line title).  docs/ANALYZE.md mirrors
# this table with the full description + escape hatch per rule.
RULES: Dict[str, tuple] = {
    # ---- layer 1: strategy verifier (solved MetaIR, per mesh axis)
    "STRAT000": (SEV_INFO,
                 "strategy layer skipped (compile-cache hit: no MetaGraph)"),
    "STRAT001": (SEV_ERROR,
                 "consumer expects PARTIAL but producer emits R/S "
                 "(no priced reshard materializes a partial)"),
    "STRAT002": (SEV_ERROR,
                 "S(dim) out of tensor rank or not divisible by the "
                 "mesh-axis size"),
    "STRAT003": (SEV_ERROR,
                 "PARTIAL placement escapes at a graph output"),
    "STRAT004": (SEV_ERROR,
                 "PARTIAL unresolved: rides a non-linear consumer, both "
                 "operands of a bilinear op, or a mismatched reduction"),
    "STRAT005": (SEV_ERROR,
                 "solver objective drift: reported edge-comm cost != "
                 "independent assignment_comm_cost recomputation"),
    # ---- layer 2: collective-program linter (emitted jaxpr / comm plans)
    "COLL000": (SEV_WARNING,
                "program lint skipped (emitted jaxpr unavailable)"),
    "COLL001": (SEV_ERROR,
                "collective names a mesh axis that does not exist"),
    "COLL002": (SEV_ERROR,
                "cond branches disagree on their collective programs "
                "(deadlock shape)"),
    "COLL003": (SEV_ERROR,
                "bucket slices do not tile the flat buffer exactly "
                "(gap/overlap/size mismatch)"),
    "COLL004": (SEV_ERROR,
                "int8 operand fed to an arithmetic reduction collective "
                "(missing the two-pass scale)"),
    "COLL005": (SEV_WARNING,
                "collective inside a while-loop predicate (trip counts may "
                "diverge across devices)"),
    # ---- layer 3a: memory-plan verifier (MemoryPlan over solved MetaIR)
    "MEM000": (SEV_INFO,
               "memory layer skipped (no MetaGraph: compile-cache hit or "
               "single-device mesh)"),
    "MEM001": (SEV_ERROR,
               "memory-plan lifetime drift: an interval disagrees with the "
               "independent producer/last-consumer recomputation"),
    "MEM002": (SEV_ERROR,
               "memory-plan size drift: interval bytes != placement-"
               "divided tensor bytes (element-aligned, shards rounded up)"),
    "MEM003": (SEV_ERROR,
               "skyline unsound: overlapping live offsets, or peak below "
               "the sum-of-live lower bound / packed extent"),
    "MEM004": (SEV_ERROR,
               "predicted per-device peak exceeds the HBM budget "
               "(structured remat advisory attached)"),
    "MEM005": (SEV_ERROR,
               "remat rewrite unsound: non-flat/pure chain equation, "
               "non-lowering rewrite, or missing CSE barrier"),
    # ---- layer 3b: pipeline-schedule verifier (tick schedule tables)
    "SCHED001": (SEV_ERROR,
                 "pipeline schedule deadlock: a unit runs before its "
                 "dependency arrives, is scheduled twice, or never runs"),
    "SCHED002": (SEV_ERROR,
                 "pipeline activation stash over bound: in-flight "
                 "microbatches exceed the residual ring or the 1F1B limit"),
    "SCHED003": (SEV_WARNING,
                 "pipeline bubble fraction above the report threshold"),
    # ---- layer 2b: overlapped-flush verifier (comm/overlap.py plans &
    #      isolated flush programs)
    "OVL001": (SEV_ERROR,
               "emission order is not a permutation of the gradient "
               "leaves (a reordered flush would drop/duplicate leaves)"),
    "OVL002": (SEV_ERROR,
               "overlapped flush chain unpinned: consecutive reducing "
               "collectives have no ordering dependency (the "
               "optimization_barrier token chain is broken)"),
    "OVL003": (SEV_WARNING,
               "predict_comm_overlap is on without a measured overlap "
               "fraction for this backend (discount rests on the flat "
               "config guess)"),
    # ---- layer 4: resilience auditor (guard trace parity + checkpoint
    #      commit-protocol integrity, analyze/resilience_rules.py)
    "RES001": (SEV_ERROR,
               "guard-off trace parity broken: a builder's guard-off "
               "program differs from the pre-guard build (the guard must "
               "be a strict opt-in, bitwise-identical when off)"),
    "RES002": (SEV_ERROR,
               "COMMITTED checkpoint fails manifest verification "
               "(missing/corrupt files — resume from it would poison "
               "training state)"),
    "RES003": (SEV_WARNING,
               "stale uncommitted checkpoint debris (dead .tmp_* write "
               "dirs or superseded torn step_N dirs awaiting GC)"),
    # ---- layer 5: serving auditor (decode-step cache donation,
    #      analyze/serve_rules.py)
    "SERVE001": (SEV_WARNING,
                 "decode-step KV cache input not donated (every token "
                 "pays a full-cache HBM copy instead of an in-place "
                 "XLA update)"),
    "SERVE002": (SEV_ERROR,
                 "chunked-prefill contract broken: staging cache not "
                 "donated (warning), attention window not length-masked "
                 "(stale-row leakage — restored/garbage cache rows could "
                 "leak into live logits), or prefix-trie refcount/byte "
                 "accounting drift"),
    "SERVE003": (SEV_ERROR,
                 "speculative rewind contract broken: verify step not "
                 "length-masked past the committed positions (warning "
                 "for non-donated cache), accepted-prefix bookkeeping "
                 "advanced past the first draft/target mismatch (output "
                 "would diverge from plain greedy), or a paged rollback "
                 "left a table row pointing at a released page"),
    # ---- layer 7: paged-KV auditor (page-table/refcount consistency,
    #      analyze/kv_rules.py)
    "KV001": (SEV_ERROR,
              "paged-KV bookkeeping broken: a table entry points at a "
              "freed page, a page has more holders (table rows + trie "
              "refs) than its refcount, or the pool/table invariants "
              "(double free, leaked page, byte conservation, hole in a "
              "row's live prefix) fail — attention would read or the "
              "allocator would reuse another sequence's K/V, "
              "bitwise-silently"),
    # ---- layer 6: fleet auditor (multi-replica routing / KV handoff /
    #      drain hygiene, analyze/fleet_rules.py)
    "FLEET001": (SEV_ERROR,
                 "request routed to an ineligible replica (circuit "
                 "breaker OPEN or already draining) — load steered into "
                 "a replica that is shedding or leaving"),
    "FLEET002": (SEV_ERROR,
                 "KV page handoff fails manifest verification (token "
                 "ids, sha256, or byte count disagree) — a corrupt page "
                 "committed to a live trie poisons every request "
                 "sharing that prefix, bitwise-silently"),
    "FLEET003": (SEV_WARNING,
                 "drained replica's trie still holds pinned pages "
                 "(pin/unpin imbalance): unevictable orphans keep device "
                 "memory from releasing"),
    "FLEET004": (SEV_ERROR,
                 "request dispatched to a replica the health monitor had "
                 "marked DEAD — the router's eligibility filter must "
                 "exclude dead replicas exactly like OPEN breakers; the "
                 "request would strand on a corpse"),
    "FLEET005": (SEV_ERROR,
                 "resume descriptor inconsistent with its original "
                 "request (resubmitted prefix != prompt + emitted ids, "
                 "budget overrun, or eos already emitted) — recovery "
                 "would silently change output tokens"),
    # ---- layer 8: redistribution auditor (reshard plans + restored
    #      shardings, analyze/reshard_rules.py)
    "RESHARD001": (SEV_ERROR,
                   "redistribution plan peak live bytes exceed the "
                   "chunked bound O(max(src_shard, dst_shard) + chunk) — "
                   "the plan silently degenerated toward global "
                   "materialization, the replicated-restore OOM hazard "
                   "the reshard substrate exists to remove"),
    "RESHARD002": (SEV_ERROR,
                   "restored leaf sharding disagrees with the template "
                   "spec — the caller's jit will silently re-lay-out "
                   "(or OOM re-gathering) every step, and a replicated "
                   "leaf that should be sharded holds n_devices x its "
                   "byte budget"),
    # ---- layer 9: simulator/autoscaler auditor (prediction fidelity +
    #      control-loop stability, analyze/sim_rules.py)
    "SIM001": (SEV_ERROR,
               "simulator prediction drifted beyond the committed "
               "relative-error bound against a measured bench actual — "
               "the capacity planner and autoscaler are steering the "
               "fleet on numbers the hardware no longer agrees with "
               "(stale calibration, an uncalibrated residual domain, or "
               "a cost-model regression)"),
    "SIM002": (SEV_ERROR,
               "autoscaler flap: opposite-direction scale actuations "
               "inside the hysteresis window (an A-B-A oscillation) — "
               "each reversal pays a drain + page-migration + spin-up "
               "round trip for zero steady-state change, so the "
               "confirm/cooldown gates are mis-tuned or bypassed"),
    # ---- layer 10: pruned-discovery auditor (propagation-group and
    #      cache transfers, analyze/discovery_rules.py)
    "DISC001": (SEV_ERROR,
                "propagation-group member shapes are incompatible with "
                "the instantiated representative rule (row/rank mismatch, "
                "halo wider than a member shard, or a size-sensitive rule "
                "transferred across shapes) — the pruner reused a rule "
                "the member could not have discovered"),
    "DISC002": (SEV_WARNING,
                "execution discovery fired for a primitive that has an "
                "analytic preset — the preset declined this instance, so "
                "the compile pays the probe harness for an op the preset "
                "bank claims to cover"),
    # ---- layer 11: donation/aliasing sanitizer (analyze/alias_rules.py)
    "ALIAS001": (SEV_ERROR,
                 "donated invar used after its consuming dispatch: a "
                 "later equation (or the program output) reads a buffer "
                 "XLA is free to overwrite in place — bitwise-correct on "
                 "CPU (donation ignored) and silently corrupt on TPU"),
    "ALIAS002": (SEV_ERROR,
                 "double donation: two donated invars alias one "
                 "underlying buffer (or one output claims two donated "
                 "inputs) — XLA reuses the storage twice and one write "
                 "clobbers the other"),
    "ALIAS003": (SEV_ERROR,
                 "donation declared but unhonorable: the donated input "
                 "matches no output's shape/dtype/sharding, so XLA "
                 "silently copies instead of updating in place — the "
                 "in-place win the donation was written for never "
                 "happens"),
    "ALIAS004": (SEV_ERROR,
                 "donated device buffer reachable from a live host "
                 "reference across a step boundary (snapshot, hot-page "
                 "export, trie-held staging row): the next donating "
                 "dispatch invalidates storage the host still reads"),
    # ---- layer 12: fleet protocol model checker + concurrency
    #      sanitizer (analyze/modelcheck.py + analyze/protocol_rules.py)
    "PROTO001": (SEV_ERROR,
                 "protocol safety violation: exhaustive small-scope "
                 "exploration reached a state that drops an admitted "
                 "request, commits the same token position twice, or "
                 "accepts a corrupt chunk — the shortest counterexample "
                 "interleaving is attached"),
    "PROTO002": (SEV_ERROR,
                 "protocol stuck state: a reachable state has no path to "
                 "the goal (no enabled action, or a livelock cycle) — an "
                 "admitted request would wait forever instead of "
                 "completing, failing, or quarantining loudly"),
    "PROTO003": (SEV_ERROR,
                 "spec drift: a transition observed in a real drill "
                 "event log is not admitted by the protocol spec — "
                 "either the implementation grew a behavior the model "
                 "checker never explores, or the spec rotted into "
                 "parallel documentation"),
    "PROTO004": (SEV_ERROR,
                 "private fleet state read from outside the owning "
                 "class: observer/metrics code reaches into a router/"
                 "replica/monitor's underscore attributes instead of a "
                 "snapshot API — a data race the moment replicas live "
                 "in another process"),
    "PROTO005": (SEV_ERROR,
                 "shared fleet structure mutated outside the owning "
                 "class's methods: external writes to rings, in-flight "
                 "tables, or commit maps bypass the single-writer "
                 "protocol the model checker verifies"),
    # ---- layer 13: quantized/tiered KV sanitizer
    #      (analyze/kv_quant_rules.py)
    "KVQ001": (SEV_ERROR,
               "quantized arena desync: scale arena missing/mis-shaped "
               "for its int8 payload (or scales present over a "
               "non-quantized payload) — dequantized K/V would be "
               "garbage at exactly the pages the shapes disagree on, "
               "bitwise-silently"),
    "KVQ002": (SEV_ERROR,
               "quantized decode program feeds int8 K/V into a "
               "dot_general without dequantizing (no int8->float "
               "convert/scale multiply on the operand path) — logits "
               "would be computed on raw quantized codes, off by the "
               "per-block scale"),
    "KVQ003": (SEV_ERROR,
               "host-tier round-trip integrity broken: a tier entry's "
               "stored bytes disagree with its sha256 manifest, or the "
               "tier's byte accounting drifted from its entries — "
               "promotion would serve corrupt K/V (or the budget gate "
               "lies)"),
    # ---- analyzer driver (analyze/driver.py)
    "DRV001": (SEV_WARNING,
               "unused inline suppression: an `# easydist: disable=...` "
               "comment names a rule that produced no finding on that "
               "line — stale suppressions hide future regressions"),
    "DRV002": (SEV_WARNING,
               "stale baseline entry: analyze_baseline.json carries a "
               "fingerprint matching no current finding — the debt was "
               "paid (or the code moved); `--refresh-baseline` prunes it"),
}

# layer index: (layer label, ordering key, rule-id prefixes, escape hatch).
# docs/ANALYZE.md's per-rule index table is generated from RULES + this
# table (tests/test_analyze/test_docs_drift.py keeps them in sync).
KILL_SWITCH = "EASYDIST_ANALYZE=0"
RAISE_SWITCH = "EASYDIST_ANALYZE_RAISE=0"

LAYERS: List[tuple] = [
    ("1 strategy", ("STRAT",)),
    ("2 collectives", ("COLL",)),
    ("2b overlap", ("OVL",)),
    ("3a memory", ("MEM",)),
    ("3b schedule", ("SCHED",)),
    ("4 resilience", ("RES",)),
    ("5 serving", ("SERVE",)),
    ("6 fleet", ("FLEET",)),
    ("7 paged KV", ("KV",)),
    ("8 reshard", ("RESHARD",)),
    ("9 simulator", ("SIM",)),
    ("10 discovery", ("DISC",)),
    ("11 aliasing", ("ALIAS",)),
    ("12 protocol", ("PROTO",)),
    ("13 kv quant", ("KVQ",)),
    ("driver", ("DRV",)),
]


def layer_of(rule_id: str) -> str:
    """Layer label for a rule id (longest matching registered prefix)."""
    best = ""
    label = "?"
    for name, prefixes in LAYERS:
        for p in prefixes:
            if rule_id.startswith(p) and len(p) > len(best):
                best, label = p, name
    return label


def rule_index_rows() -> List[tuple]:
    """(layer, rule_id, severity, escape hatch) rows for every registered
    rule, in catalog order — the docs/ANALYZE.md index table's source."""
    rows = []
    for rule_id, (sev, _title) in RULES.items():
        hatch = KILL_SWITCH if sev != SEV_ERROR else (
            f"{KILL_SWITCH} / {RAISE_SWITCH}")
        rows.append((layer_of(rule_id), rule_id, sev, hatch))
    return rows


@dataclass(frozen=True)
class Finding:
    """One rule violation at one graph/jaxpr location.  `path`/`line`
    are optional source coordinates (the AST lint and the driver's
    suppression/SARIF machinery use them; artifact-level rules leave
    them unset)."""

    rule_id: str
    severity: str
    node: str
    message: str
    path: Optional[str] = None
    line: Optional[int] = None

    def __post_init__(self):
        if self.rule_id not in RULES:
            raise ValueError(f"unregistered analyzer rule id {self.rule_id!r}")
        if self.severity not in (SEV_ERROR, SEV_WARNING, SEV_INFO):
            raise ValueError(f"bad severity {self.severity!r}")

    def __str__(self) -> str:
        where = f"{self.path}:{self.line}: " if self.path else ""
        return (f"[{self.rule_id}:{self.severity}] {where}{self.node}: "
                f"{self.message}")

    def fingerprint(self) -> str:
        """Stable identity for baselining: rule + location + node.  The
        message is EXCLUDED so a reworded diagnostic doesn't churn the
        baseline, and the line number is excluded so unrelated edits
        above a legacy finding don't un-baseline it."""
        return f"{self.rule_id}|{self.path or ''}|{self.node}"


def make_finding(rule_id: str, node: str, message: str,
                 severity: Optional[str] = None,
                 path: Optional[str] = None,
                 line: Optional[int] = None) -> Finding:
    """Finding with the rule's registered default severity."""
    return Finding(rule_id, severity or RULES[rule_id][0], node, message,
                   path=path, line=line)


class AnalysisError(RuntimeError):
    """Raised when a report carries error-severity findings and raising is
    enabled (`edconfig.analyze_raise`, EASYDIST_ANALYZE_RAISE=0 to opt out)."""

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        errors = report.errors()
        lines = "\n  ".join(str(f) for f in errors[:20])
        more = f"\n  ... and {len(errors) - 20} more" if len(errors) > 20 else ""
        super().__init__(
            f"static analysis found {len(errors)} error-severity finding(s) "
            f"(set EASYDIST_ANALYZE_RAISE=0 to demote to logging):\n  "
            f"{lines}{more}")


class AnalysisReport:
    """Aggregated findings of one analyze() run."""

    def __init__(self, findings: Iterable[Finding] = ()):
        self.findings: List[Finding] = list(findings)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARNING]

    def counts(self) -> Dict[str, int]:
        out = {SEV_ERROR: 0, SEV_WARNING: 0, SEV_INFO: 0}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def rule_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule_id] = out.get(f.rule_id, 0) + 1
        return out

    def summary(self) -> str:
        c = self.counts()
        head = (f"analyze: {c[SEV_ERROR]} error(s), {c[SEV_WARNING]} "
                f"warning(s), {c[SEV_INFO]} info")
        if not self.findings:
            return head + " — clean"
        return head + "\n" + "\n".join(f"  {f}" for f in self.findings)

    def raise_on_errors(self) -> "AnalysisReport":
        """Raise AnalysisError if any error-severity finding; returns self
        otherwise (chaining).  Callers gate on `edconfig.analyze_raise`."""
        if self.errors():
            raise AnalysisError(self)
        return self

    def export_to_perfdb(self, sub_key: str = "analyze",
                         db: Optional[object] = None) -> Dict[str, object]:
        """Persist counts + findings under ("analyze_stats", sub_key) so the
        lint evidence lands next to step times and comm_stats."""
        from easydist_tpu_torch.runtime.perfdb import PerfDB

        payload: Dict[str, object] = {
            "counts": self.counts(),
            "rules": self.rule_counts(),
            # cap the stored detail: the counts are the gate, the first
            # findings are the debugging breadcrumb — findings_truncated
            # records how many fell off the cap so a capped export can't
            # masquerade as the full list
            "findings": [(f.rule_id, f.severity, f.node, f.message)
                         for f in self.findings[:50]],
            "findings_truncated": max(0, len(self.findings) - 50),
        }
        # an empty PerfDB is falsy (it defines __len__): test for None
        if db is None:
            db = PerfDB()
        db.record_op_perf("analyze_stats", sub_key, payload)
        try:
            db.persist()
        except Exception:  # a read-only DB path must not break analysis
            pass
        return payload
