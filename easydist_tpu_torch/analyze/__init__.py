"""`easydist_tpu_torch.analyze`: the port's static analyzer (the port of
easydist_tpu/analyze/, its layers that read no jaxpr).

A rule-based analyzer that runs after solving and before execution, and
at the fleet's and the pipelines' natural checkpoints:

  layer 1  strategy verifier over solved MetaIR (`verify_axis`,
           `audit_solver_objective`) — placement typing, S-dim validity,
           PARTIAL resolution, solver objective audit; run by
           `fxfront.api.solve_axes` after every per-axis solve;
  layer 3a memory-plan verifier (`verify_memory_plan`, `check_hbm_budget`,
           `audit_remat_plan`) — independent liveness/sizing audit of the
           graph memory plan, skyline soundness, the MEM004 budget gate
           against the card's memory with its remat advisory, and the
           remat-rewrite audit; run by `CompileResult.analyze()`;
  layer 3b pipeline-schedule verifier (`verify_schedule_tables`) —
           deadlock, stash-bound and bubble checks over every tick table
           `parallel.pipeline.schedule_tables` builds;
  layer 6  fleet auditor (`audit_routing`, `audit_page_handoff`,
           `audit_drained_session`, `audit_resume`) — FLEET001/004 on
           every routing decision, FLEET002 on every KV page handoff
           before it commits, FLEET003 after every drain, FLEET005 before
           every resubmit (`fleet/router.py`, `fleet/transport.py`);
  layer 7  paged-KV auditor (`audit_page_table`, KV001), which
           `kv.audit_page_table` wraps for the session;
  layer 9  simulator/autoscaler auditor (`audit_prediction`,
           `audit_scale_decisions`) — SIM001 a prediction beyond
           `sim.simulate.SIM_REL_ERROR_BOUND`, SIM002 an autoscaler flap;
  layer 10 pruned-discovery auditor (`audit_rule_transfer`) — DISC001 a
           group or cache transfer the member's shapes cannot carry, run
           at the end of every trace; DISC002 a declined preset;
  layer 11 the donation lint's host form (`lint_host_donation`,
           `lint_file_donation`, ALIAS001 over source files);
  layer 12 fleet protocol model checker and concurrency sanitizer
           (`explore`, `audit_spec`, `check_protocol_specs`,
           `check_protocol_conformance`, `lint_host_concurrency`) —
           PROTO001/002 over the four specs, PROTO003 replaying the
           live components' `transitions()`, PROTO004/005 over source.

Not ported yet (ROADMAP queue A, 9b): the lints that read a traced
program (the JAX package's layer 2 collectives, 2b overlap, 4
resilience, 5 serving, 8 reshard, 11's program form and 13 quantized
KV) and their hooks.

Surfaced via `CompiledFunction.analyze()` and the driver (`python -m
easydist_tpu_torch.analyze`: inline suppressions, the committed
`analyze_baseline_torch.json`, SARIF / JSON export, a result cache);
findings export through the runtime PerfDB under
`("analyze_stats", <sub_key>)`.  Error-severity findings raise by
default (`EASYDIST_ANALYZE_RAISE=0` demotes them to logging;
`EASYDIST_ANALYZE=0` skips every layer).  Rule ids, severities, layers
and fingerprints are the JAX package's, so findings compare across the
two packages.
"""

from __future__ import annotations

import logging

from .alias_rules import lint_file_donation, lint_host_donation
from .discovery_rules import audit_rule_transfer
from .findings import (LAYERS, RULES, SEV_INFO, AnalysisError,
                       AnalysisReport, Finding, layer_of, make_finding,
                       rule_index_rows)
from .fleet_rules import (audit_drained_session, audit_page_handoff,
                          audit_resume, audit_routing)
from .kv_rules import audit_page_table
from .memory_rules import (audit_remat_plan, check_hbm_budget,
                           recompute_liveness, remat_advisory,
                           resolve_hbm_budget, verify_memory_plan)
from .modelcheck import (ALL_SPECS, COMMITTED_STATES, HealthSpec,
                         ResumeSpec, RouterSpec, Spec, TransportSpec,
                         audit_spec, explore, replay_health_events,
                         replay_restore_attempts, replay_router_protocol,
                         replay_transport_commits)
from .protocol_rules import lint_file_concurrency, lint_host_concurrency
from .schedule_rules import (gpipe_schedule_tables, schedule_stats,
                             verify_schedule_tables)
from .sim_rules import audit_prediction, audit_scale_decisions
from .strategy_rules import audit_solver_objective, verify_axis

logger = logging.getLogger(__name__)

__all__ = [
    "RULES", "AnalysisError", "AnalysisReport", "Finding", "make_finding",
    "LAYERS", "layer_of", "rule_index_rows",
    "audit_solver_objective", "verify_axis",
    "verify_memory_plan", "check_hbm_budget", "audit_remat_plan",
    "recompute_liveness", "remat_advisory", "resolve_hbm_budget",
    "verify_schedule_tables", "gpipe_schedule_tables", "schedule_stats",
    "check_schedule_tables",
    "audit_routing", "audit_page_handoff", "audit_drained_session",
    "audit_resume",
    "check_fleet_routing", "check_page_handoff", "check_fleet_drain",
    "check_resume_descriptor",
    "audit_page_table", "check_page_table",
    "audit_prediction", "audit_scale_decisions",
    "check_sim_prediction", "check_sim_autoscale",
    "audit_rule_transfer",
    "lint_host_donation", "lint_file_donation",
    "Spec", "HealthSpec", "RouterSpec", "ResumeSpec", "TransportSpec",
    "ALL_SPECS", "COMMITTED_STATES", "explore", "audit_spec",
    "replay_health_events", "replay_router_protocol",
    "replay_transport_commits", "replay_restore_attempts",
    "lint_file_concurrency", "lint_host_concurrency",
    "check_protocol_specs", "check_protocol_conformance",
]


def _enabled() -> bool:
    """The layer kill switch (EASYDIST_ANALYZE=0): every check_* hook
    returns empty without computing anything when analysis is off."""
    from easydist_tpu_torch import config as edconfig

    return edconfig.enable_analyze


def _gate(findings, raise_errors: bool = True):
    """Raise AnalysisError on error findings under `analyze_raise` (when
    `raise_errors`), log the rest; returns the findings."""
    from easydist_tpu_torch import config as edconfig

    report = AnalysisReport(findings)
    if raise_errors and report.errors() and edconfig.analyze_raise:
        report.raise_on_errors()
    for f in findings:
        logger.log(logging.INFO if f.severity == SEV_INFO
                   else logging.WARNING, "[analyze] %s", f)
    return findings


def check_schedule_tables(tables, n_stages: int, n_virtual: int,
                          n_microbatches: int, fwd_only: bool = False,
                          node: str = "pipeline",
                          stash_bound: bool = True):
    """Build-time self-check hook of `parallel.pipeline.schedule_tables`:
    verify the tick tables and raise (or log, with the escape hatch) on
    error findings; the SCHED003 bubble report only logs.  Returns the
    findings."""
    if not _enabled():
        return []
    return _gate(verify_schedule_tables(
        tables, n_stages, n_virtual, n_microbatches, fwd_only=fwd_only,
        node=node, stash_bound=stash_bound))


def check_page_table(pool, table, trie=None, node: str = "kv"):
    """KV001 over a live (pool, table[, trie]) triple, raising (or
    logging) on error findings — serving on corrupt page accounting
    reads or frees another sequence's K/V.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_page_table(pool, table, trie=trie, node=node))


def check_fleet_routing(decisions, node: str = "fleet"):
    """FLEET001/004 over router decisions (routed to a tripped-breaker,
    draining or DEAD replica); raises under `analyze_raise`.  Returns the
    findings."""
    if not _enabled():
        return []
    return _gate(audit_routing(decisions, node=node))


def check_page_handoff(manifest, path, node: str = "handoff"):
    """Transfer-time hook of `fleet.transport`: FLEET002 (payload
    disagrees with the sha256 manifest) raises under `analyze_raise` —
    committing a corrupt page poisons every request sharing the prefix.
    Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_page_handoff(manifest, path, node=node))


def check_fleet_drain(session, node: str = "drain"):
    """Drain-time hook of the fleet router: FLEET003 (orphaned pinned
    pages, trie bookkeeping drift on a drained session) — warning
    severity, logs and returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_drained_session(session, node=node),
                 raise_errors=False)


def check_resume_descriptor(descriptor, resume_prompt=None,
                            node: str = "resume"):
    """Resume-time hook of the fleet failover path: FLEET005 (the
    descriptor disagrees with its request) raises under `analyze_raise`
    BEFORE the resubmit.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_resume(descriptor, resume_prompt, node=node))


def check_sim_prediction(rows, bound=None, node: str = "sim"):
    """SIM001 over validation rows (a relative error beyond the bound)
    raises under `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_prediction(rows, bound=bound, node=node))


def check_sim_autoscale(decisions, window=None, node: str = "autoscale"):
    """SIM002 over an autoscaler's decision log (opposite actuations
    inside the hysteresis window) raises under `analyze_raise`.  Returns
    the findings."""
    if not _enabled():
        return []
    return _gate(audit_scale_decisions(decisions, window=window, node=node))


def check_protocol_specs(specs=None, max_states: int = None,
                         node: str = None):
    """Layer-12a hook: explore the protocol specs (default: the four
    fleet protocols at committed scope) and turn violations into
    findings — PROTO001 with the shortest counterexample, PROTO002 a
    stuck state.  Error findings raise under `analyze_raise`; returns
    the findings."""
    if not _enabled():
        return []
    from .modelcheck import MAX_STATES_DEFAULT

    findings = []
    for spec in (specs if specs is not None else ALL_SPECS()):
        fs, _res = audit_spec(spec, node=node,
                              max_states=max_states or MAX_STATES_DEFAULT)
        findings.extend(fs)
    return _gate(findings)


def check_protocol_conformance(router=None, health=None, transport=None,
                               restore_attempts=None, node: str = "drill"):
    """Layer-12b hook: replay live components' recorded `transitions()`
    streams (and an elastic restore's attempt trail) through the spec
    automata — PROTO003 on any event the spec does not admit.  Error
    findings raise under `analyze_raise`; returns the findings."""
    if not _enabled():
        return []
    findings = []
    if router is not None:
        findings.extend(replay_router_protocol(
            router.transitions(), node=f"{node}:router"))
    if health is not None:
        findings.extend(replay_health_events(
            health.transitions(), node=f"{node}:health"))
    if transport is not None:
        findings.extend(replay_transport_commits(
            transport.transitions(), node=f"{node}:transport"))
    if restore_attempts is not None:
        findings.extend(replay_restore_attempts(
            restore_attempts, node=f"{node}:restore"))
    return _gate(findings)
