"""`easydist_tpu_torch.analyze`: the port's static analyzer (the port of
easydist_tpu/analyze/; its lints over traced jaxprs read `make_fx`
programs here).

A rule-based analyzer that runs after solving and before execution, and
at the fleet's and the pipelines' natural checkpoints:

  layer 1  strategy verifier over solved MetaIR (`verify_axis`,
           `audit_solver_objective`) — placement typing, S-dim validity,
           PARTIAL resolution, solver objective audit; run by
           `fxfront.api.solve_axes` after every per-axis solve;
  layer 2  collective-program linter over FX programs (`lint_program`,
           `lint_rank_programs`, `lint_bucket_plan`) — COLL001/004 over a
           rank program, COLL002 across every rank's program of a mesh,
           COLL003 over every bucket plan (`comm.bucketer`); run by
           `CompileResult.analyze(include_program=True)`;
  layer 2b overlapped-flush verifier (`lint_overlap_plan`,
           `lint_issue_log`) — OVL001 before the flush's fallback,
           OVL002 over the hooked flush's issue log (`comm.overlap`);
  layer 3a memory-plan verifier (`verify_memory_plan`, `check_hbm_budget`,
           `audit_remat_plan`) — independent liveness/sizing audit of the
           graph memory plan, skyline soundness, the MEM004 budget gate
           against the card's memory with its remat advisory, and the
           remat-rewrite audit; run by `CompileResult.analyze()`;
  layer 3b pipeline-schedule verifier (`verify_schedule_tables`) —
           deadlock, stash-bound and bubble checks over every tick table
           `parallel.pipeline.schedule_tables` builds;
  layer 4  resilience auditor (`audit_guard_parity`,
           `audit_checkpoint_root`) — RES001 guard-off trace identity,
           RES002/003 the checkpoint commit protocol;
  layer 5  serving auditor (`audit_decode_donation`,
           `audit_chunked_prefill`, `audit_speculative_rewind`,
           `audit_prefix_cache`) — SERVE001-003, run by the session once
           per compiled signature and at each commit / rollback;
  layer 6  fleet auditor (`audit_routing`, `audit_page_handoff`,
           `audit_drained_session`, `audit_resume`) — FLEET001/004 on
           every routing decision, FLEET002 on every KV page handoff
           before it commits, FLEET003 after every drain, FLEET005 before
           every resubmit (`fleet/router.py`, `fleet/transport.py`);
  layer 7  paged-KV auditor (`audit_page_table`, KV001), which
           `kv.audit_page_table` wraps for the session;
  layer 8  redistribution auditor (`audit_reshard_plan`,
           `audit_restored_state`) — RESHARD001 before bytes move
           (`reshard.exec`, the restore), RESHARD002 after a restore;
  layer 9  simulator/autoscaler auditor (`audit_prediction`,
           `audit_scale_decisions`) — SIM001 a prediction beyond
           `sim.simulate.SIM_REL_ERROR_BOUND`, SIM002 an autoscaler flap;
  layer 10 pruned-discovery auditor (`audit_rule_transfer`) — DISC001 a
           group or cache transfer the member's shapes cannot carry, run
           at the end of every trace; DISC002 a declined preset;
  layer 11 the donation/aliasing sanitizer (`audit_program_aliases`,
           `audit_donation_pairs`, `audit_host_aliases`,
           `lint_host_donation`) — ALIAS001-003 over a compiled program
           and its state pairs, ALIAS004 at the session's step boundary,
           ALIAS001 over source files;
  layer 12 fleet protocol model checker and concurrency sanitizer
           (`explore`, `audit_spec`, `check_protocol_specs`,
           `check_protocol_conformance`, `lint_host_concurrency`) —
           PROTO001/002 over the four specs, PROTO003 replaying the
           live components' `transitions()`, PROTO004/005 over source;
  layer 13 quantized / tiered KV sanitizer (`audit_quant_arena`,
           `audit_quant_program`, `audit_tier_roundtrip`) — KVQ001-003 at
           the session's page-table audits.

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

from .alias_rules import (audit_donation_pairs, audit_host_aliases,
                          audit_program_aliases, lint_file_donation,
                          lint_host_donation)
from .discovery_rules import audit_rule_transfer
from .findings import (LAYERS, RULES, SEV_INFO, AnalysisError,
                       AnalysisReport, Finding, layer_of, make_finding,
                       rule_index_rows)
from .fleet_rules import (audit_drained_session, audit_page_handoff,
                          audit_resume, audit_routing)
from .fx_rules import (lint_bucket_plan, lint_compiled, lint_fn,
                       lint_program, lint_rank_programs)
from .kv_quant_rules import (audit_quant_arena, audit_quant_program,
                             audit_tier_roundtrip)
from .kv_rules import audit_page_table
from .memory_rules import (audit_remat_plan, check_hbm_budget,
                           recompute_liveness, remat_advisory,
                           resolve_hbm_budget, verify_memory_plan)
from .modelcheck import (ALL_SPECS, COMMITTED_STATES, HealthSpec,
                         ResumeSpec, RouterSpec, Spec, TransportSpec,
                         audit_spec, explore, replay_health_events,
                         replay_restore_attempts, replay_router_protocol,
                         replay_transport_commits)
from .overlap_rules import lint_issue_log, lint_overlap_fn, lint_overlap_plan
from .protocol_rules import lint_file_concurrency, lint_host_concurrency
from .reshard_rules import audit_reshard_plan, audit_restored_state
from .resilience_rules import audit_checkpoint_root, audit_guard_parity
from .serve_rules import (audit_chunked_prefill, audit_decode_donation,
                          audit_prefix_cache, audit_speculative_rewind)
from .schedule_rules import (gpipe_schedule_tables, schedule_stats,
                             verify_schedule_tables)
from .sim_rules import audit_prediction, audit_scale_decisions
from .strategy_rules import audit_solver_objective, verify_axis

logger = logging.getLogger(__name__)

__all__ = [
    "hook_tally", "reset_hook_tally",
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
    "lint_program", "lint_rank_programs", "lint_compiled", "lint_fn",
    "lint_bucket_plan", "check_bucket_plan",
    "lint_overlap_plan", "lint_issue_log", "lint_overlap_fn",
    "check_overlap_plan", "check_issue_log",
    "audit_guard_parity", "audit_checkpoint_root",
    "audit_decode_donation", "audit_chunked_prefill",
    "audit_speculative_rewind", "audit_prefix_cache",
    "check_decode_donation", "check_chunked_prefill",
    "check_speculative_rewind", "check_prefix_cache",
    "audit_quant_arena", "audit_quant_program", "audit_tier_roundtrip",
    "check_quant_arena", "check_quant_program", "check_tier_roundtrip",
    "audit_reshard_plan", "audit_restored_state",
    "check_reshard_plan", "check_restored_state",
    "audit_program_aliases", "audit_donation_pairs", "audit_host_aliases",
    "check_donation_pairs", "check_host_aliases",
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


# process-wide count of hook runs and their findings, by rule family
# (`hook_tally`); a hook that returns early (analysis off) counts nothing
_TALLY: dict = {}


def hook_tally() -> dict:
    """{rule: {"runs": n, "findings": n}} of the hooks run since the last
    `reset_hook_tally()` (the rule a hook is named by: SERVE001,
    SERVE002, SERVE003, KVQ001-003, ALIAS004, COLL003, OVL001, OVL002,
    RESHARD001-002)."""
    return {k: dict(v) for k, v in _TALLY.items()}


def reset_hook_tally() -> None:
    _TALLY.clear()


def _gate(findings, raise_errors: bool = True, rule: str = None):
    """Count the hook run under `rule`, raise AnalysisError on error
    findings under `analyze_raise` (when `raise_errors`), log the rest;
    returns the findings."""
    from easydist_tpu_torch import config as edconfig

    if rule is not None:
        row = _TALLY.setdefault(rule, {"runs": 0, "findings": 0})
        row["runs"] += 1
        row["findings"] += len(findings)
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


def check_bucket_plan(leaves, buckets):
    """COLL003 hook of `comm.bucketer.bucketed_reduce`: a plan whose
    slices do not tile the flat buffer silently corrupts gradients at
    unpack; raises under `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(lint_bucket_plan(leaves, buckets), rule="COLL003")


def check_overlap_plan(leaves, order, buckets=None):
    """OVL001 (and COLL003 over the reordered plan) hook of
    `comm.overlap`, run before its fallback to flat order: a bad emission
    order raises under `analyze_raise`.  `leaves` are the ORDERED leaves
    when `buckets` is given.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(lint_overlap_plan(leaves, order, buckets), rule="OVL001")


def check_issue_log(log, node: str = "overlap"):
    """OVL002 hook of the hooked flush (`comm.overlap._hooked_grads`
    with `pin_chain`): the units must be issued once each, in the plan's
    order.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(lint_issue_log(log, node=node), rule="OVL002")


def check_decode_donation(result, cache_arg: int = 0,
                          node: str = "decode"):
    """SERVE001 hook of `serve.generation` (warning: a cache that is not
    written in place is slow, not wrong; logs, never raises).  Returns
    the findings."""
    if not _enabled():
        return []
    return _gate(audit_decode_donation(result, cache_arg=cache_arg,
                                       node=node),
                 raise_errors=False, rule="SERVE001")


def check_chunked_prefill(result, cache_arg: int = 0,
                          node: str = "prefill_chunk"):
    """SERVE002 hook of the chunked-prefill scheduler: staging written in
    place (warning) and the length mask (error, raises under
    `analyze_raise`).  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_chunked_prefill(result, cache_arg=cache_arg,
                                       node=node), rule="SERVE002")


def check_speculative_rewind(result=None, *, cache_arg: int = 0,
                             node: str = "verify", draft=None,
                             target=None, n_accepted=None, pool=None,
                             table=None, trie=None):
    """SERVE003 hook of speculative decoding, at each artifact's
    checkpoint: the compiled verify step once per signature, the accept
    walk every commit, the page table after every rollback that released
    pages.  Error findings raise under `analyze_raise`.  Returns the
    findings."""
    if not _enabled():
        return []
    return _gate(audit_speculative_rewind(
        result, cache_arg=cache_arg, node=node, draft=draft,
        target=target, n_accepted=n_accepted, pool=pool, table=table,
        trie=trie), rule="SERVE003")


def check_prefix_cache(trie, node: str = "prefix_cache"):
    """SERVE002 hook over the prefix trie's refcount / byte accounting;
    drift raises under `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_prefix_cache(trie, node=node), rule="SERVE002")


def check_quant_arena(arena, node: str = "kv.quant"):
    """KVQ001 hook over a quantized arena's payload / scale structure;
    raises under `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_quant_arena(arena, node=node), rule="KVQ001")


def check_quant_program(result, node: str = "decode.quant"):
    """KVQ002 hook over a compiled quant step (int8 reaching a matmul);
    raises under `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_quant_program(result, node=node), rule="KVQ002")


def check_tier_roundtrip(tier, node: str = "kv.tier"):
    """KVQ003 hook over the host tier's manifests and byte accounting;
    raises under `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_tier_roundtrip(tier, node=node), rule="KVQ003")


def check_reshard_plan(plan, node: str = "reshard"):
    """RESHARD001 hook, run BEFORE any byte moves (`reshard.exec`, the
    restore): a plan over its chunked bound raises under
    `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_reshard_plan(plan, node=node), rule="RESHARD001")


def check_restored_state(restored, template, node: str = "restore"):
    """RESHARD002 hook after a restore: a leaf back on another layout
    than its template's raises under `analyze_raise`.  Returns the
    findings."""
    if not _enabled():
        return []
    return _gate(audit_restored_state(restored, template, node=node),
                 rule="RESHARD002")


def check_donation_pairs(result, inputs=None, node: str = "state-io"):
    """ALIAS002/003 hook over a compiled signature's state pairs (and,
    given them, the call's flat inputs); raises under `analyze_raise`.
    Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_donation_pairs(result, inputs=inputs, node=node),
                 rule="ALIAS002")


def check_host_aliases(donated, holders, node: str = "session"):
    """ALIAS004 hook at the session's step boundary; raises under
    `analyze_raise`.  Returns the findings."""
    if not _enabled():
        return []
    return _gate(audit_host_aliases(donated, holders, node=node),
                 rule="ALIAS004")
