"""The port's analyzer rules held against the JAX package's on the same
inputs: the rule catalog (ids, severities, layers), fingerprints, the
PerfDB payload of `export_to_perfdb`, and the plain-data layers — fleet
(FLEET001-005), simulator (SIM001-002), paged KV (KV001) and pruned
discovery (DISC001).  Each case feeds one fixture to both packages and
compares the findings as (rule_id, severity, node) lists, exactly."""

import numpy as np
import pytest
import torch

import easydist_tpu.analyze as ja
import easydist_tpu_torch.analyze as ta
from easydist_tpu import config as jconfig
from easydist_tpu_torch import config as tconfig

CHUNK = 4


def key(findings):
    return [(f.rule_id, f.severity, f.node) for f in findings]


def both(fn):
    """fn(pkg) over (JAX package, port): their findings, equal."""
    got_j, got_t = fn(ja), fn(ta)
    assert key(got_t) == key(got_j)
    return got_t


# ------------------------------------------------------------ the catalog

def test_rule_catalog_matches_jax():
    assert list(ta.RULES) == list(ja.RULES)
    for rule_id, (sev, _title) in ja.RULES.items():
        assert ta.RULES[rule_id][0] == sev
        assert ta.layer_of(rule_id) == ja.layer_of(rule_id)
    assert ta.rule_index_rows() == ja.rule_index_rows()


@pytest.mark.parametrize("kw", [
    {}, {"path": "easydist_tpu_torch/x.py", "line": 7},
    {"severity": "warning"}])
def test_fingerprint_and_str_match_jax(kw):
    fj = ja.make_finding("ALIAS001", "x.py:f", "read after donate", **kw)
    ft = ta.make_finding("ALIAS001", "x.py:f", "read after donate", **kw)
    assert ft.fingerprint() == fj.fingerprint()
    assert str(ft) == str(fj)
    with pytest.raises(ValueError):
        ta.Finding("NOPE001", "error", "n", "m")


def test_export_to_perfdb_payload_matches_jax(tmp_path):
    from easydist_tpu.runtime.perfdb import PerfDB as JDB
    from easydist_tpu_torch.runtime.perfdb import PerfDB as TDB

    def findings(pkg):
        return [pkg.make_finding("MEM004", f"memory-plan/{i}", f"msg {i}")
                for i in range(60)] + [
            pkg.make_finding("SCHED003", "pipeline", "bubble")]

    pj = ja.AnalysisReport(findings(ja)).export_to_perfdb(
        "step", db=JDB(str(tmp_path / "j.db")))
    tdb = TDB(str(tmp_path / "t.db"))
    assert len(tdb) == 0  # an empty store passed in must be used, not replaced
    pt = ta.AnalysisReport(findings(ta)).export_to_perfdb("step", db=tdb)
    assert pt == pj
    assert pt["findings_truncated"] == 11
    assert TDB(str(tmp_path / "t.db")).get_op_perf("analyze_stats",
                                                   "step") == pj


def test_report_raises_and_summarises():
    rep = ta.AnalysisReport([ta.make_finding("STRAT001", "n", "m"),
                             ta.make_finding("SCHED003", "p", "b")])
    assert rep.counts() == {"error": 1, "warning": 1, "info": 0}
    with pytest.raises(ta.AnalysisError, match="STRAT001"):
        rep.raise_on_errors()
    assert "1 error(s), 1 warning(s)" in rep.summary()


# -------------------------------------------------------------- fleet

def _decision(**kw):
    d = {"request_id": 0, "replica_id": "d0", "breaker_state": "closed",
         "draining": False, "affinity_tokens": 0, "prompt_tokens": 8,
         "policy": "affinity"}
    d.update(kw)
    return d


@pytest.mark.parametrize("decisions", [
    [_decision(request_id=i) for i in range(4)],
    [_decision(), _decision(request_id=1, breaker_state="open")],
    [_decision(draining=True)],
    [_decision(health="alive"), _decision(request_id=1, health="dead")],
    [_decision(health="suspect")],
    [_decision(breaker_state="open", draining=True, health="dead")],
])
def test_routing_matches_jax(decisions):
    both(lambda pkg: pkg.audit_routing(decisions))


@pytest.mark.parametrize("desc,resume", [
    ({"request_id": 3, "prompt": [1, 2], "ids": [5], "max_new": 4,
      "eos_id": None}, [1, 2, 5]),
    ({"request_id": 3, "prompt": [1, 2], "ids": [5], "max_new": 4,
      "eos_id": None}, None),
    ({"request_id": 3, "prompt": [1, 2], "ids": [5], "max_new": 4,
      "eos_id": None}, [1, 2]),
    ({"request_id": 4, "prompt": [1], "ids": [5, 6], "max_new": 2,
      "eos_id": None}, [1, 5, 6]),
    ({"request_id": 5, "prompt": [1], "ids": [5, 9], "max_new": 8,
      "eos_id": 9}, [1, 5, 9]),
])
def test_resume_matches_jax(desc, resume):
    both(lambda pkg: pkg.audit_resume(desc, resume))


def _np_path(n):
    return [(tuple(range(j * CHUNK, (j + 1) * CHUNK)),
             {"k": np.full((1, 2, CHUNK, 8), float(j), np.float32),
              "v": np.full((1, 2, CHUNK, 8), float(j), np.float32)})
            for j in range(n)]


def _torch_path(path):
    return [(toks, {k: torch.from_numpy(v.copy()) for k, v in kv.items()})
            for toks, kv in path]


@pytest.mark.parametrize("damage", ["none", "k", "v", "tokens"])
def test_page_handoff_matches_jax(damage):
    from easydist_tpu.fleet import page_manifest as jmanifest
    from easydist_tpu_torch.fleet.transport import page_manifest as tmanifest

    jpath = _np_path(2)
    tpath = _torch_path(jpath)
    mj = jmanifest(jpath, src="p0", dst="d0")
    mt = tmanifest(tpath, src="p0", dst="d0")
    if damage in ("k", "v"):
        jpath[1][1][damage][0, 0, 0, 0] += 1.0
        tpath[1][1][damage][0, 0, 0, 0] += 1.0
    elif damage == "tokens":
        jpath[0] = ((99,) + jpath[0][0][1:], jpath[0][1])
        tpath[0] = ((99,) + tpath[0][0][1:], tpath[0][1])
    fj = ja.audit_page_handoff(mj, jpath, node="handoff[p0->d0]")
    ft = ta.audit_page_handoff(mt, tpath, node="handoff[p0->d0]")
    assert key(ft) == key(fj)
    assert bool(ft) == (damage != "none")
    if damage != "none":
        with pytest.raises(ta.AnalysisError, match="FLEET002"):
            ta.check_page_handoff(mt, tpath)


class _Pool:
    def __init__(self, trie):
        self.trie = trie


class _Drained:
    def __init__(self, trie, drained=True):
        self._pools = {32: _Pool(trie)}
        self.is_drained = drained


@pytest.mark.parametrize("fault", ["clean", "pinned", "drift", "live"])
def test_drained_session_matches_jax(fault):
    from easydist_tpu.serve import PrefixCache as JTrie
    from easydist_tpu_torch.serve.prefix_cache import PrefixCache as TTrie

    def run(pkg):
        trie = (JTrie if pkg is ja else TTrie)(CHUNK, 1 << 20)
        path = _np_path(2) if pkg is ja else _torch_path(_np_path(2))
        nodes = []
        for toks, kv in path:
            nodes.append(trie.commit(nodes, list(toks), kv))
        if fault == "pinned":
            trie.pin([nodes[1]])
        elif fault == "drift":
            trie.bytes_used += 17
        return pkg.audit_drained_session(_Drained(trie, fault != "live"))

    found = both(run)
    assert bool(found) == (fault != "clean")
    if fault == "pinned":
        assert found[0].severity == "warning"


def test_fleet_hooks_raise_and_kill_switch(monkeypatch):
    with pytest.raises(ta.AnalysisError, match="FLEET001"):
        ta.check_fleet_routing([_decision(breaker_state="open")])
    with pytest.raises(ta.AnalysisError, match="FLEET005"):
        ta.check_resume_descriptor({"request_id": 1, "prompt": [1],
                                    "ids": [2], "max_new": 1})
    monkeypatch.setattr(tconfig, "analyze_raise", False)
    assert len(ta.check_fleet_routing([_decision(draining=True)])) == 1
    monkeypatch.setattr(tconfig, "enable_analyze", False)
    assert ta.check_fleet_routing([_decision(draining=True)]) == []


# ---------------------------------------------------------- simulator

@pytest.mark.parametrize("rows", [
    [{"preset": "a", "predicted_s": 1.0, "measured_s": 1.2}],
    [{"preset": "a", "predicted_s": 1.0, "measured_s": 3.0},
     {"preset": "b", "predicted_s": 1.0, "measured_s": 1.0}],
    [{"preset": "c", "predicted_s": 1.0, "measured_s": 0.0}],
    [{"preset": "d", "predicted_s": None, "measured_s": 1.0}],
])
@pytest.mark.parametrize("bound", [None, 0.1])
def test_prediction_matches_jax(rows, bound):
    from easydist_tpu.sim.simulate import SIM_REL_ERROR_BOUND as jb
    from easydist_tpu_torch.sim.simulate import SIM_REL_ERROR_BOUND as tb

    assert tb == jb
    both(lambda pkg: pkg.audit_prediction(rows, bound=bound))


def _scale(*acts):
    return [{"tick": t, "action": a} for t, a in acts]


@pytest.mark.parametrize("log", [
    _scale((1, "scale_up"), (2, "hold"), (9, "scale_down")),
    _scale((1, "scale_up"), (2, "scale_down")),
    _scale((1, "scale_up"), (3, "scale_down"), (4, "scale_up")),
    _scale((1, "scale_down"), (5, "scale_up")),
    _scale((1, "scale_up"), (2, "scale_up")),
])
@pytest.mark.parametrize("window", [None, 2, 6])
def test_scale_decisions_match_jax(log, window):
    both(lambda pkg: pkg.audit_scale_decisions(log, window=window))


def test_sim_hooks_raise_and_kill_switch(monkeypatch):
    bad = [{"preset": "a", "predicted_s": 1.0, "measured_s": 3.0}]
    flap = _scale((1, "scale_up"), (2, "scale_down"))
    with pytest.raises(ta.AnalysisError, match="SIM001"):
        ta.check_sim_prediction(bad)
    with pytest.raises(ta.AnalysisError, match="SIM002"):
        ta.check_sim_autoscale(flap)
    monkeypatch.setattr(tconfig, "enable_analyze", False)
    assert ta.check_sim_prediction(bad) == []
    assert ta.check_sim_autoscale(flap) == []


# ------------------------------------------------------------- paged KV

@pytest.mark.parametrize("fault", ["clean", "under_counted", "freed",
                                   "leak", "trie_freed", "outside"])
def test_page_table_matches_jax(fault):
    from easydist_tpu.kv import PagePool as JPool, PageTable as JTable
    from easydist_tpu_torch.kv import PagePool as TPool, PageTable as TTable

    class Trie:
        def __init__(self, pids):
            self.pids = pids

        def _walk(self):
            for d, pid in enumerate(self.pids):
                yield type("N", (), {"kv": {"page": pid}, "depth": d + 1})

    def run(pkg):
        pool_cls, table_cls = (JPool, JTable) if pkg is ja else (TPool,
                                                                 TTable)
        pool, table = pool_cls(6, 8, page_bytes=64), table_cls(3, 4, 6)
        for slot in range(2):
            for j in range(2):
                table.map(slot, j, pool.alloc())
        trie = None
        if fault == "under_counted":
            table.map(2, 0, table.mapped(0)[0])
        elif fault == "freed":
            pool.release(table.mapped(1)[1])
        elif fault == "leak":
            pool._refcount[5] = -1
        elif fault == "trie_freed":
            trie = Trie([table.mapped(0)[0], 5])
        elif fault == "outside":
            trie = Trie([17])
        return pkg.audit_page_table(pool, table, trie=trie)

    found = both(run)
    assert bool(found) == (fault != "clean")


# ----------------------------------------------------- pruned discovery

def _rule(mod, table, **extra):
    r = {"space": mod.ShardSpace(table), "recombines": {}}
    r.update(extra)
    return r


@pytest.mark.parametrize("case", ["clean", "rows", "rank", "halo", "block",
                                  "composite", "composite_same"])
def test_rule_transfer_matches_jax(case):
    import easydist_tpu.metashard.annotation as jan
    import easydist_tpu_torch.metashard.annotation as tan

    assert tconfig.discovery_nshards == jconfig.discovery_nshards
    nsh = max(int(tconfig.discovery_nshards), 1)

    def run(pkg):
        an = jan if pkg is ja else tan
        D = an.DimSharding
        two = [[D(group=1), D()], [D(), D(group=1)]]
        rep, mem = [(8, 16), (16, 8)], [(32, 64), (64, 32)]
        rule = _rule(an, two)
        if case == "rows":
            rule, rep, mem = _rule(an, [[D(group=1), D()]]), [(8, 16)], mem
        elif case == "rank":
            rule, rep, mem = (_rule(an, [[D(group=1), D()]]), [(8, 16)],
                              [(8, 16, 4)])
        elif case == "halo":
            rule = _rule(an, [[D(group=1, halo=an.HaloSpec(width=1, dim=0)),
                               D()]])
            rep, mem = [(64, 16)], [(nsh, 16)]
        elif case == "block":
            rule = _rule(an, [[D(group=1, block=2), D()]])
            rep, mem = [(8, 16)], [(16, 16)]
        elif case.startswith("composite"):
            rule = {"strategies": [], "space": None}
            mem = rep if case == "composite_same" else mem
        return pkg.audit_rule_transfer([{
            "sig": "mm-member", "prim": "mm", "rep_sig": "mm-rep",
            "rule": rule, "rep_shapes": rep, "member_shapes": mem}])

    found = both(run)
    assert bool(found) == (case not in ("clean", "composite_same"))


def test_page_table_hook_raises_and_wrapper_keeps_strings(monkeypatch):
    from easydist_tpu_torch.kv import PagePool, PageTable, audit_page_table

    pool, table = PagePool(6, 8, page_bytes=64), PageTable(3, 4, 6)
    table.map(0, 0, pool.alloc())
    pool.release(table.mapped(0)[0])
    messages = audit_page_table(pool, table)
    assert messages and all(isinstance(m, str) for m in messages)
    assert messages == [f.message for f in ta.audit_page_table(pool, table)]
    with pytest.raises(ta.AnalysisError, match="KV001"):
        ta.check_page_table(pool, table)
    monkeypatch.setattr(tconfig, "enable_analyze", False)
    assert ta.check_page_table(pool, table) == []
