"""Layer 3b of the port's analyzer (SCHED001-003) against the JAX
package's: the tick tables both packages' builders make over a grid of
(stages, virtual stages, microbatches) give identical findings and
`schedule_stats`; the port's hook in `parallel.pipeline.schedule_tables`
verifies every table set it builds (gpipe / remat fill-drain with their
backward, 1f1b, interleaved, forward only) and raises on a seeded
deadlock, a double-scheduled unit and a stash over the ring."""

import numpy as np
import pytest

import easydist_tpu.analyze as ja
import easydist_tpu_torch.analyze as ta
from easydist_tpu.parallel.pipeline import _1f1b_schedule_tables as j1f1b
from easydist_tpu_torch import config as tconfig
from easydist_tpu_torch.parallel import pipeline as tpipe

GRID = [(S, V, M) for S in (1, 2, 3, 4) for V in (1, 2)
        for M in (1, 2, 4, 6, 8) if V == 1 or M % S == 0]


def key(findings):
    return [(f.rule_id, f.severity, f.node) for f in findings]


@pytest.mark.parametrize("fwd_only", [False, True])
@pytest.mark.parametrize("S,V,M", GRID)
def test_1f1b_tables_match_jax(S, V, M, fwd_only):
    tj = j1f1b(S, V, M, fwd_only=fwd_only)
    tt = tpipe._1f1b_schedule_tables(S, V, M, fwd_only=fwd_only)
    fj = ja.verify_schedule_tables(tj, S, V, M, fwd_only=fwd_only)
    ft = ta.verify_schedule_tables(tt, S, V, M, fwd_only=fwd_only)
    assert key(ft) == key(fj)
    assert ta.schedule_stats(tt, fwd_only) == ja.schedule_stats(tj,
                                                                fwd_only)
    assert not [f for f in ft if f.severity == "error"]


@pytest.mark.parametrize("S,M", [(1, 1), (2, 4), (4, 8), (3, 5)])
def test_gpipe_clock_matches_jax(S, M):
    tj = ja.gpipe_schedule_tables(S, M)
    tt = ta.gpipe_schedule_tables(S, M)
    for k in tj:
        assert np.array_equal(np.asarray(tt[k]), np.asarray(tj[k]))
    assert key(ta.verify_schedule_tables(tt, S, 1, M, fwd_only=True)) == \
        key(ja.verify_schedule_tables(tj, S, 1, M, fwd_only=True))


@pytest.mark.parametrize("schedule", ["gpipe", "remat", "1f1b"])
@pytest.mark.parametrize("S,V,M", [(2, 1, 4), (4, 1, 8), (2, 2, 4),
                                   (4, 2, 8)])
@pytest.mark.parametrize("grad", [True, False])
def test_every_built_table_passes_the_hook(schedule, S, V, M, grad, caplog):
    tables = tpipe.schedule_tables(schedule, S, V, M, grad=grad)
    found = ta.verify_schedule_tables(tables, S, V, M, fwd_only=not grad,
                                      stash_bound=schedule == "1f1b")
    assert not [f for f in found if f.severity == "error"]
    bubble = ta.schedule_stats(tables, not grad)["bubble_fraction"]
    warned = any(f.rule_id == "SCHED003" for f in found)
    assert warned == (bubble > tconfig.analyze_bubble_warn_frac)


def test_fill_drain_keeps_every_microbatch_within_its_ring():
    """gpipe's backward mirror holds all M microbatches: within its ring
    (M), over the 1F1B bound — which applies to 1f1b only."""
    tables = tpipe._gpipe_tables(4, 1, 8)
    assert tables["ring"] == 8
    strict = ta.verify_schedule_tables(tables, 4, 1, 8)
    assert [f.rule_id for f in strict if f.severity == "error"] == \
        ["SCHED002"]
    assert not [f for f in ta.verify_schedule_tables(
        tables, 4, 1, 8, stash_bound=False) if f.severity == "error"]


_BUILD = tpipe._1f1b_schedule_tables


def _seeded(kind):
    def build(S, V, M, fwd_only=False):
        t = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in _BUILD(
                 S, V, M, fwd_only=fwd_only).items()}
        if kind == "deadlock":
            # stage 1's first forward in the same tick as stage 0's
            u = int(np.argmax(t["f_ok"][:, 1]))
            t["f_ok"][u, 1] = False
            t["f_ok"][0, 1], t["m_f"][0, 1] = True, t["m_f"][u, 1]
            t["k_f"][0, 1] = t["k_f"][u, 1]
        elif kind == "twice":
            u = [i for i in range(t["f_ok"].shape[0]) if t["f_ok"][i, 0]]
            t["m_f"][u[1], 0] = t["m_f"][u[0], 0]
        elif kind == "ring":
            t["ring"] = 1
        return t
    return build


@pytest.mark.parametrize("kind,rule", [("deadlock", "SCHED001"),
                                       ("twice", "SCHED001"),
                                       ("ring", "SCHED002")])
def test_hook_raises_on_a_seeded_table(monkeypatch, kind, rule):
    monkeypatch.setattr(tpipe, "_1f1b_schedule_tables", _seeded(kind))
    with pytest.raises(ta.AnalysisError, match=rule):
        tpipe.schedule_tables("1f1b", 2, 1, 4)
    monkeypatch.setattr(tconfig, "analyze_raise", False)
    tpipe.schedule_tables("1f1b", 2, 1, 4)  # logged, not raised
    monkeypatch.setattr(tconfig, "enable_analyze", False)
    assert ta.check_schedule_tables(
        _seeded(kind)(2, 1, 4), 2, 1, 4) == []
