"""Layers 1 and 3a of the port's analyzer against the JAX package's, and
their hooks in the port's frontend.

The same MetaGraph is built by hand in both packages' `metashard.metair`
(the port keys ops by aten name, "aten.mm" for "dot_general") and each
golden the JAX tests seed (tests/test_analyze/test_strategy_rules.py,
test_memory_rules.py) — a bad S-dim, an unresolved PARTIAL, a PARTIAL
escaping, mis-sized bytes, a lifetime drift, an unsound skyline, an
over-budget plan — fires exactly once in both, with the same (rule_id,
severity, node); clean assignments fire nothing.  Then the port alone:
`resolve_hbm_budget`'s knob, MEM005 over a port `RematPlan`, and on a
fake-group compile of the MLP step `solve_axes` filling the findings and
solver audits, `CompiledFunction.analyze()` raising on a seeded budget,
the dumps and the runtime profiler."""

import os

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import easydist_tpu.analyze as ja
from easydist_tpu_torch.schedule.remat import program_peak
import easydist_tpu_torch.analyze as ta
from easydist_tpu.autoflow.cost_model import MeshAxisSpec as JAxis
from easydist_tpu.metashard import metair as jm
from easydist_tpu.schedule import plan_graph_memory as jplan
from easydist_tpu_torch import config as tconfig
from easydist_tpu_torch.autoflow.cost_model import MeshAxisSpec as TAxis
from easydist_tpu_torch.metashard import metair as tm
from easydist_tpu_torch.schedule import plan_graph_memory as tplan

ATEN = {"dot_general": "aten.mm", "reduce_sum": "aten.sum",
        "tanh": "aten.tanh", "add": "aten.add", "mul": "aten.mul",
        "div": "aten.div"}
JAX_NAME = {v: k for k, v in ATEN.items()}


def key(findings):
    out = []
    for f in findings:
        node = f.node
        for aten, name in JAX_NAME.items():
            node = node.replace(f"({aten})", f"({name})")
        out.append((f.rule_id, f.severity, node))
    return out


def build(m, inputs, ops, outputs, flops=None):
    """MetaGraph in metair module `m`: inputs [(name, var, shape)], ops
    [(name, op, [in vars], [(var, shape)])] with JAX op names."""
    g = m.MetaGraph("fixture")
    var = {}
    port = m is tm
    for name, v, shape in inputs:
        var[v] = m.MetaVar(v, shape, "float32")
        g.add_input(m.MetaNode(name, "placeholder", [], [var[v]],
                               is_input=True))
    for name, op, ins, outs in ops:
        for v, shape in outs:
            var[v] = m.MetaVar(v, shape, "float32")
        node = m.MetaNode(name, ATEN[op] if port else op,
                          [var[v] for v in ins], [var[v] for v, _ in outs])
        if flops and name in flops:
            node.flops = flops[name]
        g.add_op(node)
    g.outputs = [var[v] for v in outputs]
    return g


def strategies(m, spec):
    """{node: NodeStrategy} from {node: ([in], [out])} of "R", "S0",
    "P", "Pmax"."""
    def pl(s):
        if s == "R":
            return m.Placement.replicate()
        if s.startswith("S"):
            return m.Placement.shard(int(s[1:]))
        red = m.Reduction.MAX if s == "Pmax" else m.Reduction.SUM
        return m.Placement.partial(red)
    return {n: m.NodeStrategy([pl(p) for p in ins], [pl(p) for p in outs])
            for n, (ins, outs) in spec.items()}


CHAIN = ([("in_x", "x", (8, 8)), ("in_w", "w", (8, 8))],
         [("op0", "dot_general", ["x", "w"], [("h", (8, 8))]),
          ("op1", "reduce_sum", ["h"], [("r", (8,))]),
          ("op2", "tanh", ["r"], [("t", (8,))])], ["t"])
CLEAN = {"in_x": ([], ["S0"]), "in_w": ([], ["R"]),
         "op0": (["S0", "R"], ["S0"]), "op1": (["S0"], ["S0"]),
         "op2": (["S0"], ["S0"])}
BILINEAR = ([("in_a", "a", (8, 8)), ("in_b", "b", (8, 8))],
            [("op0", "tanh", ["a"], [("c", (8, 8))]),
             ("op1", "tanh", ["b"], [("d", (8, 8))]),
             ("op2", "mul", ["c", "d"], [("e", (8, 8))])], ["e"])

STRAT_CASES = {
    "clean": (CHAIN, {}, 4, []),
    "dim_out_of_rank": (CHAIN, {"op0": (["S0", "R"], ["S5"])}, 4,
                        ["STRAT002"]),
    "indivisible": (CHAIN, {k: ([("R")] * len(v[0]), ["R"])
                            for k, v in CLEAN.items()}
                    | {"op2": (["R"], ["S0"])}, 3, ["STRAT002"]),
    "partial_escapes": (CHAIN, {"op2": (["S0"], ["P"])}, 4, ["STRAT003"]),
    "partial_from_whole": (CHAIN, {"op1": (["P"], ["S0"])}, 4,
                           ["STRAT001"]),
    "partial_nonlinear": (CHAIN, {"op1": (["S0"], ["P"]),
                                  "op2": (["P"], ["S0"])}, 4, ["STRAT004"]),
    "reduction_mismatch": (CHAIN, {"op0": (["S0", "R"], ["P"]),
                                   "op1": (["Pmax"], ["S0"])}, 4,
                           ["STRAT004"]),
    "bilinear_both": (BILINEAR, {"in_a": ([], ["R"]), "in_b": ([], ["R"]),
                                 "op0": (["R"], ["P"]),
                                 "op1": (["R"], ["P"]),
                                 "op2": (["P", "P"], ["R"])}, 4,
                      ["STRAT004"]),
}


@pytest.mark.parametrize("case", sorted(STRAT_CASES))
def test_strategy_goldens_match_jax(case):
    (inputs, ops, outs), change, size, want = STRAT_CASES[case]
    spec = {**CLEAN, **change} if inputs is CHAIN[0] else change
    got = []
    for m, pkg, Axis in ((jm, ja, JAxis), (tm, ta, TAxis)):
        g = build(m, inputs, ops, outs)
        got.append(pkg.verify_axis(g, strategies(m, spec), Axis("dp", size)))
    assert key(got[1]) == key(got[0])
    assert [f.rule_id for f in got[1]] == want


def test_solver_objective_audit_matches_jax():
    """STRAT005 over a real solve in both packages: clean, then a
    corrupted reported cost fires once."""
    out = []
    for m, pkg, Axis in ((jm, ja, JAxis), (tm, ta, TAxis)):
        from importlib import import_module

        solver_mod = import_module(
            ("easydist_tpu_torch" if pkg is ta else "easydist_tpu")
            + ".autoflow.solver")
        g = build(m, *CHAIN)
        for node in g.all_nodes():
            node.explicit_strategies = [
                s for s in strategies(m, {node.name: CLEAN[node.name]})
                .values()] + [node.replicate_strategy()]
        g.coarsen(4, level=0)
        solver = solver_mod.SpmdSolver(g, Axis("dp", 4))
        chosen = solver.solve()
        finding, record = pkg.audit_solver_objective(solver, chosen)
        assert finding is None and record["reported"] == record["recomputed"]
        solver.last_comm_cost = record["reported"] + 1.0
        finding, _ = pkg.audit_solver_objective(solver, chosen)
        out.append([finding])
    assert key(out[1]) == key(out[0])
    assert out[1][0].rule_id == "STRAT005"


MEM = ([("in_x", "x", (32, 16)), ("in_w", "w", (16, 16))],
       [("op0", "tanh", ["x"], [("a", (32, 16))]),
        ("op1", "dot_general", ["a", "w"], [("b", (64, 64))]),
        ("op2", "tanh", ["b"], [("c", (64, 64))]),
        ("op3", "add", ["a", "c"], [("d", (32, 16))])], ["d"])
MEM_CHOSEN = {"in_x": ([], ["S0"]), "in_w": ([], ["R"]),
              "op0": (["S0"], ["S0"]), "op1": (["S0", "R"], ["S0"]),
              "op2": (["S0"], ["S0"]), "op3": (["S0", "S0"], ["S0"])}


def _mutate(plan, case):
    if case == "lifetime":
        plan.ends[plan.var_names.index("b")] -= 1
    elif case == "size":
        plan.sizes[plan.var_names.index("a")] += 4
        plan.peak_bytes = int(np.max(plan.offsets + plan.sizes))
    elif case == "overlap":
        i, j = plan.var_names.index("w"), plan.var_names.index("x")
        plan.offsets[j] = plan.offsets[i]
        plan.peak_bytes = int(np.max(plan.offsets + plan.sizes))
    elif case == "below_live":
        plan.peak_bytes = plan.peak_live_bytes - 1


@pytest.mark.parametrize("case,want", [
    ("clean", []), ("lifetime", ["MEM001"]), ("size", ["MEM002"]),
    ("overlap", ["MEM003"]), ("below_live", ["MEM003", "MEM003"])])
def test_memory_plan_goldens_match_jax(case, want):
    got = []
    for m, pkg, plan_fn in ((jm, ja, jplan), (tm, ta, tplan)):
        g = build(m, *MEM)
        ch = strategies(m, MEM_CHOSEN)
        plan = plan_fn(g, [ch], [4])
        assert pkg.recompute_liveness(g) == {
            n: (int(plan.starts[i]), int(plan.ends[i]))
            for i, n in enumerate(plan.var_names)}
        _mutate(plan, case)
        got.append(pkg.verify_memory_plan(g, plan, [ch], [4]))
    assert key(got[1]) == key(got[0])
    assert [f.rule_id for f in got[1]] == want


@pytest.mark.parametrize("slack", [None, 0])
def test_budget_gate_matches_jax(slack):
    got = []
    for m, pkg, plan_fn in ((jm, ja, jplan), (tm, ta, tplan)):
        g = build(m, *MEM)
        plan = plan_fn(g, [strategies(m, MEM_CHOSEN)], [4])
        budget = plan.peak_bytes if slack == 0 else (
            plan.peak_bytes - int(plan.sizes[plan.var_names.index("a")]))
        got.append(pkg.check_hbm_budget(g, plan, budget))
    assert key(got[1]) == key(got[0])
    if slack is None:
        assert [f.rule_id for f in got[1]] == ["MEM004"]
        msg = got[1][0].message
        assert "a(" in msg and "sufficient to fit" in msg


def test_resolve_hbm_budget(monkeypatch):
    monkeypatch.setattr(tconfig, "analyze_hbm_budget", 12345)
    assert ta.resolve_hbm_budget() == 12345
    monkeypatch.setattr(tconfig, "analyze_hbm_budget", 0)
    assert ta.resolve_hbm_budget() == 0
    monkeypatch.setattr(tconfig, "analyze_hbm_budget", -1)
    assert ta.resolve_hbm_budget() == tconfig.hbm_capacity_default
    assert ta.resolve_hbm_budget(device="cpu") == \
        tconfig.hbm_capacity_default


def _remat_program():
    def f(xs, w):
        a = torch.tanh(xs.expand(64, 64))
        b = torch.cat([w, w], 0).sum()
        return (a @ w).sum() + b

    return make_fx(f, tracing_mode="fake")(torch.ones(64), torch.eye(64))


def test_mem005_over_a_port_remat_plan():
    from easydist_tpu_torch.schedule.remat import RematPlan

    gm = _remat_program()
    names = [n.name for n in gm.graph.nodes]
    tanh = next(n.name for n in gm.graph.nodes
                if "tanh" in str(n.target))
    mm = next(n.name for n in gm.graph.nodes if "mm" in str(n.target))

    def plan(recompute, predicted=50):
        return RematPlan(recompute=recompute, base_peak=100,
                         predicted_peak=predicted)

    assert ta.audit_remat_plan(gm, plan({mm: [tanh]})) == []
    late = ta.audit_remat_plan(gm, plan({tanh: [mm]}))
    assert [f.rule_id for f in late] == ["MEM005"]
    assert "topological" in late[0].message
    assert [f.rule_id for f in ta.audit_remat_plan(
        gm, plan({mm: [tanh]}, predicted=100))] == ["MEM005"]
    assert [f.rule_id for f in ta.audit_remat_plan(
        gm, plan({mm: ["nowhere"]}))] == ["MEM005"]
    placeholder = names[0]
    assert [f.rule_id for f in ta.audit_remat_plan(
        gm, plan({mm: [placeholder]}))] == ["MEM005"]
    assert [f.rule_id for f in ta.audit_remat_plan(
        gm, plan({mm: [tanh]}), program=gm)] == ["MEM005"]


def test_planner_remat_passes_mem005(monkeypatch):
    """The planner's own plan over a capped step: no MEM005, and the
    rewritten program carries its clones."""
    from tests.test_torch_remat import _mlp_step
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.schedule import remat as rm

    monkeypatch.setattr(tconfig, "per_device_memory_cap", 0)
    step, mk, x = _mlp_step(L=4, D=32, B=2048)
    r0 = easydist_compile(step).get_compiled(mk(), x)
    base = rm.program_peak(r0.traced)
    cap = (base + rm.plan_remat(r0.traced, 1).predicted_peak) // 2
    monkeypatch.setattr(tconfig, "per_device_memory_cap",
                        int(cap / tconfig.memory_ratio) + 1)
    compiled = easydist_compile(step)
    res = compiled.get_compiled(mk(), x)
    assert res.remat_plan is not None and res.remat_source is not None
    rep = res.analyze()
    assert [f.rule_id for f in rep.findings] == ["MEM000"]
    assert res.predicted_peak_bytes is None


# --------------------------------------------- the frontend's hooks

@pytest.fixture
def fake8(monkeypatch, tmp_path):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch.fxfront import set_device_mesh

    monkeypatch.setattr(tconfig, "discovery_device", "cpu")
    monkeypatch.setattr(tconfig, "prof_db_path", str(tmp_path / "p.db"))
    monkeypatch.setattr(tconfig, "discovery_cache_dir",
                        str(tmp_path / "disc"))
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    yield
    set_device_mesh(None)
    dist.destroy_process_group()


def _mlp_compile(mesh_shape=(4, 2), names=("dp", "tp"), **kw):
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.mlp import make_mlp_train_step, mlp_init

    gen = torch.Generator().manual_seed(0)
    params = mlp_init(gen, sizes=(64, 128, 64), device="cpu")
    x = torch.randn(64, 64, generator=gen)
    y = torch.randn(64, 64, generator=gen)
    mesh = make_device_mesh(mesh_shape, names, device_type="cpu")
    compiled = easydist_compile(make_mlp_train_step(lr=0.05), mesh=mesh,
                                compile_only=True, **kw)
    res = compiled(params, x, y)
    return compiled, res, (params, x, y)


def test_solve_axes_fills_findings_and_audits(fake8):
    compiled, res, args = _mlp_compile()
    assert [a["axis"] for a in res.solver_audits] == ["dp", "tp"]
    for a in res.solver_audits:
        assert abs(a["reported"] - a["recomputed"]) <= 1e-6 * max(
            1.0, abs(a["reported"]))
    assert not [f for f in res.analysis_findings if f.severity == "error"]
    rep = compiled.analyze()
    assert not rep.errors()
    assert res.memory_plan is not None
    assert res.predicted_peak_bytes == max(
        res.memory_plan.peak_bytes,
        program_peak(res.planning_program())) > 0
    assert compiled.analyze(*args).counts() == rep.counts()


def test_predicted_peak_sizes_the_program_that_runs(fake8):
    """The graph plan frees an input after its last read, but the caller
    holds it for the whole call: a replicated a @ b on (8,) peaks with
    both inputs alive.  The prediction is the rank program's liveness
    peak there (the plan alone under-counts by the inputs' bytes)."""
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh

    mesh = make_device_mesh((8,), ("dp",), device_type="cpu")
    a, b = torch.ones(1024, 64), torch.ones(64, 1024)
    compiled = easydist_compile(lambda a, b: torch.tanh(a @ b) * 2.0,
                                mesh=mesh, compile_only=True)
    res = compiled(a, b)
    compiled.analyze()
    in_bytes = a.numel() * 4 + b.numel() * 4
    assert res.program_peak_bytes == res.memory_plan.peak_bytes + in_bytes
    assert res.predicted_peak_bytes == res.program_peak_bytes


def test_analyze_raises_on_a_seeded_budget(fake8, monkeypatch):
    compiled, res, _ = _mlp_compile()
    compiled.analyze()
    monkeypatch.setattr(tconfig, "analyze_hbm_budget",
                        res.predicted_peak_bytes // 2)
    with pytest.raises(ta.AnalysisError, match="MEM004"):
        compiled.analyze()
    rep = compiled.analyze(raise_on_error=False)
    (mem4,) = [f for f in rep.findings if f.rule_id == "MEM004"]
    assert "advisory" in mem4.message
    monkeypatch.setattr(tconfig, "analyze_raise", False)
    assert compiled.analyze().errors() == [mem4]


def test_analyze_needs_a_compile():
    from easydist_tpu_torch.fxfront import easydist_compile

    with pytest.raises(RuntimeError, match="nothing compiled"):
        easydist_compile(lambda a: a + 1).analyze()


def test_strategy_cache_hit_is_strat000_and_mem000(fake8, monkeypatch,
                                                   tmp_path):
    monkeypatch.setattr(tconfig, "enable_compile_cache", True)
    monkeypatch.setattr(tconfig, "compile_cache_dir", str(tmp_path / "c"))
    _mlp_compile()
    compiled, res, _ = _mlp_compile()
    rules = [f.rule_id for f in compiled.analyze().findings]
    assert rules == ["STRAT000", "MEM000"]


def test_export_and_discovery_record(fake8, tmp_path):
    from easydist_tpu_torch.runtime.perfdb import PerfDB, discovery_db_path

    compiled, res, _ = _mlp_compile()
    compiled.analyze()
    stats = PerfDB().get_op_perf("analyze_stats", "train_step")
    assert stats["counts"]["error"] == 0
    traces = PerfDB(discovery_db_path()).snapshot()["discovery"]["traces"]
    assert traces[-1]["rules_preset"] == res.counters["rules_preset"] > 0


def test_dump_dir_writes_the_plan_and_every_rank_program(fake8, monkeypatch,
                                                         tmp_path):
    d = tmp_path / "dump"
    monkeypatch.setattr(tconfig, "dump_dir", str(d))
    monkeypatch.setattr(tconfig, "dump_cluster", True)
    _mlp_compile()
    names = sorted(os.listdir(d))
    for f in ("metair.txt", "clusters.txt", "strategies.txt", "metair.dot"):
        assert f in names and os.path.getsize(d / f) > 0
    programs = [n for n in names if n.startswith("program_rank_")]
    assert len(programs) == 8
    code = (d / "program_rank_0_0.py").read_text()
    assert "def forward" in code
    assert (d / "metair.dot").read_text().startswith("digraph metair")


def test_runtime_prof_records_from_the_second_call(monkeypatch, tmp_path):
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.runtime.perfdb import PerfDB

    monkeypatch.setattr(tconfig, "prof_db_path", str(tmp_path / "p.db"))
    monkeypatch.setattr(tconfig, "enable_runtime_prof", True)

    def double(a):
        return a * 2

    compiled = easydist_compile(double)
    x = torch.ones(4)
    for n in range(4):
        torch.testing.assert_close(compiled(x), x * 2)
        hist = PerfDB().get_op_perf("step_times", "double") or []
        assert len(hist) == n
    assert all(t > 0 for t in hist)
