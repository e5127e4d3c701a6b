"""`GPTConfig.remat` and `GPTConfig.scan_layers` of the port
(`models/gpt.py`) against the JAX package's (models/gpt.py:36-45,
159-175, 206-216; tests/test_jaxfront/test_remat.py::
test_remat_gpt_plan_matches_unremat_twin).

"none", "full" (`torch.utils.checkpoint` around each block) and "dots"
(a selective checkpoint that keeps the matmuls), crossed with the list
and the layer-stacked layouts: the tiny GPT's loss and gradients equal
the JAX package's same config from the same weights at rtol 1e-4 /
atol 1e-5, and the stacked layout equals the list layout bitwise.  On
gloo (2,) "dp" the remat'd train step emits the collectives of its
un-remat'd twin.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from easydist_tpu.models import gpt as jgpt
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.models import gpt as tgpt
from easydist_tpu_torch.models.optim import value_and_grad
from tests import test_torch_fxfront_ranks as ranks

KW = dict(vocab=128, seq=32, dim=32, heads=4, layers=2)
RTOL, ATOL = 1e-4, 1e-5
JAX_CONSTANTS = dict(peak_flops=4.9e13, hbm_bandwidth=8.1e11,
                     nvlink_bandwidth=2e11, nvlink_latency=1e-6)


def _tokens():
    rs = np.random.RandomState(1)
    return rs.randint(0, KW["vocab"], (4, KW["seq"])).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    return {scan: jax.tree.map(np.asarray, jgpt.gpt_init(
        jgpt.GPTConfig.tiny(scan_layers=scan, **KW), jax.random.PRNGKey(0)))
        for scan in (False, True)}


def _sorted_leaves(tree):
    """Leaves in sorted-key order (JAX flattens dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                       else tree)]


def _port_loss_grads(params_np, remat, scan):
    cfg = tgpt.GPTConfig.tiny(remat=remat, scan_layers=scan, **KW)
    p = tgpt.params_from_numpy(params_np, device="cpu")
    t = torch.from_numpy(_tokens())
    return value_and_grad(lambda q: tgpt.gpt_loss(q, cfg, t, t), p)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_jax(jax_params, remat, scan):
    jcfg = jgpt.GPTConfig.tiny(remat=remat, scan_layers=scan, **KW)
    tok = _tokens()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, jcfg, tok, tok))(
        jax.tree.map(jax.numpy.asarray, jax_params[scan]))
    loss, grads = _port_loss_grads(jax_params[scan], remat, scan)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    got, want = _sorted_leaves(grads), _sorted_leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_stacked_layout_equals_list_bitwise(jax_params, remat):
    """The same weights stacked (`stack_gpt_blocks`) and as a list: the
    loss and every gradient bitwise, through the compiled train step as
    well (make_fx unrolls the layer loop)."""
    lst = jax_params[False]
    loss_l, grads_l = _port_loss_grads(lst, remat, False)
    p_list = tgpt.params_from_numpy(lst, device="cpu")
    stacked = dict(p_list, blocks=tgpt.stack_gpt_blocks(p_list["blocks"]))
    cfg_s = tgpt.GPTConfig.tiny(remat=remat, scan_layers=True, **KW)
    t = torch.from_numpy(_tokens())
    loss_s, grads_s = value_and_grad(
        lambda q: tgpt.gpt_loss(q, cfg_s, t, t), stacked)
    assert torch.equal(loss_l, loss_s)
    for k in ("wte", "wpe"):
        assert torch.equal(grads_l[k], grads_s[k])
    for leaf_l, leaf_s in zip(
            pytree.tree_leaves(tgpt.stack_gpt_blocks(grads_l["blocks"])),
            pytree.tree_leaves(grads_s["blocks"])):
        assert torch.equal(leaf_l, leaf_s)
    # the compiled step from the same state, list vs stacked
    from easydist_tpu_torch.models.optim import adam_init

    outs = []
    for scan, params in ((False, p_list), (True, stacked)):
        step, _ = tgpt.make_gpt_train_step(tgpt.GPTConfig.tiny(
            remat=remat, scan_layers=scan, **KW))
        params = pytree.tree_map(torch.clone, params)
        _, lv = easydist_compile(step)((params, adam_init(params)), t, t)
        outs.append(lv)
    assert torch.equal(outs[0], outs[1])


def test_remat_full_recomputes_blocks():
    """"full" re-runs each block's forward in the backward: the traced
    step holds more mm nodes than "none"; "dots" keeps the matmuls."""
    counts = {}
    t = torch.from_numpy(_tokens())
    for remat in ("none", "full", "dots"):
        step, init = tgpt.make_gpt_train_step(tgpt.GPTConfig.tiny(
            remat=remat, **KW))
        state = init(torch.Generator().manual_seed(0), device="cpu")
        r = easydist_compile(step).get_compiled(state, t, t)
        counts[remat] = sum(1 for n in r.traced.graph.nodes
                            if n.target is torch.ops.aten.mm.default)
    assert counts["full"] > counts["none"]
    assert counts["dots"] == counts["none"]


def test_dots_recompute_in_the_compiled_step():
    """Under make_fx torch's selective checkpoint only tags its nodes;
    `schedule.remat.apply_checkpoint_tags` does the recompute: the
    compiled "dots" step recomputes the flash forward (as the eager
    checkpoint does) but no matmul, and its planned peak falls below
    "none"'s."""
    from easydist_tpu_torch.fxfront.api import compile_step
    from easydist_tpu_torch.schedule.remat import program_peak

    t = torch.from_numpy(_tokens())
    got = {}
    for remat in ("none", "dots"):
        step, init = tgpt.make_gpt_train_step(tgpt.GPTConfig.tiny(
            remat=remat, attention="flash", **KW))
        state = init(torch.Generator().manual_seed(0), device="cpu")
        r = compile_step(step, (state, t, t), {}, mesh=torch.device("cpu"))
        nodes = [n for n in r.traced.graph.nodes if n.op == "call_function"]
        got[remat] = (
            sum(1 for n in nodes if n.target is torch.ops.aten.mm.default),
            sum(1 for n in nodes if "flash_fwd" in str(n.target)),
            program_peak(r.planning_program()))
    assert got["dots"][0] == got["none"][0]
    assert got["dots"][1] == 2 * got["none"][1] == 2 * KW["layers"]
    assert got["dots"][2] < got["none"][2]


def test_unknown_remat_raises():
    cfg = tgpt.GPTConfig.tiny(remat="most", **KW)
    p = tgpt.gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    t = torch.from_numpy(_tokens())
    with pytest.raises(ValueError, match="remat"):
        tgpt.gpt_loss(p, cfg, t, t)


def test_pipeline_step_accepts_stacked_layout(jax_params):
    """make_gpt_pipeline_step over LocalStages(2) with the stacked layout:
    the loss and gradients of the list layout."""
    from easydist_tpu_torch.parallel import LocalStages

    t = torch.from_numpy(_tokens()).long().reshape(2, 2, KW["seq"])
    out = {}
    for scan in (False, True):
        cfg = tgpt.GPTConfig.tiny(scan_layers=scan, **KW)
        p = tgpt.params_from_numpy(jax_params[False], device="cpu")
        if scan:
            p["blocks"] = tgpt.stack_gpt_blocks(p["blocks"])
        step, init = tgpt.make_gpt_pipeline_step(cfg, LocalStages(2), 2)
        params, _ = init(params=p)
        out[scan] = step.loss_and_grads(params, t, t)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(pytree.tree_leaves(tgpt.stack_gpt_blocks(
            out[False][1]["blocks"])), pytree.tree_leaves(
            out[True][1]["blocks"])):
        assert torch.equal(a, b)


def test_remat_gpt_plan_matches_unremat_twin(tmp_path):
    """On gloo (2,) "dp" the remat'd train steps emit the same collectives
    (kind, count, bytes) as the un-remat'd twin, and the same loss (the
    JAX test's widths: seq 64, dim 64, batch 16)."""
    kw = dict(vocab=256, seq=64, dim=64, heads=4, layers=2)
    params = jax.tree.map(np.asarray, jgpt.gpt_init(
        jgpt.GPTConfig.tiny(**kw), jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(1).randint(
        0, kw["vocab"], (16, kw["seq"])).astype(np.int32)
    res = ranks.spawn("tests.test_torch_parallel_ranks:gpt_remat_modes", 2,
                      tmp_path, params=params, tokens=tokens, cfg_kw=kw,
                      modes=("none", "full", "dots"),
                      constants=JAX_CONSTANTS)
    for r in res:
        base = r["none"]
        assert base["collectives"], "the dp solve emitted no collective"
        for mode in ("full", "dots"):
            assert sorted(r[mode]["collectives"]) == \
                sorted(base["collectives"]), mode
            np.testing.assert_allclose(r[mode]["loss"], base["loss"],
                                       rtol=1e-5)
