"""The attention composite and attention across ranks (the port's
`ops/attention_prim.py`, `parallel/`, and their presets and emission)
against the JAX package, from the same inputs made with numpy seeds.

  * the composite's ops (`ed_attention_fwd` / `_bwd`): outputs and
    gradients against `easydist_tpu.ops.attention_prim.attention`, both
    kept as single nodes by a `make_fx` trace of a train step;
  * the seq strategy's prices (`seq_strategy_costs`) against the JAX
    package's at the same constants, and the collectives the port counts
    for them summing to the same bytes;
  * `ring_attention` (einsum and flash blocks; the flash kernels' plain
    versions on the CPU) and `ulysses_attention` on gloo ranks (world 2)
    against the JAX functions (einsum ring, Ulysses) on a 2-device mesh
    and plain attention, outputs and gradients
    (tests/test_parallel/test_long_context.py);
  * the tiny GPT with attention="auto" compiled on gloo ranks, (2,) "sp"
    at batch 1 and one head (only the seq strategy can shard attention)
    and (2, 2) "dp" x "tp": the attention nodes' picks and variant equal
    the JAX package's, the losses equal its and eager torch's, and the
    emitted collectives equal the priced ones, ring permutes included.

The solver prices with the JAX package's cost constants, under which the
JAX tests were sized.  Tolerances: rtol 1e-4 / atol 1e-5 (the issue's
bar for ring and Ulysses; the JAX tests hold them at 1e-5 against plain
attention and 2e-4 / 2e-5 with flash blocks); GPT losses rtol 1e-4
(__graft_entry__.py:125).
"""

import pickle

import numpy as np
import pytest
import torch

from easydist_tpu_torch import config as tconfig
from easydist_tpu_torch.ops import attention_prim as tap
from tests import test_torch_fxfront_ranks as ranks
from tests.test_torch_fxfront_e2e import _jax_constants

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, b=2, h=4, t=32, d=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, t, d).astype(np.float32) for _ in range(3)]


def _jax_attention_and_grads(fn, arrays):
    import jax
    import jax.numpy as jnp

    q, k, v = (jnp.asarray(a) for a in arrays)
    out = fn(q, k, v)
    grads = jax.grad(lambda *x: jnp.mean(fn(*x) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------- the composite

@pytest.mark.parametrize("causal", [False, True])
def test_composite_matches_jax(causal):
    from easydist_tpu.ops.attention_prim import attention as jax_attention

    arrays = _qkv(0)
    want_out, want_grads = _jax_attention_and_grads(
        lambda q, k, v: jax_attention(q, k, v, causal=causal), arrays)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = tap.attention(q, k, v, causal=causal)
    grads = torch.autograd.grad((out ** 2).mean(), (q, k, v))
    _close(out.detach(), want_out)
    for g, w in zip(grads, want_grads):
        _close(g, w)


def test_composite_stays_two_nodes_under_make_fx():
    """A traced train step holds the forward and the backward op as one
    node each (reference attention_prim.py:103-130)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from easydist_tpu_torch.models.optim import value_and_grad

    arrays = [torch.from_numpy(a) for a in _qkv(1)]

    def step(q, k, v):
        return value_and_grad(
            lambda qkv: (tap.attention(*qkv) ** 2).mean(), [q, k, v])

    with torch.no_grad():
        gm = make_fx(step, tracing_mode="fake")(*arrays)
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets.count("easydist_tpu_torch.ed_attention_fwd.default") == 1
    assert targets.count("easydist_tpu_torch.ed_attention_bwd.default") == 1
    assert not any("bmm" in t or "softmax" in t for t in targets), targets


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("backward", [False, True])
def test_seq_strategy_costs_match_jax(n, backward, monkeypatch):
    """The port's prices on its NVLink constants equal the JAX package's
    on its ICI constants when the constants agree."""
    from easydist_tpu import config as jconfig
    from easydist_tpu.ops.attention_prim import \
        seq_strategy_costs as jax_costs

    monkeypatch.setattr(tconfig, "nvlink_bandwidth", jconfig.ici_bandwidth)
    monkeypatch.setattr(tconfig, "nvlink_latency", jconfig.ici_latency)
    monkeypatch.setattr(tconfig, "all_to_all_punish_factor",
                        jconfig.all_to_all_punish_factor)
    shape = (1, 12, 8192, 64)
    got = tap.seq_strategy_costs(shape, 4, n, backward)
    want = jax_costs(shape, 4, n, backward)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("variant", ["ring", "ulysses"])
@pytest.mark.parametrize("backward", [False, True])
def test_seq_collectives_sum_to_the_priced_bytes(variant, backward):
    """The collectives the port counts for a seq strategy move, on the
    cost model's wire formulas, exactly the bytes `seq_strategy_costs`
    prices (latency and bandwidth terms apart)."""
    from easydist_tpu_torch.autoflow.cost_model import collective_wire_bytes

    b, h, t, d, n = 1, 12, 8192, 64, 8
    tensor = b * h * t * d * 4
    mult = 2 if backward else 1
    colls = tap.seq_collectives(tensor, n, backward, variant)
    wire = sum(collective_wire_bytes(k, x, n) for k, x in colls)
    if variant == "ring":
        want = 2.0 * (n - 1) / n * tensor * mult
        assert len(colls) == 2 * (n - 1) * mult
    else:
        want = (4.0 * (n - 1) / (n * n) * tensor
                * tconfig.all_to_all_punish_factor * mult)
        assert len(colls) == 4 * mult
    np.testing.assert_allclose(wire, want, rtol=1e-12)


def test_seq_variant_rechecks_ulysses_heads():
    assert tap.seq_variant("ulysses", 12, 8) == "ring"
    assert tap.seq_variant("ulysses", 16, 8) == "ulysses"
    assert tap.seq_variant("ring", 16, 8) == "ring"


# ------------------------------------------------------ across gloo ranks

@pytest.fixture(scope="module")
def long_context(tmp_path_factory, cpu_devices):
    """The port's programs on two gloo ranks, and the JAX package's
    einsum ring and Ulysses on a 2-device mesh."""
    from jax.sharding import Mesh

    from easydist_tpu.parallel import ring_attention as jring
    from easydist_tpu.parallel import ulysses_attention as julysses

    tmp = tmp_path_factory.mktemp("long_context")
    arrays = _qkv(2, b=2, h=4, t=32, d=8)
    with open(tmp / "qkv.pkl", "wb") as f:
        pickle.dump(arrays, f)
    out = ranks.spawn("long_context", 2, tmp, qkv=str(tmp / "qkv.pkl"))
    mesh = Mesh(np.array(cpu_devices[:2]), ("sp",))
    jax_fns = {
        "ring": lambda c: lambda q, k, v: jring(
            q, k, v, mesh, "sp", causal=c, block_impl="einsum"),
        "ulysses": lambda c: lambda q, k, v: julysses(
            q, k, v, mesh, "sp", causal=c)}
    want = {(name, c): _jax_attention_and_grads(make(c), arrays)
            for name, make in jax_fns.items() for c in (False, True)}
    return arrays, out, want


@pytest.mark.parametrize("program", ["ring", "flash", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_long_context_matches_jax(long_context, program, causal):
    """The port's flash-block ring (plain versions of B1-B3 here) is held
    against the JAX package's einsum ring: the same function, and the JAX
    flash ring runs its Pallas kernels in interpret mode, too slow for
    this file's budget."""
    arrays, out, want = long_context
    want_out, want_grads = want[("ulysses" if program == "ulysses"
                                 else "ring", causal)]
    for r in out:
        got = r[(program, causal)]
        _close(got["out"], want_out)
        for g, w in zip(got["grads"], want_grads):
            _close(g, w)


@pytest.mark.parametrize("program", ["ring", "flash", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_long_context_matches_plain_attention(long_context, program,
                                              causal):
    arrays, out, _ = long_context
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    o = tap._einsum_attention(q, k, v, causal, 8 ** -0.5)
    grads = torch.autograd.grad((o ** 2).mean(), (q, k, v))
    got = out[0][(program, causal)]
    _close(got["out"], o.detach())
    for g, w in zip(got["grads"], grads):
        _close(g, w)


def test_ring_hops_as_priced(long_context):
    """World 2: a forward hops K and V once; the backward recomputes that
    and sends both cotangents back once (2 (n-1) x 3 permutes a call)."""
    _, out, _ = long_context
    for r in out:
        for causal in (False, True):
            assert r[("ring", causal)]["hops"] == 6
            assert r[("ulysses", causal)]["hops"] == 0


# ---------------------------------------------- the tiny GPT, "auto"

SEQ_CFG = dict(vocab=128, seq=1024, dim=64, heads=1, layers=1)
MESH_CFG = dict(vocab=128, seq=1024, dim=64, heads=2, layers=1)
CASES = {"sp": (SEQ_CFG, (2,), ("sp",), 1),
         "dp_tp": (MESH_CFG, (2, 2), ("dp", "tp"), 2)}
STEPS = 3


def _jax_picks(result):
    keys = {n.name: n.op_key for n in result.graph.ops
            if n.op_key.startswith("ed_attention")}
    return [sorted((keys[name].split("_")[2], ranks.attention_pick(s))
                   for name, s in chosen.items() if name in keys)
            for chosen in result.strategies]


@pytest.fixture(scope="module", params=list(CASES))
def gpt_auto(request, tmp_path_factory, cpu_devices):
    import jax
    from jax.sharding import Mesh

    from easydist_tpu.jaxfront import easydist_compile as jax_compile
    from easydist_tpu.models import gpt as jg

    cfg, shape, names, batch = CASES[request.param]
    rs = np.random.RandomState(1)
    tokens = [rs.randint(0, cfg["vocab"], (batch, cfg["seq"]))
              .astype(np.int32) for _ in range(2)]
    world = int(np.prod(shape))
    mesh = Mesh(np.array(cpu_devices[:world]).reshape(shape), names)
    step, init = jg.make_gpt_train_step(jg.GPTConfig.tiny(
        **cfg, attention="auto"))
    state0 = init(jax.random.PRNGKey(0))
    picks = _jax_picks(jax_compile(step, mesh=mesh, compile_only=True)(
        state0, *tokens))
    compiled = jax_compile(step, mesh=mesh, donate_state=False)
    state, losses = state0, []
    for _ in range(STEPS):
        state, loss = compiled(state, *tokens)
        losses.append(float(loss))
    tmp = tmp_path_factory.mktemp(f"gpt_auto_{request.param}")
    with open(tmp / "state.pkl", "wb") as f:
        pickle.dump({"cfg": cfg, "tokens": tokens,
                     "state": jax.tree.map(np.asarray, state0)}, f)
    out = ranks.spawn("gpt_auto", world, tmp, constants=_jax_constants(),
                      gpt_state=str(tmp / "state.pkl"), shape=shape,
                      names=names, steps=STEPS)
    return request.param, out, picks, losses


def test_gpt_auto_picks_match_jax(gpt_auto):
    case, out, picks, _ = gpt_auto
    for r in out:
        assert r["picks"] == picks, (r["picks"], picks)
    if case == "sp":
        assert picks == [[("bwd", "S(2):ring"), ("fwd", "S(2):ring")]]


def test_gpt_auto_losses_match_jax_and_eager(gpt_auto):
    _, out, _, jax_losses = gpt_auto
    for r in out:
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=1e-4)
        np.testing.assert_allclose(r["losses"], r["eager"], rtol=1e-4)


def test_gpt_auto_emitted_equals_priced(gpt_auto):
    """Per axis and kind, the collectives emission inserted equal those
    the solver priced, in count and wire bytes; on "sp" the ring's
    permutes are among them and every one of them ran."""
    case, out, _, _ = gpt_auto
    for r in out:
        for axis, (emitted, priced) in r["table"].items():
            assert sorted(emitted) == sorted(priced), (axis, emitted, priced)
            for kind in emitted:
                assert emitted[kind][0] == priced[kind][0]
                np.testing.assert_allclose(emitted[kind][1],
                                           priced[kind][1], rtol=1e-9)
        if case == "sp":
            per_step = r["table"]["sp"][0]["ppermute"][0]
            assert per_step == 6 * SEQ_CFG["layers"]
            assert r["hops"] == STEPS * per_step


@pytest.mark.parametrize("variant", ["ring", "ulysses"])
@pytest.mark.parametrize("op", ["fwd", "bwd"])
def test_seq_emission_matches_the_whole_op(long_context, variant, op):
    """Each variant's lowering of each op, on seq shards over two gloo
    ranks, gives the op's whole result (gathered back to R), and records
    the collectives `seq_collectives` counts (ring: 2 (n-1) permutes
    forward, 4 (n-1) backward; Ulysses: 4 all_to_alls, 8 backward),
    besides the output all_gathers."""
    n = 2
    want = ({"ring": ["ppermute"] * (2 * (n - 1)),
             "ulysses": ["all_to_all"] * 4}[variant]
            * (2 if op == "bwd" else 1))
    for r in long_context[1]:
        err, kinds = r["emit"][(variant, op)]
        assert err <= 1e-5, err
        assert [k for k in kinds if k != "all_gather"] == want, kinds
        assert kinds.count("all_gather") == (3 if op == "bwd" else 1)
