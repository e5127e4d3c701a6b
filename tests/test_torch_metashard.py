"""ShardCombine parity: the port's `MetaOp.discover()` on the aten ops a
GPT-2 train step spends its time in, against the JAX package's on their
`jnp`/`lax` counterparts, and against the literal rule table.

The table (`GPT2_SMALL_RULES`) and the cases (`RULE_CASES`) live in
`chip_smoke.py`, which runs the same discovery at GPT-2 small's full width
on the card and holds each rule against the same table; these tests run
the cases at their narrow widths.

Inputs are uniform [0.5, 1.5] floats and integers in [1, 8), the JAX
frontend's convention (`jaxfront/interpreter.py:80-98`), made with numpy
from a seed and given to both packages.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from chip_smoke import (C0, C1, GPT2_SMALL_RULES, RULE_CASES, SUM, aten,
                        case_args, recombine_summary, rule_summary)
from easydist_tpu_torch import config as pconfig
from easydist_tpu_torch import platform as pplatform
from easydist_tpu_torch.metashard import MetaOp, match_recombine, view_rule
from easydist_tpu_torch.metashard import metaop as pmetaop


def numpy_args(specs, seed):
    rs = np.random.default_rng(seed)
    return case_args(
        specs,
        lambda shape: rs.uniform(0.5, 1.5, shape).astype(np.float32),
        lambda shape: rs.integers(1, 8, shape).astype(np.int64))


def discover_case(name, args, kwargs=None, world_size=2):
    """The port's rule for a case (`view` by `view_rule`, the rest by
    `MetaOp.discover`) in `rule_summary`'s form."""
    op = RULE_CASES[name][0]
    if op is aten.view.default:
        rule = view_rule(list(args[0].shape), list(args[1]),
                         world_size=world_size)
        return rule_summary(rule["space"], rule["recombines"])
    space, recombines = MetaOp(op, args, kwargs=kwargs, name=name).discover()
    return rule_summary(space, recombines)


# --------------------------------------------------------------- fixtures

@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setattr(pconfig, "discovery_device", "cpu")
    pplatform.init_backend("torch")
    yield
    pplatform.init_backend("torch")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's engine and the `jnp`/`lax` counterparts of the
    aten ops (same argument order and outputs)."""
    import jax
    import jax.numpy as jnp

    from easydist_tpu import platform as jplatform
    from easydist_tpu.metashard import MetaOp as JMetaOp
    from easydist_tpu.metashard import match_recombine as jmatch
    from easydist_tpu.metashard import view_rule as jview_rule
    from easydist_tpu.metashard import combination as jcomb

    def addmm(b, x, w):
        return b + jnp.matmul(x, w)

    def softmax(x, dim, half_to_float):
        return jax.nn.softmax(x, axis=dim)

    def log_softmax(x, dim, half_to_float):
        return jax.nn.log_softmax(x, axis=dim)

    def layer_norm(x, shape, w, b, eps):
        axes = tuple(range(x.ndim - len(shape), x.ndim))
        mean = jnp.mean(x, axis=axes, keepdims=True)
        var = jnp.mean(jnp.square(x - mean), axis=axes, keepdims=True)
        rstd = jax.lax.rsqrt(var + eps)
        return (x - mean) * rstd * w + b, mean, rstd

    def gelu(x, approximate="none"):
        return jax.nn.gelu(x, approximate=approximate == "tanh")

    def embedding(w, ids):
        return jnp.take(w, ids, axis=0)

    ops = {"addmm_c_attn": addmm, "addmm_c_fc": addmm, "addmm_c_proj": addmm,
           "mm_lm_head": jnp.matmul, "bmm_attn": jnp.matmul,
           "softmax": softmax, "layer_norm": layer_norm, "gelu": gelu,
           "add_bcast": jnp.add, "add_residual": jnp.add,
           "embedding": embedding, "log_softmax": log_softmax}
    return types.SimpleNamespace(jax=jax, jnp=jnp, platform=jplatform,
                                 MetaOp=JMetaOp, match=jmatch,
                                 view_rule=jview_rule, comb=jcomb, ops=ops)


@pytest.fixture
def jax_backend(ref):
    """The JAX package's process-global backend is "jax" before and after
    (tests/test_metashard/test_metaop.py:17-21)."""
    ref.platform.init_backend("jax")
    yield ref
    ref.platform.init_backend("jax")


# ------------------------------------------------------------ discovery

@pytest.mark.parametrize("name", sorted(GPT2_SMALL_RULES))
def test_port_rule_equals_table(name):
    op, _, narrow, kwargs = RULE_CASES[name]
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in numpy_args(narrow, seed=len(name))]
    assert discover_case(name, args, kwargs) == GPT2_SMALL_RULES[name]


@pytest.mark.parametrize("name", sorted(set(GPT2_SMALL_RULES) - {"view"}))
def test_port_rule_equals_jax(name, jax_backend):
    ref = jax_backend
    _, _, narrow, kwargs = RULE_CASES[name]
    np_args = numpy_args(narrow, seed=len(name))
    port = discover_case(
        name, [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in np_args], kwargs)
    jargs = [ref.jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in np_args]
    space, recombines = ref.MetaOp(ref.ops[name], jargs, kwargs=kwargs,
                                   name=name).discover()
    assert port == rule_summary(space, recombines) == GPT2_SMALL_RULES[name]


@pytest.mark.parametrize("k", [512, 2048])
def test_partial_sum_past_the_tolerance(k, jax_backend):
    """At K = 2048 addmm's bias is ~1/2048 of x @ w, under rtol 1e-3:
    the JAX package's engine accepts a partial sum of the contraction,
    which counts the bias twice; the port's zero probe rejects it.  The
    plain product keeps its partial sum in both."""
    ref = jax_backend
    rs = np.random.default_rng(k)
    b, x, w = (rs.uniform(0.5, 1.5, s).astype(np.float32)
               for s in ((4,), (6, k), (k, 4)))
    port = discover_case("addmm_c_fc", [torch.from_numpy(a) for a in (b, x, w)])
    jrule = rule_summary(*ref.MetaOp(ref.ops["addmm_c_fc"],
                                     [ref.jnp.asarray(a) for a in (b, x, w)]
                                     ).discover())
    assert port == GPT2_SMALL_RULES["addmm_c_fc"]
    if k == 2048:
        assert jrule == ([[1], [2, 3], [3, 1]], {1: C1, 2: C0, 3: SUM})
        # the rule is wrong: the partial sums add up to x @ w + 2 b
        parts = [b + x[:, :k // 2] @ w[:k // 2], b + x[:, k // 2:] @ w[k // 2:]]
        np.testing.assert_allclose(sum(parts) - (b + x @ w),
                                   np.broadcast_to(b, (6, 4)), rtol=1e-2)
    else:
        assert jrule == port
    mm = discover_case("mm_lm_head", [torch.from_numpy(x), torch.from_numpy(w)])
    jmm = rule_summary(*ref.MetaOp(ref.ops["mm_lm_head"],
                                   [ref.jnp.asarray(x), ref.jnp.asarray(w)]
                                   ).discover())
    assert mm == jmm == GPT2_SMALL_RULES["mm_lm_head"]


@pytest.mark.parametrize("shape", [(4, 8), (2, 4, 6)])
def test_reduce_rule_kept_where_zero_gives_nan(shape, jax_backend):
    """sum(x log x) over the last dim is NaN at x = 0 (0 * -inf): the zero
    probe matches NaN with NaN and keeps the partial sum over that dim,
    the rule the JAX package's engine finds without the probe."""
    ref = jax_backend
    x = np.random.default_rng(7).uniform(0.5, 1.5, shape).astype(np.float32)
    port = rule_summary(*MetaOp(lambda t: (t * torch.log(t)).sum(-1),
                                (torch.from_numpy(x),), name="xlogx"
                                ).discover())
    jrule = rule_summary(*ref.MetaOp(
        lambda t: ref.jnp.sum(t * ref.jnp.log(t), axis=-1),
        [ref.jnp.asarray(x)], name="xlogx").discover())
    assert port == jrule
    assert port[1][len(shape)] == SUM


def test_probes_restore_tf32_flags():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    seen = []

    def op(x, w):
        seen.append((matmul.allow_tf32, cudnn.allow_tf32))
        return x @ w

    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        rs = np.random.default_rng(0)
        MetaOp(op, (torch.from_numpy(rs.uniform(0.5, 1.5, (4, 6))),
                    torch.from_numpy(rs.uniform(0.5, 1.5, (6, 8))))).discover()
        assert seen and set(seen) == {(False, False)}
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


@pytest.mark.parametrize("batch", [True, False])
def test_in_place_op_probes_fresh_copies(batch, monkeypatch):
    """`aten.add_` writes its first argument: every probe gets copies, so
    the inputs stay as they were and the rule equals `aten.add`'s."""
    monkeypatch.setattr(pconfig, "discovery_batch_probes", batch)
    rs = np.random.default_rng(1)
    x = torch.from_numpy(rs.uniform(0.5, 1.5, (4, 6)).astype(np.float32))
    y = torch.from_numpy(rs.uniform(0.5, 1.5, (4, 6)).astype(np.float32))
    x0, y0 = x.clone(), y.clone()
    op = MetaOp(aten.add_.Tensor, (x, y), name="add_")
    assert op.writes_input
    before = pmetaop.probe_calls()
    got = rule_summary(*op.discover())
    assert torch.equal(x, x0) and torch.equal(y, y0)
    assert got == GPT2_SMALL_RULES["add_residual"]
    assert pmetaop.probe_calls() > before


# ------------------------------------------------------- pure functions

def _view_pairs(n, seed):
    """Seeded reshape pairs: a shape of 1-4 dims and the same elements
    regrouped by one to three merges of neighbouring dims, splits of a
    dim into two factors, or inserted 1s."""
    rs = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        shape = [int(v) for v in rs.choice([1, 2, 3, 4, 6, 8, 12],
                                           size=int(rs.integers(1, 5)))]
        out = list(shape)
        for _ in range(int(rs.integers(1, 4))):
            kind = int(rs.integers(0, 3))
            i = int(rs.integers(0, len(out)))
            if kind == 0 and i + 1 < len(out):
                out[i:i + 2] = [out[i] * out[i + 1]]
            elif kind == 1:
                f = next((f for f in (2, 3) if out[i] % f == 0
                          and out[i] > f), None)
                if f is not None:
                    out[i:i + 1] = [f, out[i] // f]
            else:
                out.insert(i, 1)
        pairs.append((shape, out))
    return pairs


VIEW_PAIRS = _view_pairs(12, seed=3)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_view_rule_identical(world, ref):
    for shape, out in VIEW_PAIRS:
        p = view_rule(shape, out, world_size=world)
        j = ref.view_rule(shape, out, world_size=world)
        assert rule_summary(p["space"], p["recombines"]) == \
            rule_summary(j["space"], j["recombines"]), (shape, out)


def _recombine_cases(seed):
    """Seeded (parts, target) pairs: concat along each dim, block-cyclic
    concat, a sum split, identical parts, a max split, and parts that
    match nothing."""
    rs = np.random.default_rng(seed)
    cases = []
    for shape in ([8], [4, 6], [2, 4, 6], [6, 4, 2, 2]):
        t = rs.uniform(0.5, 1.5, shape).astype(np.float32)
        for d in range(len(shape)):
            if shape[d] % 2 == 0:
                cases.append((np.split(t, 2, axis=d), t))
        if shape[0] % 4 == 0:
            blocks = np.split(t, 4, axis=0)
            cases.append(([np.concatenate(blocks[0::2]),
                           np.concatenate(blocks[1::2])], t))
        a = rs.uniform(0.5, 1.5, shape).astype(np.float32)
        cases.append(([a, t - a], t))
        cases.append(([t, t.copy()], t))
        b = rs.uniform(0.5, 1.5, shape).astype(np.float32)
        cases.append(([np.minimum(t, b), t], t))
        cases.append(([b, b + 1], t))
    return cases


RECOMBINE_CASES = _recombine_cases(seed=5)


def _match_summary(fn):
    if fn is None or isinstance(fn, (list, tuple)) and not fn:
        return None
    if type(fn).__name__ == "HaloHint":
        return ("halo", fn.width, fn.dim, fn.out_idx)
    return recombine_summary(fn)


@pytest.mark.parametrize("idx", range(len(RECOMBINE_CASES)))
def test_match_recombine_identical(idx, ref):
    """The port's `match_recombine` (torch backend) and the JAX package's
    (numpy backend) pick the same recombination."""
    parts, target = RECOMBINE_CASES[idx]
    ref.platform.init_backend("numpy")
    try:
        got = match_recombine([torch.from_numpy(p) for p in parts],
                              torch.from_numpy(target))
        want = ref.match(parts, target)
    finally:
        ref.platform.init_backend("jax")
    assert _match_summary(got) == _match_summary(want), \
        [p.shape for p in parts]


def test_match_recombine_numpy_backend_identical(ref):
    """The port's engine on its numpy backend: no torch op at all."""
    pplatform.init_backend("numpy")
    ref.platform.init_backend("numpy")
    try:
        for parts, target in RECOMBINE_CASES:
            assert _match_summary(match_recombine(parts, target)) == \
                _match_summary(ref.match(parts, target))
    finally:
        ref.platform.init_backend("jax")
