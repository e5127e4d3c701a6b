"""Port training attention (easydist_tpu_torch.ops.flash_attention, B1-B3)
against the JAX package: the plain forward against the Pallas forward in
interpret mode (out and lse), the plain backward against `jax.vjp` of
`flash_attention_lse` with both cotangents, the port's autograd through
its custom ops against torch autograd through `_reference_attention`,
the traced graph's nodes, a plain emulation of the tensor-core kernels'
rounding (bf16: P and dS split into bf16 hi + lo halves; the f32
forward, dQ and dK/dV: every operand split into TF32 hi + lo halves,
three products) against the plain versions, and — on a CUDA host — each
kernel against its plain version and the f32 kernels against a float64
reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: forward rtol 1e-4 / atol 1e-5, backward rtol 2e-4 / atol
2e-5 in float32 (the bars of tests/test_ops/test_flash_attention.py); a
bf16 output adds half an ulp of its rounding, 2^-8 |ref| (the bars of
chip_smoke.py)."""

import importlib
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from easydist_tpu_torch.ops import flash_attention as tfa

FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
BF16_ULP = 2.0 ** -8  # half an ulp of a bf16 output, relative


def _rand(b=2, h=3, t=64, d=16, seed=0, n=4):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.fixture(scope="module")
def jax_ops():
    """(jax, jax.numpy, the JAX package's ops/flash_attention module),
    imported here so the card's tests collect on a host without JAX."""
    jax = pytest.importorskip("jax")
    return (jax, jax.numpy,
            importlib.import_module("easydist_tpu.ops.flash_attention"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class TestPlainVsJax:
    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_matches_pallas_interpret(self, jax_ops, causal):
        _, jnp, jfa = jax_ops
        q, k, v = _rand(n=3)
        out_j, lse_j = jfa.flash_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 16,
            16, True)
        out, lse = tfa._flash_forward_xla(*_t(q, k, v), causal,
                                          1.0 / math.sqrt(16))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **FWD)

    def test_forward_uneven_blocks(self, jax_ops):
        # T = 48 with 32-row blocks: the JAX kernel shrinks its block
        _, jnp, jfa = jax_ops
        q, k, v = _rand(t=48, d=32, seed=1, n=3)
        out_j, lse_j = jfa.flash_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, None, 32,
            32, True)
        out, lse = tfa.flash_attention_lse(*_t(q, k, v), True, None, 32, 32)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **FWD)

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("with_g_lse", [True, False])
    def test_backward_matches_jax_vjp(self, jax_ops, causal, with_g_lse):
        jax, jnp, jfa = jax_ops
        q, k, v, do = _rand(t=48, seed=2)
        rs = np.random.RandomState(3)
        g_lse = (rs.standard_normal((2 * 3, 48)).astype(np.float32)
                 if with_g_lse else np.zeros((2 * 3, 48), np.float32))
        (out_j, _), vjp = jax.vjp(
            lambda a, b, c: jfa.flash_attention_lse(a, b, c, causal, None,
                                                    16, 16, True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
        scale = 1.0 / math.sqrt(16)
        out, lse = tfa._flash_forward_xla(*_t(q, k, v), causal, scale)
        got = tfa._flash_backward_xla(
            *_t(q, k, v), out, lse, torch.from_numpy(do), causal, scale,
            torch.from_numpy(g_lse) if with_g_lse else None)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD)

    def test_reference_attention_matches_jax(self, jax_ops):
        _, jnp, jfa = jax_ops
        q, k, v = _rand(n=3, seed=4)
        want = jfa._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), True, 0.25)
        got = tfa._reference_attention(*_t(q, k, v), True, 0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


class TestAutograd:
    @pytest.mark.parametrize("causal", [True, False])
    def test_grads_match_reference_attention(self, causal):
        q, k, v = (x.requires_grad_() for x in _t(*_rand(t=48, n=3,
                                                          seed=5)))
        out = tfa.flash_attention(q, k, v, causal)
        torch.sum(out * torch.cos(out)).backward()
        got = [x.grad.clone() for x in (q, k, v)]
        for x in (q, k, v):
            x.grad = None
        ref = tfa._reference_attention(q, k, v, causal, 0.25)
        torch.sum(ref * torch.cos(ref)).backward()
        for g, x in zip(got, (q, k, v)):
            np.testing.assert_allclose(g.numpy(), x.grad.numpy(), **BWD)

    def test_lse_output_is_differentiable(self):
        q, k, v, do = _t(*_rand(t=32, seed=6))
        g_lse = torch.from_numpy(
            np.random.RandomState(7).standard_normal((6, 32)).astype(
                np.float32))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = tfa.flash_attention_lse(*leaves, True)
        got = torch.autograd.grad((out * do).sum() + (lse * g_lse).sum(),
                                  leaves)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = tfa._reference_attention(*leaves, True, 0.25)
        ref_lse = torch.logsumexp(
            tfa._masked_scores(leaves[0], leaves[1], True, 0.25),
            dim=-1).reshape(6, 32)
        want = torch.autograd.grad(
            (ref * do).sum() + (ref_lse * g_lse).sum(), leaves)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD)

    def test_block_hints_do_not_change_the_result(self):
        q, k, v = _t(*_rand(t=40, n=3, seed=8))
        a = tfa.flash_attention(q, k, v, True, None, 16, 16)
        b = tfa.flash_attention(q, k, v, True, None, 256, 128)
        assert torch.equal(a, b)


class TestTracing:
    def test_graph_holds_one_node_per_op_and_launches_nothing(self):
        def step(q, k, v):
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                out = tfa.flash_attention(*leaves, True)
                return torch.autograd.grad((out ** 2).sum(), leaves)

        before = [tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                  tfa.flash_bwd_dkv.launches]
        with torch.no_grad():
            gm = make_fx(step, tracing_mode="fake")(*_t(*_rand(n=3)))
        targets = [str(n.target) for n in gm.graph.nodes]
        for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert targets.count(f"easydist_tpu_torch.{op}.default") == 1
        # CPU tensors run the plain versions: no kernel launch counted
        grads = gm(*_t(*_rand(n=3)))
        assert [g.shape for g in grads] == [(2, 3, 64, 16)] * 3
        assert before == [tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                          tfa.flash_bwd_dkv.launches]

    def test_fake_shapes(self):
        q, k, v, do = _t(*_rand(t=24, seed=9))
        k, v = k[:, :, :20], v[:, :, :20]

        def f(q, k, v, do):
            out, lse = tfa.flash_fwd(q, k, v, False)
            delta = tfa._flash_delta(out, do)
            return (out, lse, tfa.flash_bwd_dq(q, k, v, do, lse, delta,
                                               False),
                    *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, False))

        with FakeTensorMode() as mode:
            fake = f(*(mode.from_tensor(x) for x in (q, k, v, do)))
        real = f(q, k, v, do)
        assert [tuple(x.shape) for x in fake] == [tuple(x.shape)
                                                  for x in real]
        assert [x.dtype for x in fake] == [x.dtype for x in real]
        assert real[1].shape == (6, 24) and real[1].dtype == torch.float32


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split_product(eq: str, a, b, split: bool):
    """einsum(eq, a, b) as the tensor-core kernels form it: b holds bf16
    values, a (f32 P or dS) enters as bf16 hi + lo halves (`split`) or as
    one bf16 cast.  Products of bf16 values are exact in f32; sums f32."""
    hi = _bf16(a)
    out = torch.einsum(eq, hi, b)
    return out + torch.einsum(eq, _bf16(a - hi), b) if split else out


def _emulated_forward(q, k, v, causal: bool, scale: float, split: bool):
    """B1's rounding points: S = Q.K^T in f32 scaled after the product,
    f32 softmax, O = P.V over P's halves, out rounded to bf16 once."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = tfa._causal_fill(s)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = _split_product("bhqk,bhkd->bhqd", p, v, split) / l_safe
    return out.to(torch.bfloat16)


def _emulated_p_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P = exp(S scale - lse) and dS = P (dO.V^T - delta) in f32, with S
    and dP exact products of the bf16 inputs, as B2 and B3 form them."""
    b, h, t_q, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = tfa._causal_fill(s)
    p = torch.exp(s - lse.reshape(b, h, t_q, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    return p, p * (dp - delta.reshape(b, h, t_q, 1))


def _emulated_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 split: bool):
    """B2's rounding points: P and dS in f32, dQ = dS.K over dS's
    halves, times scale, rounded to bf16 once."""
    _, ds = _emulated_p_ds(q, k, v, do, lse, delta, causal, scale)
    dq = _split_product("bhqk,bhkd->bhqd", ds, k, split) * scale
    return dq.to(torch.bfloat16)


def _emulated_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  split: bool):
    """B3's rounding points: P and dS in f32, dV = P^T.dO and dK =
    dS^T.Q * scale over the halves of P and dS, both rounded to bf16
    once."""
    p, ds = _emulated_p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = _split_product("bhqk,bhqd->bhkd", p, do, split)
    dk = _split_product("bhqk,bhqd->bhkd", ds, q, split) * scale
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _worst(got, ref, rtol: float, atol: float, ulp: float = BF16_ULP
           ) -> float:
    """The largest |got - ref| / (atol + (rtol + ulp) |ref|)."""
    tol = atol + (rtol + ulp) * ref.abs()
    return ((got.float() - ref).abs() / tol).max().item()


def _tf32(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to 10 mantissa
    bits, to nearest, ties away from zero (add half of the dropped 13
    bits to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq: str, a, b, split: bool):
    """einsum(eq, a, b) as the f32 forward kernel forms it on the tensor
    cores: every operand as TF32 halves hi = tf32(x), lo = tf32(x - hi),
    and the three products a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (`split`),
    or one TF32 product of one cast each.  Products of TF32 values are
    exact in f32; sums f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if split:
        out = (out + torch.einsum(eq, a_hi, _tf32(b - b_hi))
               + torch.einsum(eq, _tf32(a - a_hi), b_hi))
    return out


def _emulated_forward_tf32(q, k, v, causal: bool, scale: float,
                           split: bool):
    """The f32 B1's rounding points: S = Q.K^T and O = P.V through
    `_tf32_product`, S scaled after the product, the softmax in f32, out
    and lse = m + log(l) in f32."""
    b, h, t_q, _ = q.shape
    s = _tf32_product("bhqd,bhkd->bhqk", q, k, split) * scale
    if causal:
        s = tfa._causal_fill(s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = _tf32_product("bhqk,bhkd->bhqd", p, v, split) / l_safe
    return out, (m + torch.log(l_safe)).reshape(b * h, t_q)


def _emulated_p_ds_tf32(q, k, v, do, lse, delta, causal: bool, scale: float,
                        split: bool):
    """The f32 B2's and B3's P and dS: S = Q.K^T and dP = dO.V^T through
    `_tf32_product`, S scaled after the product, P = exp(S - lse) from the
    saved lse, dS = P (dP - delta), all in f32."""
    b, h, t_q, _ = q.shape
    s = _tf32_product("bhqd,bhkd->bhqk", q, k, split) * scale
    if causal:
        s = tfa._causal_fill(s)
    p = torch.exp(s - lse.reshape(b, h, t_q, 1))
    dp = _tf32_product("bhqd,bhkd->bhqk", do, v, split)
    return p, p * (dp - delta.reshape(b, h, t_q, 1))


def _emulated_dq_tf32(q, k, v, do, lse, delta, causal: bool, scale: float,
                      split: bool):
    """The f32 B2's rounding points: P and dS as above, then dQ = dS.K
    through `_tf32_product` (dS split in registers like every operand),
    times scale, in f32."""
    _, ds = _emulated_p_ds_tf32(q, k, v, do, lse, delta, causal, scale,
                                split)
    return _tf32_product("bhqk,bhkd->bhqd", ds, k, split) * scale


def _emulated_dkv_tf32(q, k, v, do, lse, delta, causal: bool, scale: float,
                       split: bool):
    """The f32 B3's rounding points: P^T and dS^T as above (the kernel
    forms them transposed; the values are the same), dV = P^T.dO and
    dK = dS^T.Q * scale through `_tf32_product`, in f32."""
    p, ds = _emulated_p_ds_tf32(q, k, v, do, lse, delta, causal, scale,
                                split)
    dv = _tf32_product("bhqk,bhqd->bhkd", p, do, split)
    dk = _tf32_product("bhqk,bhqd->bhkd", ds, q, split) * scale
    return dk, dv


class TestSplitRounding:
    """The bf16 tensor-core B1-B3 feed P and dS to their products as
    bf16 hi + lo halves.  Emulated on the CPU at a small causal size, the
    split holds the bars the kernels are held to on the card; one bf16
    cast of P (and dS) does not, so a change that drops the split has to
    change the bars in the open."""

    @staticmethod
    def _inputs():
        q, k, v, do = (_bf16(x) for x in _t(*_rand(b=1, h=2, t=128, d=64,
                                                     seed=10)))
        return q, k, v, do, 1.0 / math.sqrt(64)

    @pytest.mark.parametrize("split", [True, False], ids=["hi_lo", "one_cast"])
    def test_forward_out_within_bar_only_with_split(self, split):
        q, k, v, _, scale = self._inputs()
        ref, _ = tfa._flash_forward_xla(q, k, v, True, scale)
        worst = _worst(_emulated_forward(q, k, v, True, scale, split),
                       ref.float(), **FWD)
        assert (worst <= 1.0) == split, worst

    @pytest.mark.parametrize("split", [True, False], ids=["hi_lo", "one_cast"])
    def test_dkv_within_bar_only_with_split(self, split):
        q, k, v, do, scale = self._inputs()
        out, lse = tfa._flash_forward_xla(q, k, v, True, scale)
        delta = tfa._flash_delta(out, do)
        ref_dk, ref_dv = tfa._flash_bwd_dkv_xla(q, k, v, do, lse, delta, True,
                                                scale)
        dk, dv = _emulated_dkv(q, k, v, do, lse, delta, True, scale, split)
        worst = [_worst(dk, ref_dk, **BWD), _worst(dv, ref_dv, **BWD)]
        assert all((w <= 1.0) == split for w in worst), worst

    @pytest.mark.parametrize("split", [True, False], ids=["hi_lo", "one_cast"])
    def test_dq_within_bar_only_with_split(self, split):
        q, k, v, do, scale = self._inputs()
        out, lse = tfa._flash_forward_xla(q, k, v, True, scale)
        delta = tfa._flash_delta(out, do)
        ref = tfa._flash_bwd_dq_xla(q, k, v, do, lse, delta, True, scale)
        dq = _emulated_dq(q, k, v, do, lse, delta, True, scale, split)
        worst = _worst(dq, ref, **BWD)
        assert (worst <= 1.0) == split, worst

    @pytest.mark.parametrize("split", [True, False],
                             ids=["tf32_three_products", "tf32_one_cast"])
    def test_f32_forward_within_bar_only_with_tf32_split(self, split):
        # the f32 B1 on the tensor cores: out and lse at the f32 bar
        # (no output rounding: rtol 1e-4 / atol 1e-5 alone)
        q, k, v = _t(*_rand(b=1, h=2, t=128, d=64, seed=11, n=3))
        scale = 1.0 / math.sqrt(64)
        ref_out, ref_lse = tfa._flash_forward_xla(q, k, v, True, scale)
        out, lse = _emulated_forward_tf32(q, k, v, True, scale, split)
        worst = [_worst(out, ref_out, **FWD, ulp=0.0),
                 _worst(lse, ref_lse, **FWD, ulp=0.0)]
        print(f"tf32 {'three products' if split else 'one cast'}: worst "
              f"err/tol out {worst[0]:.4f}, lse {worst[1]:.4f}")
        if split:
            assert max(worst) <= 1.0, worst
        else:
            assert max(worst) > 1.0, worst

    @staticmethod
    def _f32_backward_inputs():
        q, k, v, do = _t(*_rand(b=1, h=2, t=128, d=64, seed=12))
        scale = 1.0 / math.sqrt(64)
        out, lse = tfa._flash_forward_xla(q, k, v, True, scale)
        return q, k, v, do, lse, tfa._flash_delta(out, do), scale

    @pytest.mark.parametrize("split", [True, False],
                             ids=["tf32_three_products", "tf32_one_cast"])
    def test_f32_dq_within_bar_only_with_tf32_split(self, split):
        # the f32 B2 on the tensor cores: nine TF32 products (S, dP, dQ),
        # dQ at the f32 backward bar (no output rounding)
        q, k, v, do, lse, delta, scale = self._f32_backward_inputs()
        ref = tfa._flash_bwd_dq_xla(q, k, v, do, lse, delta, True, scale)
        dq = _emulated_dq_tf32(q, k, v, do, lse, delta, True, scale, split)
        worst = _worst(dq, ref, **BWD, ulp=0.0)
        print(f"tf32 {'three products' if split else 'one cast'}: worst "
              f"err/tol dq {worst:.4f}")
        assert (worst <= 1.0) == split, worst

    @pytest.mark.parametrize("split", [True, False],
                             ids=["tf32_three_products", "tf32_one_cast"])
    def test_f32_dkv_within_bar_only_with_tf32_split(self, split):
        # the f32 B3: twelve TF32 products (S^T, dP^T, dV, dK), dK and dV
        # at the f32 backward bar
        q, k, v, do, lse, delta, scale = self._f32_backward_inputs()
        ref_dk, ref_dv = tfa._flash_bwd_dkv_xla(q, k, v, do, lse, delta, True,
                                                scale)
        dk, dv = _emulated_dkv_tf32(q, k, v, do, lse, delta, True, scale,
                                    split)
        worst = [_worst(dk, ref_dk, **BWD, ulp=0.0),
                 _worst(dv, ref_dv, **BWD, ulp=0.0)]
        print(f"tf32 {'three products' if split else 'one cast'}: worst "
              f"err/tol dk {worst[0]:.4f}, dv {worst[1]:.4f}")
        if split:
            assert max(worst) <= 1.0, worst
        else:
            assert max(worst) > 1.0, worst

    def test_tf32_rounding_is_rna(self):
        # ties away from zero at the 13th bit, both signs; exact values kept
        one = 1.0 + 2.0 ** -10
        x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                          1.0 + 2.0 ** -12, one, 0.0, -2.5],
                         dtype=torch.float32)
        assert _tf32(x).tolist() == [one, -one, 1.0, one, 0.0, -2.5]


@pytest.mark.cuda
class TestKernelsOnCard:
    """B1-B3 against their plain versions at the training shape and at the
    edges of the tensor-core kernels' tiles: one row past a tile (129),
    a ragged length (1000), fewer queries than keys (192 over 1024, full
    and causal), a single row block, head_dim 128.  A bf16 output adds
    half an ulp of its rounding (2^-8 |ref|) to the f32 bar: the kernels
    round once (the bf16 B1-B3 split P and dS hi/lo so their products
    keep f32 accuracy; see TestSplitRounding)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal,t_q,t_k,b,h", [
        (True, 1024, 1024, 2, 12), (False, 1024, 1024, 2, 12),
        (True, 1000, 1000, 2, 12), (True, 129, 129, 2, 12),
        (True, 192, 1024, 2, 12), (False, 192, 1024, 2, 12),
        (True, 1024, 1024, 1, 1)])
    @pytest.mark.parametrize("d", [64, 128])
    def test_kernels_match_plain(self, cuda_device, dtype, causal, t_q, t_k,
                                 b, h, d):
        rs = np.random.RandomState(0)
        q, k, v, do = (
            torch.as_tensor(rs.standard_normal((b, h, t, d)),
                            dtype=torch.float32, device=cuda_device).to(dtype)
            for t in (t_q, t_k, t_k, t_q))
        g_lse = torch.as_tensor(rs.standard_normal((b * h, t_q)),
                                dtype=torch.float32, device=cuda_device)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        scale = 1.0 / math.sqrt(d)
        extra = BF16_ULP if dtype == torch.bfloat16 else 0.0

        def close(got, ref, rtol, atol, rounded=True):
            tol = atol + (rtol + (extra if rounded else 0.0)) * ref.abs()
            assert bool(((got.float() - ref).abs() <= tol).all())

        before = tfa.flash_fwd.launches
        out, lse = tfa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        assert tfa.flash_fwd.launches == before + 1
        ref_out, ref_lse = tfa._flash_forward_xla(qf, kf, vf, causal, scale)
        close(out, ref_out, **FWD)
        close(lse, ref_lse, **FWD, rounded=False)
        delta = tfa._flash_delta(ref_out, dof, g_lse)
        dq = tfa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal,
                                   scale)
        torch.cuda.synchronize()
        close(dq, tfa._flash_bwd_dq_xla(qf, kf, vf, dof, ref_lse, delta,
                                        causal, scale), **BWD)
        r_dk, r_dv = tfa._flash_bwd_dkv_xla(qf, kf, vf, dof, ref_lse, delta,
                                            causal, scale)
        close(dk, r_dk, **BWD)
        close(dv, r_dv, **BWD)

    @pytest.mark.parametrize("d", [64, 128])
    def test_two_launches_are_bitwise_equal(self, cuda_device, d):
        # no atomics and a fixed order of sums: B1-B3 are deterministic
        rs = np.random.RandomState(1)
        q, k, v, do = (torch.as_tensor(rs.standard_normal((2, 12, 1000, d)),
                                       dtype=torch.bfloat16,
                                       device=cuda_device)
                       for _ in range(4))
        runs = []
        for _ in range(2):
            out, lse = tfa.flash_fwd(q, k, v, True)
            delta = tfa._flash_delta(out, do)
            runs.append((out, lse,
                         tfa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                         *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, True)))
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("causal,t_q,t_k", [
        (True, 1, 1), (True, 63, 63), (True, 65, 65), (False, 200, 77),
        (True, 77, 200), (True, 1000, 1000), (True, 129, 129)])
    @pytest.mark.parametrize("d", [64, 128])
    def test_f32_forward_ragged_tiles(self, cuda_device, causal, t_q, t_k,
                                      d):
        # the three-product TF32 forward at tile edges: fewer rows than a
        # query or key tile, a ragged last tile, more keys than queries
        rs = np.random.RandomState(2)
        q, k, v = (torch.as_tensor(rs.standard_normal((2, 3, t, d)),
                                   dtype=torch.float32, device=cuda_device)
                   for t in (t_q, t_k, t_k))
        scale = 1.0 / math.sqrt(d)
        out, lse = tfa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = tfa._flash_forward_xla(q, k, v, causal, scale)
        for got, ref in ((out, ref_out), (lse, ref_lse)):
            tol = FWD["atol"] + FWD["rtol"] * ref.abs()
            assert bool(((got - ref).abs() <= tol).all())

    @pytest.mark.parametrize("causal,t,d", [(True, 256, 64),
                                            (False, 256, 64),
                                            (True, 1000, 128)])
    def test_f32_forward_near_float64(self, cuda_device, causal, t, d):
        # the three TF32 products keep the forward within a few f32 ulps
        # of the exact function (a float64 reference): far inside the
        # f32 bar, where one TF32 cast would land ~1e-4 off
        rs = np.random.RandomState(4)
        q, k, v = (torch.as_tensor(rs.standard_normal((1, 2, t, d)),
                                   dtype=torch.float32, device=cuda_device)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out, lse = tfa.flash_fwd(q, k, v, causal, scale)
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
        if causal:
            s = tfa._causal_fill(s)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l_sum = p.sum(dim=-1, keepdim=True)
        ref_out = torch.einsum("bhqk,bhkd->bhqd", p, v.double()) / l_sum
        ref_lse = (m + torch.log(l_sum)).reshape(2, t)
        errs = [(out.double() - ref_out).abs().max().item(),
                (lse.double() - ref_lse).abs().max().item()]
        print(f"f32 B1 vs float64, causal {causal} t {t} d {d}: max abs "
              f"err out {errs[0]:.3e}, lse {errs[1]:.3e}")
        assert max(errs) <= 1e-5, errs

    @pytest.mark.parametrize("d", [64, 128])
    def test_f32_forward_two_launches_are_bitwise_equal(self, cuda_device,
                                                        d):
        rs = np.random.RandomState(3)
        q, k, v = (torch.as_tensor(rs.standard_normal((2, 12, 1000, d)),
                                   dtype=torch.float32, device=cuda_device)
                   for _ in range(3))
        first = tfa.flash_fwd(q, k, v, True)
        second = tfa.flash_fwd(q, k, v, True)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("causal,t_q,t_k", [
        (True, 1, 1), (True, 63, 63), (True, 65, 65), (False, 200, 77),
        (True, 77, 200), (False, 77, 200)])
    @pytest.mark.parametrize("d", [64, 128])
    def test_f32_backward_ragged_tiles(self, cuda_device, causal, t_q, t_k,
                                       d):
        # the TF32 B2 and B3 at tile edges: fewer rows than a query or key
        # tile, a ragged last tile, more keys than queries and fewer (the
        # longer ragged lengths are test_kernels_match_plain's)
        rs = np.random.RandomState(5)
        q, k, v, do = (torch.as_tensor(rs.standard_normal((2, 3, t, d)),
                                       dtype=torch.float32,
                                       device=cuda_device)
                       for t in (t_q, t_k, t_k, t_q))
        g_lse = torch.as_tensor(rs.standard_normal((6, t_q)),
                                dtype=torch.float32, device=cuda_device)
        scale = 1.0 / math.sqrt(d)
        ref_out, ref_lse = tfa._flash_forward_xla(q, k, v, causal, scale)
        delta = tfa._flash_delta(ref_out, do, g_lse)
        dq = tfa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal,
                                   scale)
        torch.cuda.synchronize()
        r_dq = tfa._flash_bwd_dq_xla(q, k, v, do, ref_lse, delta, causal,
                                     scale)
        r_dk, r_dv = tfa._flash_bwd_dkv_xla(q, k, v, do, ref_lse, delta,
                                            causal, scale)
        for got, ref in ((dq, r_dq), (dk, r_dk), (dv, r_dv)):
            tol = BWD["atol"] + BWD["rtol"] * ref.abs()
            assert bool(((got - ref).abs() <= tol).all())

    @pytest.mark.parametrize("causal,t,d", [(True, 256, 64),
                                            (False, 256, 64),
                                            (True, 1000, 128),
                                            (False, 256, 128)])
    def test_f32_backward_near_float64_past_first_tile(self, cuda_device,
                                                       causal, t, d):
        # the TF32 B2/B3 against the exact function (float64) on the rows
        # and keys past each kernel's first tile (queries and keys >= 64):
        # resident operands reused across tiles must not drift towards
        # one-cast accuracy (~1e-4) there
        rs = np.random.RandomState(6)
        q, k, v, do = (torch.as_tensor(rs.standard_normal((1, 2, t, d)),
                                       dtype=torch.float32,
                                       device=cuda_device)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        out, lse = tfa._flash_forward_xla(q, k, v, causal, scale)
        delta = tfa._flash_delta(out, do)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        s = torch.einsum("bhqd,bhkd->bhqk", q64, k64) * scale
        if causal:
            s = tfa._causal_fill(s)
        p = torch.exp(s - lse.double().reshape(1, 2, t, 1))
        dp = torch.einsum("bhqd,bhkd->bhqk", do64, v64)
        ds = p * (dp - delta.double().reshape(1, 2, t, 1))
        refs = (torch.einsum("bhqk,bhkd->bhqd", ds, k64) * scale,
                torch.einsum("bhqk,bhqd->bhkd", ds, q64) * scale,
                torch.einsum("bhqk,bhqd->bhkd", p, do64))
        errs = [(got.double() - ref)[:, :, 64:].abs().max().item()
                for got, ref in zip((dq, dk, dv), refs)]
        # the plain version's own f32 distance, for scale (not asserted)
        plain = (tfa._flash_bwd_dq_xla(q, k, v, do, lse, delta, causal,
                                       scale),
                 *tfa._flash_bwd_dkv_xla(q, k, v, do, lse, delta, causal,
                                         scale))
        plain_errs = [(got.double() - ref)[:, :, 64:].abs().max().item()
                      for got, ref in zip(plain, refs)]
        print(f"f32 B2/B3 vs float64 past the first tile, causal {causal} "
              f"t {t} d {d}: max abs err dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
              f"dv {errs[2]:.3e} (plain f32: {plain_errs[0]:.3e}, "
              f"{plain_errs[1]:.3e}, {plain_errs[2]:.3e})")
        assert max(errs) <= 2e-5, errs

    @pytest.mark.parametrize("d", [64, 128])
    def test_f32_backward_two_launches_are_bitwise_equal(self, cuda_device,
                                                         d):
        rs = np.random.RandomState(7)
        q, k, v, do = (torch.as_tensor(rs.standard_normal((2, 12, 1000, d)),
                                       dtype=torch.float32,
                                       device=cuda_device)
                       for _ in range(4))
        out, lse = tfa.flash_fwd(q, k, v, True)
        delta = tfa._flash_delta(out, do)
        runs = [(tfa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                 *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, True))
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    def test_unaligned_input_raises(self, cuda_device):
        q, k, v = (torch.randn(2, 4, 64, 64, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(3))
        shifted = torch.randn(2 * 4 * 64 * 64 + 1, device=cuda_device,
                              dtype=torch.bfloat16)[1:].view(q.shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa.flash_fwd(shifted, k, v)

    def test_autograd_on_card_launches_each_kernel_once(self, cuda_device):
        q, k, v = (torch.randn(2, 4, 128, 64, device=cuda_device,
                               requires_grad=True) for _ in range(3))
        counts = [tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                  tfa.flash_bwd_dkv.launches]
        tfa.flash_attention(q, k, v, True).sum().backward()
        torch.cuda.synchronize()
        assert [tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                tfa.flash_bwd_dkv.launches] == [c + 1 for c in counts]

    def test_mixed_devices_raise(self, cuda_device):
        q, k, v = _t(*_rand(d=64, n=3))
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tfa.flash_fwd(q.to(cuda_device), k, v.to(cuda_device))


# head_dims beyond the tensor-core routes' 64 and 128 (the SIMT kernels):
# the tiny configs and the JAX tests (8, 16), Cerebras-GPT-2.7B (80),
# OpenLLaMA-3B (100), GPT-J and Gemma (256), and the padded widths' edges
SWEEP_DIMS = (1, 8, 16, 32, 33, 80, 96, 100, 129, 256)


@pytest.mark.cuda
class TestAllHeadDimsOnCard:
    """B1-B3 at every head_dim the SIMT kernels take against their plain
    versions, at the bars of TestKernelsOnCard: causal (with an lse
    cotangent), full, fewer queries than keys and a ragged length; any
    base alignment; the limit at 256; the shared memory each launch takes
    against `estimate_smem_bytes`' table."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal,t_q,t_k", [
        (True, 200, 200), (False, 200, 200), (True, 77, 130),
        (False, 33, 1)])
    @pytest.mark.parametrize("d", SWEEP_DIMS)
    def test_kernels_match_plain(self, cuda_device, dtype, causal, t_q, t_k,
                                 d):
        rs = np.random.RandomState(d)
        b, h = 2, 3
        q, k, v, do = (
            torch.as_tensor(rs.standard_normal((b, h, t, d)),
                            dtype=torch.float32, device=cuda_device).to(dtype)
            for t in (t_q, t_k, t_k, t_q))
        g_lse = torch.as_tensor(rs.standard_normal((b * h, t_q)),
                                dtype=torch.float32, device=cuda_device)
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        scale = 1.0 / math.sqrt(d)
        extra = BF16_ULP if dtype == torch.bfloat16 else 0.0

        def close(got, ref, rtol, atol, rounded=True):
            tol = atol + (rtol + (extra if rounded else 0.0)) * ref.abs()
            assert bool(((got.float() - ref).abs() <= tol).all())

        counts = [tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                  tfa.flash_bwd_dkv.launches]
        out, lse = tfa.flash_fwd(q, k, v, causal, scale)
        ref_out, ref_lse = tfa._flash_forward_xla(qf, kf, vf, causal, scale)
        delta = tfa._flash_delta(ref_out, dof, g_lse)
        dq = tfa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal,
                                   scale)
        torch.cuda.synchronize()
        assert [tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                tfa.flash_bwd_dkv.launches] == [c + 1 for c in counts]
        close(out, ref_out, **FWD)
        close(lse, ref_lse, **FWD, rounded=False)
        close(dq, tfa._flash_bwd_dq_xla(qf, kf, vf, dof, ref_lse, delta,
                                        causal, scale), **BWD)
        r_dk, r_dv = tfa._flash_bwd_dkv_xla(qf, kf, vf, dof, ref_lse, delta,
                                            causal, scale)
        close(dk, r_dk, **BWD)
        close(dv, r_dv, **BWD)

    @pytest.mark.parametrize("d", [80, 100])
    def test_two_launches_are_bitwise_equal(self, cuda_device, d):
        rs = np.random.RandomState(2)
        q, k, v, do = (torch.as_tensor(rs.standard_normal((2, 4, 300, d)),
                                       dtype=torch.bfloat16,
                                       device=cuda_device)
                       for _ in range(4))
        runs = []
        for _ in range(2):
            out, lse = tfa.flash_fwd(q, k, v, True)
            delta = tfa._flash_delta(out, do)
            runs.append((out, lse,
                         tfa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                         *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, True)))
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    def test_any_alignment_on_the_simt_route(self, cuda_device):
        # the SIMT kernels read elements: a base 2 bytes past a 16-byte
        # boundary runs (the tensor-core routes raise, test above)
        q, k, v = (torch.randn(2, 4, 64, 80, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(3))
        shifted = torch.randn(2 * 4 * 64 * 80 + 1, device=cuda_device,
                              dtype=torch.bfloat16)[1:].view(q.shape)
        out, _ = tfa.flash_fwd(shifted, k, v)
        ref, _ = tfa._flash_forward_xla(shifted.float(), k.float(),
                                        v.float(), True, 1 / math.sqrt(80))
        assert bool(((out.float() - ref).abs()
                     <= 1e-5 + (1e-4 + BF16_ULP) * ref.abs()).all())

    @pytest.mark.parametrize("d", [257, 512])
    def test_head_dim_above_256_raises(self, cuda_device, d):
        q = torch.randn(1, 1, 8, d, device=cuda_device)
        with pytest.raises(ValueError, match="head_dim 1..256"):
            tfa.flash_fwd(q, q, q)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_smem_estimate_equals_the_launches(self, cuda_device, dtype):
        for d in range(1, tfa._MAX_HEAD_DIM + 1):
            launched = tfa._launch_smem_bytes(d, dtype)
            for kernel, (st, dy) in launched.items():
                assert st + dy == tfa._route_smem(kernel, d, dtype), \
                    (d, kernel, st, dy)
            assert tfa.estimate_smem_bytes(32768, 32768, d, dtype) == \
                max(st + dy for st, dy in launched.values())
