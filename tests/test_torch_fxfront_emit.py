"""Per-rank emission, op by op: every preset target's op, emitted under
each strategy of its pool (partial strategies included) on a (2,) mesh
of gloo ranks, equals the op run whole.  This pins the reshards (S->R
all_gather, P->R all_reduce, R->S local slices, R->P masks) and the
local-shape rewrites of views, expand and the creation ops.

Floats at rtol 1e-5 / atol 1e-6 (the sharded reductions reorder sums),
everything else exactly."""

import pytest

from tests import test_torch_fxfront_ranks as ranks

WORLD = 2


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    return ranks.spawn("emit_ops", WORLD, tmp_path_factory.mktemp("emit"))


@pytest.mark.parametrize("case", ranks.op_cases_names())
def test_op_under_every_strategy_equals_the_whole_op(emitted, case):
    for rank, result in enumerate(emitted):
        rows = result[case]
        assert rows, f"{case}: empty strategy pool"
        for strategy, err, kinds in rows:
            assert err <= 1.0, (f"rank {rank} {case} {strategy}: error "
                                f"{err} x tolerance (collectives {kinds})")


def test_every_kind_of_reshard_is_exercised(emitted):
    kinds = {k for rows in emitted[0].values() for _, _, ks in rows
             for k in ks}
    assert {"all_gather", "all_reduce"} <= kinds, kinds
    # the sharded strategies of mm: S(0) rows, K-sharded partial, S(1)
    strategies = [s for s, _, _ in emitted[0]["mm"]]
    assert any("P(sum)" in s for s in strategies), strategies


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_local_chunk_owns_its_storage(dim):
    """R -> S: the rank's chunk equals the slice and holds only its own
    bytes, at any dim (a slice of dim 0 is contiguous as a view)."""
    import torch

    from easydist_tpu_torch.fxfront.emit import _local_chunk

    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    n = 2
    for index in range(n):
        got = _local_chunk(x, dim, index, n)
        size = x.shape[dim] // n
        assert torch.equal(got, x.narrow(dim, index * size, size))
        assert got.is_contiguous()
        assert got.untyped_storage().nbytes() == got.numel() * 4
        assert got.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()


def test_liveness_model_covers_what_an_emitted_chunk_holds():
    """The liveness model (`schedule.remat._Liveness`) of a program that
    cuts a replicated value to the rank's chunk and frees it: after every
    node, the storages the program's values reference fit in the bytes
    the model holds live."""
    import numpy as np
    import torch
    import torch.fx as fx
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront.emit import _local_chunk
    from easydist_tpu_torch.schedule.remat import _Liveness

    g = fx.Graph()
    x = g.placeholder("x")
    y = g.call_function(torch.ops.aten.mul.Tensor, (x, 2.0))
    c = g.call_function(_local_chunk, (y, 0, 1, 4))
    z = g.call_function(torch.ops.aten.add.Tensor, (c, 1.0))
    w = g.call_function(torch.ops.aten.mul.Tensor, (z, c))
    g.output(w)
    gm = fx.GraphModule(torch.nn.Module(), g)
    inputs = [torch.ones(64, 32)]  # the caller holds them through the call
    held = []

    class Probe(fx.Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            n.meta["val"] = out
            env = dict(self.env)
            env[n] = out
            for gone in self.user_to_last_uses.get(n, []):
                env.pop(gone, None)
            seen = {}
            for v in list(env.values()) + inputs:
                for t in pytree.tree_leaves(v):
                    if isinstance(t, torch.Tensor):
                        st = t.untyped_storage()
                        seen[st.data_ptr()] = st.nbytes()
            held.append(sum(seen.values()))
            return out

    Probe(gm).run(*inputs)
    lv = _Liveness(gm)
    alive = np.zeros(lv.n + 1, dtype=np.int64)
    ok = lv.end > lv.start
    np.add.at(alive, lv.start[ok], lv.size[ok])
    np.add.at(alive, lv.end[ok], -lv.size[ok])
    alive = np.cumsum(alive[:-1])
    for i, node in enumerate(lv.nodes[:-1]):
        assert held[i] <= alive[i], (node.name, held[i], int(alive[i]))
