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
