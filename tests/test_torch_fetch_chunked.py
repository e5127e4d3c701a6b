"""`reshard.fetch_chunked` under the host tier and the pipeline export,
as the JAX package's tier (easydist_tpu/kv/tier.py:112-116) and export
(easydist_tpu/jaxfront/pp_compile.py:418-423) call it.

The tier: a demoted page's leaves go through `fetch_chunked` under the
node `kv.tier[<label>]` (RESHARD001 runs on each), chunk by chunk, and
promotion gives the pages back bitwise, f32, bf16 and int8.  The export:
on gloo ranks of world 2 ((2,) "pp") and 4 ((2, 2) "pp" x "dp"),
`export_state_dict` equals, bitwise, the tree the rows' all_gather gave
before, no chunk's gather holds more than the plan's chunk, and the
plan's peak is within its `chunked_bound()`.  What a fetch planned and
staged is read by `FetchSpy`, which wraps the budget check (each plan
with its node) and the gather.  The scenarios run on
"tests.test_torch_fetch_chunked:<name>" through
`tests/test_torch_fxfront_ranks.spawn`."""

import numpy as np
import pytest
import torch

from easydist_tpu_torch import analyze
from easydist_tpu_torch.comm import reduce as comm_reduce
from easydist_tpu_torch.kv.tier import HostTier
from easydist_tpu_torch.reshard import exec as reshard_exec
from easydist_tpu_torch.reshard import fetch_chunked
from tests.test_torch_fxfront_ranks import spawn

SCEN = "tests.test_torch_fetch_chunked:"
CHUNK = 256   # bytes a chunk in these tests: every leaf moves in several


def _page(seed):
    rs = np.random.RandomState(seed)
    k = torch.from_numpy(rs.standard_normal((2, 8, 16)).astype(np.float32))
    return {"k": k, "v": k.to(torch.bfloat16) * 3,
            "k_q": torch.from_numpy(rs.randint(-127, 128, (2, 8, 16),
                                               dtype=np.int8)),
            "k_scale": torch.from_numpy(rs.rand(2, 8, 1).astype(np.float32))}


class FetchSpy:
    """Within the block: `plans`, (node, plan) of every `fetch_chunked`
    (read at its budget check), and `gathered`, the bytes of each chunk's
    all_gather."""

    def __enter__(self):
        self.plans, self.gathered = [], []
        self._saved = (reshard_exec._check_budget, comm_reduce.all_gather_dim0)
        check, gather = self._saved

        def spy_check(rplan, node):
            self.plans.append((node, rplan))
            return check(rplan, node)

        def spy_gather(x, *args, **kw):
            y = gather(x, *args, **kw)
            self.gathered.append(y.numel() * y.element_size())
            return y

        reshard_exec._check_budget = spy_check
        comm_reduce.all_gather_dim0 = spy_gather
        return self

    def __exit__(self, *exc):
        reshard_exec._check_budget, comm_reduce.all_gather_dim0 = self._saved


class TestTier:
    def test_demotion_goes_through_fetch_chunked(self):
        tier = HostTier(1 << 20, chunk_bytes=CHUNK)
        analyze.reset_hook_tally()
        page = _page(0)
        with FetchSpy() as spy:
            assert tier.put("p0", page)
        runs = analyze.hook_tally().get("RESHARD001", {})
        assert runs.get("runs") == len(page) and runs.get("findings") == 0
        assert [node for node, _ in spy.plans] == [
            f"kv.tier[p0:{name}]" for name in sorted(page)]
        # "v": 2 x 8 x 16 bf16 in chunks of one 8 x 16 row (the
        # indivisible floor above 256 bytes), each read a chunk's rows
        _, plan = spy.plans[-1]
        assert [op.window[0] for op in plan.chunks] == [(0, 1), (1, 2)]
        assert plan.peak_live_bytes() <= plan.chunked_bound()
        assert spy.gathered == []  # a plain tensor: no collective

    @pytest.mark.parametrize("chunk", [CHUNK, None])
    def test_promotion_is_bitwise(self, chunk):
        tier = HostTier(1 << 20, chunk_bytes=chunk)
        pages = {f"p{i}": _page(i) for i in range(3)}
        for key, page in pages.items():
            assert tier.put(key, page)
        for key, page in pages.items():
            back = tier.get(key)
            assert sorted(back) == sorted(page)
            for name, x in page.items():
                assert back[name].dtype == x.dtype
                assert torch.equal(back[name], x), (key, name)

    def test_plain_fetch_equals_copy(self):
        x = torch.arange(60, dtype=torch.float32).reshape(6, 10)
        out = torch.empty(10, 6).t()  # a strided buffer
        with FetchSpy() as spy:
            got = fetch_chunked(x, chunk_bytes=80, out=out)
        assert got is out and torch.equal(out, x)
        assert [node for node, _ in spy.plans] == ["fetch"]
        assert len(spy.plans[0][1].chunks) == 3


# ------------------------------------------------------------ the export


def export_scenario(rank, world, out):
    """easydist_compile(pp_stages=2) on (2,) "pp" (world 2) or (2, 2)
    "pp" x "dp" (world 4), 2 Adam steps, then `export_state_dict` (through
    `fetch_chunked`, chunks of CHUNK bytes) against the rows' all_gather
    that the export made before, unpacked the same way."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch import comm
    from easydist_tpu_torch import config as edconfig
    from tests.test_torch_parallel_ranks import (N_LAYERS, _mesh, _pp_train,
                                                 from_numpy, pp_loss)

    edconfig.reshard_chunk_bytes = CHUNK
    rs = np.random.RandomState(0)
    dim = 16
    params = {f"w{i}": (0.3 * rs.randn(dim, dim)).astype(np.float32)
              for i in range(N_LAYERS)}
    batches = [(rs.randn(16, dim).astype(np.float32),
                rs.randn(16, dim).astype(np.float32)) for _ in range(2)]
    shape, names = ((2,), ("pp",)) if world == 2 else ((2, 2), ("pp", "dp"))
    compiled, state, _ = _pp_train(_mesh(shape, names), pp_loss,
                                   from_numpy(params),
                                   [tuple(from_numpy(b)) for b in batches],
                                   steps=2, lr=1e-2)
    with FetchSpy() as spy:
        got = compiled.export_state_dict(state)
    (node, plan), = spy.plans
    report = dict(node=node, chunks=len(plan.chunks),
                  staged_bytes=max(spy.gathered),
                  gathers=len(spy.gathered),
                  peak_live_bytes=plan.peak_live_bytes(),
                  chunked_bound=plan.chunked_bound())
    prep = compiled.pipe.prep
    row, shared = state[0]
    full = row[0]
    if prep.sib is not None:
        full = comm.all_gather_dim0(full, prep.sib.group, prep.sib.size)
    rows = comm.all_gather_dim0(full[None], prep.pp.group, prep.pp.size)
    old = [None] * (len(compiled._diff_idx) + len(compiled._const_baked))
    for i, leaf in zip(compiled._diff_idx, prep.unpack_params(rows, shared)):
        old[i] = leaf
    for i, baked in compiled._const_baked.items():
        old[i] = baked
    want = pytree.tree_unflatten(old, compiled._params_treedef)
    got_leaves = pytree.tree_leaves(got)
    return dict(report=report,
                row_bytes=row.numel() * row.element_size(),
                equal=[torch.equal(a, b) for a, b in zip(
                    got_leaves, pytree.tree_leaves(want))],
                devices=sorted({str(x.device) for x in got_leaves}),
                n=len(got_leaves))


@pytest.mark.parametrize("world", [2, 4])
def test_export_through_fetch_chunked(tmp_path, world):
    results = spawn(SCEN + "export_scenario", world, tmp_path)
    for r in results:
        rep = r["report"]
        assert r["n"] > 0 and all(r["equal"]), r
        assert r["devices"] == ["cpu"]
        assert rep["node"] == "pp_compile.export_state_dict"
        assert rep["chunks"] > 1 and rep["gathers"] == rep["chunks"]
        # one chunk's gather: at most the chunk the plan was asked for
        # (or one indivisible dim-0 row of the [blk, stages, siblings]
        # view: 4 bytes a rank), never a whole row a device
        assert 0 < rep["staged_bytes"] <= max(CHUNK, 4 * world)
        assert rep["staged_bytes"] < r["row_bytes"] * world
        assert rep["peak_live_bytes"] <= rep["chunked_bound"]
