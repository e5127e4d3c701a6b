"""Restore across a topology change on gloo ranks: the port's
`reshard.redistribute`, `runtime.checkpoint` with `layout=` and
`run_training` after `elastic.mesh.shrink`.

Three spawns of a small GPT (`GPTConfig.tiny(vocab=130, seq=30)`: wte's
and wpe's dim 0 divide 2 but not 4, so they are replicated under ZeRO at
world 4 and sharded at world 2):

  1. world 4: the ddp, zero2 and zero3 states after one step each, saved
     with their layouts; `redistribute` across (4,) -> (2,), (2,) -> (4,)
     and a respec on (4,), plain blocks and a DTensor, and
     `fetch_chunked`; `run_training` under zero2 with
     `elastic.mesh.shrink` at its third step;
  2. world 2: each state restored from world 4 (bitwise every rank's
     window of the world-4 state) and saved again; the restore under
     `elastic.restore.oom` (the chunk halved, the state bitwise the
     same); `run_training` resuming the shrunk run, its losses bitwise
     those of the restored state stepped by hand;
  3. world 4: each state restored from world 2, bitwise the states of
     spawn 1.

`reshard_chunk_bytes` is 512 in the ranks, so every leaf moves in many
chunks.  The scenarios run on "tests.test_torch_reshard_ranks:<name>"
through `tests/test_torch_fxfront_ranks.spawn`."""

import os

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from tests.test_torch_fxfront_ranks import spawn

MODES = ("ddp", "zero2", "zero3")
CFG_KW = dict(vocab=130, seq=30)
SCEN = "tests.test_torch_reshard_ranks:"
CONSTANTS = {"reshard_chunk_bytes": 512}
TOTAL_STEPS = 5
FULL = np.arange(60, dtype=np.float32).reshape(10, 6)


# ------------------------------------------------------------ scenarios

def _cfg():
    from easydist_tpu_torch.models.gpt import GPTConfig

    return GPTConfig.tiny(**CFG_KW)


def _params(seed=0):
    from easydist_tpu_torch.models.gpt import gpt_init

    return gpt_init(_cfg(), torch.Generator().manual_seed(seed),
                    device="cpu")


def _batch(i):
    rs = np.random.RandomState(100 + i)
    return (rs.randint(0, CFG_KW["vocab"], (4, 16)),
            rs.randint(0, CFG_KW["vocab"], (4, 16)))


class Batches:
    """Deterministic batches by index, with the loader's skip cursor."""

    def __init__(self):
        self.batches_consumed = 0

    def skip(self, n):
        self.batches_consumed += n

    def __iter__(self):
        return self

    def __next__(self):
        self.batches_consumed += 1
        return _batch(self.batches_consumed - 1)


def _loss(params, tokens, targets):
    from easydist_tpu_torch.models.gpt import gpt_loss

    return gpt_loss(params, _cfg(), tokens, targets)


def _mode(mode, world):
    """(step, fresh state, layout) of `mode` on a (world,) "dp" mesh."""
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.parallel import (ddp_step, dp_state_layout,
                                             zero2_step, zero3_step)

    mesh = make_device_mesh((world,), ("dp",), device_type="cpu")
    params = _params()
    layout = dp_state_layout(params, mode, mesh)
    if mode == "ddp":
        return ddp_step(_loss, mesh, lr=0.1), params, layout
    if mode == "zero2":
        step, init_opt = zero2_step(_loss, mesh, lr=1e-3)
        return step, (params, init_opt(params),
                      torch.zeros((), dtype=torch.int32)), layout
    step, init = zero3_step(_loss, mesh, lr=1e-3)
    return step, init(params), layout


def _numpy(state):
    return [x.numpy().copy() if isinstance(x, torch.Tensor) else x
            for x in pytree.tree_leaves(state)]


def _restored(root, mode, world):
    """Each mode's state restored onto `world` and its restore report."""
    from easydist_tpu_torch.runtime import checkpoint as ck

    _, like, layout = _mode(mode, world)
    like = pytree.tree_map(torch.zeros_like, like)
    state = ck.load_checkpoint(os.path.join(root, mode), like, layout=layout)
    return state, dict(ck.last_restore_report())


def _redistribute_cases(rank, world):
    from torch.distributed.tensor import DTensor, Shard

    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.reshard import (MeshDesc, device_windows,
                                            fetch_chunked, redistribute)

    def block(mesh, spec):
        if rank >= mesh.n_devices:
            return None
        win = device_windows(FULL.shape, mesh, spec)[rank]
        return torch.from_numpy(FULL[tuple(slice(a, b) for a, b in win)])

    m4, m2 = MeshDesc(("dp",), (4,)), MeshDesc(("dp",), (2,))
    out = {}
    for name, src, dst in (("shrink", (m4, ("dp", None)), (m2, ("dp", None))),
                           ("grow", (m2, ("dp", None)), (m4, ("dp", None))),
                           ("respec", (m4, ("dp", None)), (m4, (None, "dp"))),
                           ("gather", (m4, ("dp", None)), (m2, ()))):
        got = redistribute(block(*src), dst + ((10, 6),),
                           src + ((10, 6),), chunk_bytes=48)
        out[name] = None if got is None else got.numpy()
    mesh = make_device_mesh((world,), ("dp",), device_type="cpu")
    dt = DTensor.from_local(block(m4, ("dp", None)), mesh, [Shard(0)],
                            shape=torch.Size((10, 6)), stride=(6, 1))
    moved = redistribute(dt, (mesh, [Shard(1)]), chunk_bytes=48)
    out["dtensor"] = (type(moved).__name__, moved.to_local().numpy(),
                      tuple(moved.shape))
    out["fetch"] = fetch_chunked(dt, chunk_bytes=48).numpy()
    out["fetch_plain"] = fetch_chunked(torch.from_numpy(FULL),
                                       chunk_bytes=48).numpy()
    return out


def save_world4(rank, world, out, out_dir):
    """Spawn 1 (world 4): the three states saved, `redistribute`, and the
    shrunk training run."""
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.resilience.preempt import PreemptedError
    from easydist_tpu_torch.runtime import checkpoint as ck
    from easydist_tpu_torch.runtime.elastic import run_training

    torch.use_deterministic_algorithms(True, warn_only=True)
    states = {}
    for mode in MODES:
        step, state, layout = _mode(mode, world)
        state, _ = step(state, *(torch.as_tensor(b) for b in _batch(0)))
        ck.save_checkpoint(os.path.join(out_dir, "w4", mode), state, step=1,
                           layout=layout)
        states[mode] = _numpy(state)
    step, state, layout = _mode("zero2", world)
    losses = []
    with fault_plan("elastic.mesh.shrink@3"):
        try:
            run_training(step, lambda: state, Batches(),
                         os.path.join(out_dir, "shrink"), TOTAL_STEPS,
                         checkpoint_every=100, device="cpu", layout=layout,
                         on_step=lambda s, loss: losses.append(float(loss)))
            shrunk = None
        except PreemptedError as e:
            shrunk = e.step
    return {"states": states, "redistribute":
            _redistribute_cases(rank, world), "shrunk_at": shrunk,
            "losses": losses}


def restore_world2(rank, world, out, out_dir, shrunk_at):
    """Spawn 2 (world 2): restore from world 4 and save again; the oom
    drill; resume the shrunk run."""
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime import checkpoint as ck
    from easydist_tpu_torch.runtime.elastic import run_training

    torch.use_deterministic_algorithms(True, warn_only=True)
    states, reports = {}, {}
    for mode in MODES:
        state, reports[mode] = _restored(os.path.join(out_dir, "w4"), mode,
                                         world)
        ck.save_checkpoint(os.path.join(out_dir, "w2", mode), state, step=1,
                           layout=_mode(mode, world)[2])
        states[mode] = _numpy(state)
    with fault_plan("elastic.restore.oom@1"):
        oom_state, oom_report = _restored(os.path.join(out_dir, "w4"), "zero2",
                                          world)
    step, fresh, layout = _mode("zero2", world)
    resumed = []
    run_training(step, lambda: fresh, Batches(),
                 os.path.join(out_dir, "shrink"), TOTAL_STEPS, checkpoint_every=100, device="cpu",
                 layout=layout,
                 on_step=lambda s, loss: resumed.append((s, float(loss))))
    resume_report = dict(ck.last_restore_report())
    like = pytree.tree_map(torch.zeros_like, fresh)
    state, at, meta = ck.load_checkpoint(os.path.join(out_dir, "shrink"), like,
                                         step=shrunk_at, layout=layout,
                                         with_meta=True)
    by_hand = []
    for s in range(at, TOTAL_STEPS):
        state, loss = step(state, *(torch.as_tensor(b)
                                    for b in _batch(meta["batches_consumed"]
                                                    + s - at)))
        by_hand.append((s, float(loss)))
    return {"states": states, "reports": reports,
            "oom": (_numpy(oom_state), oom_report),
            "resumed": resumed, "by_hand": by_hand,
            "resume_report": resume_report}


def restore_world4(rank, world, out, out_dir):
    """Spawn 3 (world 4): each state restored from world 2."""
    root = os.path.join(out_dir, "w2")
    return {mode: _numpy(_restored(root, mode, world)[0]) for mode in MODES}


# ---------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    for sub in ("s1", "s2", "s3"):
        (tmp / sub).mkdir()
    w4 = spawn(SCEN + "save_world4", 4, tmp / "s1", out_dir=str(tmp),
               constants=CONSTANTS)
    w2 = spawn(SCEN + "restore_world2", 2, tmp / "s2", out_dir=str(tmp),
               shrunk_at=w4[0]["shrunk_at"], constants=CONSTANTS)
    back = spawn(SCEN + "restore_world4", 4, tmp / "s3", out_dir=str(tmp),
                 constants=CONSTANTS)
    return w4, w2, back


def _layouts(mode, world):
    from easydist_tpu_torch.parallel import dp_state_layout
    from easydist_tpu_torch.reshard.plan import flatten_layout

    step_state = _expected_structure(mode)
    lay = dp_state_layout(_params(), mode, world)
    return flatten_layout(lay, pytree.tree_flatten(step_state)[1])


def _expected_structure(mode):
    """A state of `mode`'s tree structure (values unused)."""
    params = _params()
    if mode == "ddp":
        return params
    zero = torch.zeros(())
    moments = pytree.tree_map(lambda p: zero, params)
    first = moments if mode == "zero3" else params
    return (first, {"mu": moments, "nu": moments}, zero)


def _window(x, lay, rank):
    from easydist_tpu_torch.reshard import device_windows

    mesh, spec = lay[0], lay[1]
    shape = lay[2] if len(lay) > 2 else x.shape
    win = device_windows(shape, mesh, spec)[rank]
    return x[tuple(slice(a, b) for a, b in win)]


def _whole(ranks, mode, world):
    """Each leaf's whole value from the per-rank states of `world`."""
    lays = _layouts(mode, world)
    out = []
    for i, lay in enumerate(lays):
        blocks = [np.asarray(r[i]) for r in ranks]
        if len(lay) > 2:
            shape = tuple(lay[2])
            out.append(np.concatenate(
                [b.reshape((-1,) + shape[1:]) for b in blocks]))
        else:
            out.append(blocks[0])
    return out


def _check_world(whole, ranks, mode, world):
    lays = _layouts(mode, world)
    for rank, leaves in enumerate(ranks):
        for i, (w, got, lay) in enumerate(zip(whole, leaves, lays)):
            want = _window(w, lay, rank)
            got = np.asarray(got)
            assert got.size == want.size, (mode, rank, i)
            assert got.tobytes() == np.ascontiguousarray(want).tobytes(), \
                (mode, rank, i)


@pytest.mark.parametrize("mode", MODES)
def test_world4_state_restores_bitwise_at_world2(runs, mode):
    w4, w2, _ = runs
    whole = _whole([r["states"][mode] for r in w4], mode, 4)
    _check_world(whole, [r["states"][mode] for r in w2], mode, 2)
    for r in w2:
        rep = r["reports"][mode]
        assert rep["topology_shift"] and rep["saved_n_devices"] == 4
        assert rep["peak_live_bytes"] <= rep["chunked_bound"]
    if mode != "ddp":
        # zero2 / zero3: rank 1 reads the blocks of world-4 ranks 2 and 3
        assert w2[1]["reports"][mode]["files_opened"] >= 2


@pytest.mark.parametrize("mode", MODES)
def test_and_back_at_world4(runs, mode):
    w4, _, back = runs
    for r4, rb in zip(w4, back):
        for a, b in zip(r4["states"][mode], rb[mode]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_restore_oom_halves_the_chunk(runs):
    _, w2, _ = runs
    for r in w2:
        leaves, rep = r["oom"]
        assert [a["outcome"] for a in rep["attempts"]] == ["oom", "landed"]
        assert rep["chunk_bytes"] == CONSTANTS["reshard_chunk_bytes"] // 2
        for a, b in zip(leaves, r["states"]["zero2"]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_run_training_resumes_after_mesh_shrink(runs):
    w4, w2, _ = runs
    shrunk = w4[0]["shrunk_at"]
    assert shrunk == 2 and len(w4[0]["losses"]) == 2
    for r in w2:
        assert [s for s, _ in r["resumed"]] == list(range(shrunk,
                                                          TOTAL_STEPS))
        assert r["resumed"] == r["by_hand"]
        assert r["resume_report"]["topology_shift"]
    assert w2[0]["resumed"] == w2[1]["resumed"]


@pytest.mark.parametrize("case", ["shrink", "grow", "respec", "gather",
                                  "dtensor", "fetch"])
def test_redistribute_across_worlds_bitwise(runs, case):
    from easydist_tpu_torch.reshard import MeshDesc, device_windows

    w4 = runs[0]
    if case == "fetch":
        for r in w4:
            assert r["redistribute"]["fetch"].tobytes() == FULL.tobytes()
            assert r["redistribute"]["fetch_plain"].tobytes() == \
                FULL.tobytes()
        return
    if case == "dtensor":
        for r in w4:
            kind, _, shape = r["redistribute"]["dtensor"]
            assert kind == "DTensor" and shape == (10, 6)
        cols = np.concatenate([r["redistribute"]["dtensor"][1] for r in w4],
                              axis=1)
        assert cols.tobytes() == FULL.tobytes()
        return
    dst = {"shrink": (MeshDesc(("dp",), (2,)), ("dp", None)),
           "grow": (MeshDesc(("dp",), (4,)), ("dp", None)),
           "respec": (MeshDesc(("dp",), (4,)), (None, "dp")),
           "gather": (MeshDesc(("dp",), (2,)), ())}[case]
    wins = device_windows(FULL.shape, *dst)
    for rank, r in enumerate(w4):
        got = r["redistribute"][case]
        if rank >= dst[0].n_devices:
            assert got is None
            continue
        want = FULL[tuple(slice(a, b) for a, b in wins[rank])]
        assert got.tobytes() == np.ascontiguousarray(want).tobytes()
