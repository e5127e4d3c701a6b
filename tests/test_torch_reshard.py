"""The port's reshard planning (easydist_tpu_torch.reshard) against the
JAX package's on the same descriptions (tests/test_reshard/test_plan.py,
test_exec.py:99-151): mesh descriptions, specs, device windows, chunk
spans and waves, `plan_redistribute`'s summaries and prices for shrink,
grow, respec and host gathers, `_fit_mesh`, and `plan_restore` on saved
fingerprints, the legacy manifest's replicated fallback included.  Then
the port's own layouts: a DTensor's `sharding_desc` (torch's fake
process group, one process), `state_fingerprint` with a stated layout,
`topology_shifted`, and `parallel.dp.dp_state_layout`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from easydist_tpu import reshard as jr
from easydist_tpu.reshard import restore as jrestore
from easydist_tpu_torch import reshard as tr
from easydist_tpu_torch.reshard import restore as trestore


def _pair(axes, sizes):
    return jr.MeshDesc(axes, sizes), tr.MeshDesc(axes, sizes)


def test_mesh_desc_meta_round_trip_and_validation():
    j, t = _pair(("dp", "tp"), (4, 2))
    assert t.to_meta() == j.to_meta()
    assert tr.MeshDesc.from_meta(json.loads(json.dumps(t.to_meta()))) == t
    assert t.n_devices == 8 and t.axis_size("tp") == 2
    with pytest.raises(ValueError):
        tr.MeshDesc(("dp",), (1, 2))
    with pytest.raises(ValueError):
        tr.MeshDesc(("dp",), (0,))


@pytest.mark.parametrize("spec,ndim", [((), 2), (("dp",), 3),
                                       ((("dp",), None), 2),
                                       ((("dp", "tp"), "tp"), 2),
                                       (("dp", None, "tp"), 2)])
def test_normalize_spec(spec, ndim):
    assert tr.normalize_spec(spec, ndim) == jr.normalize_spec(spec, ndim)


@pytest.mark.parametrize("shape,axes,sizes,spec", [
    ((16, 8), ("dp",), (4,), ("dp", None)),
    ((10, 6), ("dp",), (4,), ("dp", None)),
    ((10, 6), ("dp",), (4,), (None, "dp")),
    ((7, 9), ("dp", "tp"), (2, 3), ("dp", "tp")),
    ((7, 9), ("dp", "tp"), (2, 3), (None, "dp")),
    ((5,), ("dp",), (8,), ("dp",)),
])
def test_device_windows(shape, axes, sizes, spec):
    j, t = _pair(axes, sizes)
    assert tr.device_windows(shape, t, spec) == \
        jr.device_windows(shape, j, spec)
    with pytest.raises(ValueError, match="not in mesh axes"):
        tr.device_windows(shape, t, ("nope",))


def test_chunk_spans_and_waves():
    for total, per in ((0, 3), (10, 3), (10, 10), (1, 5), (7, 0)):
        assert tr.chunk_spans(total, per) == jr.chunk_spans(total, per)
    sizes = [5, 1, 9, 3, 3, 12, 1]
    for limit in (None, 0, 4, 10, 100):
        assert tr.chunk_waves(sizes, limit) == jr.chunk_waves(sizes, limit)
    assert tr.chunk_waves([], 4) == []


# (name, shape, dtype, src (axes, sizes, spec), dst (axes, sizes, spec))
CASES = [
    ("shrink", (16, 8), "float32", (("dp",), (8,), ("dp", None)),
     (("dp",), (4,), ("dp", None))),
    ("grow", (16, 8), "float32", (("dp",), (4,), ("dp", None)),
     (("dp",), (8,), ("dp", None))),
    ("respec", (16, 8), "float32", (("dp",), (4,), ("dp", None)),
     (("dp",), (4,), (None, "dp"))),
    ("uneven", (10, 6), "bfloat16", (("dp",), (4,), ("dp", None)),
     (("dp",), (2,), ("dp", None))),
    ("2d", (12, 6), "int32", (("dp", "tp"), (2, 2), ("dp", "tp")),
     (("dp", "tp"), (4, 2), ("dp", None))),
    ("to_replicated", (16, 8), "float32", (("dp",), (4,), ("dp", None)),
     (("dp",), (4,), ())),
    ("from_replicated", (16, 8), "float32", (("dp",), (4,), ()),
     (("dp",), (2,), ("dp", None))),
    ("identity", (16, 8), "float32", (("dp",), (4,), ("dp", None)),
     (("dp",), (4,), ("dp", None))),
    ("scalar", (), "float32", (("dp",), (4,), ()), (("dp",), (2,), ())),
]


@pytest.fixture
def jax_link(monkeypatch):
    """The port's link constants set to the JAX package's (ICI), so the
    prices compare."""
    from easydist_tpu import config as jconfig
    from easydist_tpu_torch import config as tconfig

    monkeypatch.setattr(tconfig, "nvlink_bandwidth", jconfig.ici_bandwidth)
    monkeypatch.setattr(tconfig, "nvlink_latency", jconfig.ici_latency)


@pytest.mark.parametrize("chunk", [None, 64, 100])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_redistribute_matches_jax(case, chunk, jax_link):
    _, shape, dtype, (sa, ss, sspec), (da, ds, dspec) = case
    sj, st = _pair(sa, ss)
    dj, dt = _pair(da, ds)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else dtype
    pj = jr.plan_redistribute(shape, jdtype, (sj, sspec), (dj, dspec),
                              chunk_bytes=chunk)
    pt = tr.plan_redistribute(shape, getattr(torch, dtype), (st, sspec),
                              (dt, dspec), chunk_bytes=chunk)
    assert pt.summary() == pj.summary()
    assert pt.chunks == [tr.ChunkOp(op.window, op.kind, op.bytes,
                                    op.wire_bytes) for op in pj.chunks]
    assert pt.global_bytes() == pj.global_bytes()
    assert pt.cost_s() == pytest.approx(pj.cost_s(), rel=1e-12)
    assert pt.peak_live_bytes() <= pt.chunked_bound()


@pytest.mark.parametrize("src", [(("dp",), (4,), ("dp", None)),
                                 (("dp", "tp"), (2, 2), (None, "tp"))])
def test_host_gather_matches_jax(src):
    axes, sizes, spec = src
    j, t = _pair(axes, sizes)
    pj = jr.plan_redistribute((16, 8), "float32", (j, spec), (jr.HOST, ()),
                              chunk_bytes=128)
    pt = tr.plan_redistribute((16, 8), torch.float32, (t, spec),
                              (tr.HOST, ()), chunk_bytes=128)
    assert pt.summary() == pj.summary()
    assert pt.summary()["kinds"] == ["gather_host"]


@pytest.mark.parametrize("axes,sizes,n_now", [
    (("dp",), (8,), 4), (("dp",), (4,), 8), (("dp", "tp"), (4, 2), 4),
    (("dp", "tp"), (4, 2), 3), (("dp",), (2,), 2), ((), (), 2),
    (("dp", "tp"), (2, 4), 2)])
def test_fit_mesh_matches_jax(axes, sizes, n_now):
    j, t = _pair(axes, sizes)
    fj, ft = jrestore._fit_mesh(j, n_now), trestore._fit_mesh(t, n_now)
    assert (None if ft is None else ft.to_meta()) == \
        (None if fj is None else fj.to_meta())


def _saved_fp(shape, axes, sizes, spec, n=8):
    """A saved fingerprint (the manifest's meta["mesh"]) as both packages
    write it for one float32 leaf on the 8 CPU devices."""
    entry = {"kind": "array", "shape": list(shape), "dtype": "float32"}
    if axes:
        entry["mesh"] = {"axes": list(axes), "sizes": list(sizes),
                         "device_kinds": ["cpu"]}
        entry["spec"] = list(spec)
    return {"mesh": {"format": 1, "n_devices": n, "device_kinds": ["cpu"],
                     "layout": True, "leaves": [entry]}}


def test_plan_restore_stated_layout_wins_like_a_template_sharding():
    devs = jax.devices()
    meta = _saved_fp((16, 8), ("dp",), (8,), (None, "dp"))
    sub = NamedSharding(Mesh(np.array(devs[:4]), ("dp",)), P(None, "dp"))
    pj = jr.plan_restore({"w": jax.ShapeDtypeStruct((16, 8), jnp.float32,
                                                    sharding=sub)}, meta)
    layout = {"w": (tr.MeshDesc(("dp",), (4,)), (None, "dp"), (16, 8))}
    pt = tr.plan_restore({"w": torch.zeros(16, 2)}, meta, layout=layout,
                         rank=0, world=8)
    assert pt.summary() == pj.summary()
    assert pt.topology_shift and pt.had_fingerprint
    assert pt.shardings[0] == (layout["w"][0], (None, "dp"), (16, 8))


def test_plan_restore_refits_the_saved_layout():
    # the JAX template is the unsharded whole leaf, restored SHARDED on the
    # re-fitted mesh; the port's template is this rank's block of it
    meta = _saved_fp((16, 8), ("dp",), (8,), ("dp", None))
    pj = jr.plan_restore({"w": jax.ShapeDtypeStruct((16, 8), jnp.float32)},
                         meta)
    pt = tr.plan_restore({"w": torch.zeros(2, 8)}, meta, rank=3, world=8)
    assert pt.summary() == pj.summary()
    assert len(pt.plans) == 1 and not pt.replicated_leaves
    # onto 4 ranks: dp absorbs the ratio, a shift, each rank 4 rows
    pt4 = tr.plan_restore({"w": torch.zeros(4, 8)}, meta, rank=1, world=4)
    assert pt4.topology_shift and pt4.shardings[0][0].axis_sizes == (4,)
    want = jr.plan_redistribute((16, 8), "float32",
                                (jr.MeshDesc(("dp",), (8,)), ("dp", None)),
                                (jr.MeshDesc(("dp",), (4,)), ("dp", None)))
    assert pt4.plans[0][1].summary()["wire_bytes"] == \
        want.summary()["wire_bytes"]


@pytest.mark.parametrize("meta", [
    None, {},
    # the PR-15 manifest: world size and device type, no leaves
    {"mesh": {"format": 1, "n_devices": 1, "world_size": 1,
              "device_type": "cpu"}}], ids=["none", "empty", "pr15"])
def test_legacy_meta_falls_back_replicated(meta):
    pj = jr.plan_restore({"w": jax.ShapeDtypeStruct((16, 8), jnp.float32)},
                         None)
    pt = tr.plan_restore({"w": torch.zeros(16, 8)}, meta, rank=0, world=1)
    assert pt.summary() == pj.summary()
    assert pt.replicated_leaves == [(0, 16 * 8 * 4)]
    assert not pt.had_fingerprint and not pt.topology_shift


# ----------------------------------------------------- the port's layouts


@pytest.fixture
def fake_world4():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dtensor_sharding_desc_and_fingerprint(fake_world4):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "tp"))
    x = DTensor.from_local(torch.zeros(8, 3), mesh, [Shard(0), Replicate()],
                           run_check=False)
    y = DTensor.from_local(torch.zeros(4, 3), mesh, [Shard(1), Shard(1)],
                           run_check=False)
    desc, spec = tr.sharding_desc(x, 2)
    assert desc == tr.MeshDesc(("dp", "tp"), (2, 2), ("cpu",))
    assert spec == ("dp", None)
    assert tr.sharding_desc(y, 2)[1] == (None, None)  # two axes on one dim
    fp = tr.state_fingerprint({"x": x, "n": 3})
    assert json.loads(json.dumps(fp)) == fp
    assert fp["n_devices"] == 4 and fp["layout"]
    arr, opaque = fp["leaves"]      # torch's pytree keeps dict order
    assert arr["shape"] == [16, 3] and arr["spec"] == ["dp", None]
    assert opaque == {"kind": "opaque"}


def test_stated_layout_fingerprint_and_shift(fake_world4):
    lay = {"w": (tr.MeshDesc(("dp",), (4,)), ("dp",), (10, 3)),
           "b": (tr.MeshDesc(("dp",), (4,)), ())}
    fp = tr.state_fingerprint({"w": torch.zeros(3, 3), "b": torch.ones(5)},
                              layout=lay)
    assert fp["n_devices"] == 4 and fp["device_kinds"] == ["cpu"]
    w, b = fp["leaves"]
    assert w["shape"] == [10, 3] and w["spec"] == ["dp", None]
    # a replicated leaf over several ranks records its mesh, as the JAX
    # fingerprint records a replicated sharding's
    assert b["shape"] == [5] and b["spec"] == [None]
    assert not tr.topology_shifted(fp, kind="cpu")
    assert tr.topology_shifted(fp, world=2, kind="cpu")
    assert tr.topology_shifted(fp, kind="NVIDIA H100 80GB HBM3")
    assert not tr.topology_shifted(None)
    with pytest.raises(ValueError, match="structure"):
        tr.state_fingerprint({"w": torch.zeros(3)}, layout={"v": lay["b"]})


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3"])
def test_dp_state_layout_marks_what_shardable_shards(mode):
    from easydist_tpu_torch.parallel import dp_state_layout

    params = {"a": torch.zeros(8, 3), "b": torch.zeros(6), "c":
              torch.zeros(())}
    lay = dp_state_layout(params, mode, 4)
    mesh = tr.MeshDesc(("dp",), (4,))
    if mode == "ddp":
        assert lay == {k: (mesh, ()) for k in params}
        return
    first, opt, count = lay
    moments = {"a": (mesh, ("dp",), (8, 3)), "b": (mesh, ()),
               "c": (mesh, ())}
    assert opt == {"mu": moments, "nu": moments} and count == (mesh, ())
    assert first == (moments if mode == "zero3"
                     else {k: (mesh, ()) for k in params})
