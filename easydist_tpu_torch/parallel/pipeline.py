"""Pipeline parallelism with one program per rank: the port of
easydist_tpu/parallel/pipeline.py.

The JAX package runs a pipeline as one SPMD program: every device runs
the same stage body inside a `lax.scan` over ticks and activations
rotate with `ppermute`.  The port keeps its clock and its tables but
runs the reference's own design (easydist/torch/experimental/pp/
runtime.py, `ScheduleGPipe` and `ScheduleDAPPLE`): each rank walks its
own column of the supertick tables and, at every supertick, runs at most
one forward unit and one backward unit of its own stage, then hands its
activation to rank s+1 and its input gradient to rank s-1 in one
`batch_isend_irecv` of matched send/recv pairs (every rank derives what
its neighbours send from the same tables, so nothing waits on a message
that never comes, on gloo as on NCCL).  A backward unit is
`torch.autograd.grad` over the graph its forward unit kept.

Schedules ("gpipe", "remat", "1f1b"):
  gpipe  every forward unit first (the forward tables), then every
         backward unit (the forward tables mirrored: the backward of
         global stage j runs at the forward clock of stage J-1-j), so
         all M microbatches' residuals are alive between the two;
  remat  gpipe with the stage body under `torch.utils.checkpoint`
         (non-reentrant): the backward recomputes the forward;
  1f1b   the DAPPLE / interleaved-1F1B supertick tables: a microbatch's
         residuals are freed by its backward unit, so a rank holds at
         most `tables["ring"]` microbatches per chunk.
`n_virtual` = V > 1 interleaves V chunks per rank (chunk k of rank s is
global stage k*S + s) under any schedule.

`LocalStages(n)` in place of a mesh chains all n stages' programs in
one process, with their messages handed over in memory: the same
per-rank code, for checking a split against the unsplit model on one
device.

`stage_params` is the stage-stacked tree (leading dim V*S, every rank
takes its own rows) or only this rank's rows (leading dim V); on a mesh
the gradients come back as this rank's rows, [V, ...] (the block the
JAX package's pp-sharded output gives each device).  Microbatches are
[M, batch, ...] on every rank; `data_axis` shards their batch dim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from easydist_tpu_torch import comm

from ._axes import local_block, mesh_axis

# P2P tags: activations and gradients of one supertick may go to the same
# peer (two stages), gloo matches by tag; tensor i of a message adds i
ACT_TAG, GRAD_TAG = 0, 1 << 16


@dataclass
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    axis_name: str = "pp"
    # "gpipe" keeps every microbatch's residuals until the backward
    # sweep; "remat" recomputes each stage's forward in its backward;
    # "1f1b" interleaves forward and backward units (spmd_pipeline_grad)
    schedule: str = "gpipe"
    # hybrid pp x dp: the microbatches' batch dim is sharded over this
    # axis (gradients and loss are averaged over it)
    data_axis: Optional[str] = None
    # per-leaf (a tree like the stage params) or uniform tail spec of the
    # dims after the stage dim: an axis name cuts that dim for the rank's
    # coordinate on the axis; the stage body does its own collectives
    param_spec: Optional[object] = None
    # virtual stages (chunks) per rank
    n_virtual: int = 1


class LocalStages:
    """All `n` stages of a pipeline run in this process, in lockstep,
    their P2P messages handed over in memory (no process group)."""

    def __init__(self, n: int):
        self.n = int(n)


def stack_stage_params(per_stage_params):
    """[tree per stage] -> one tree with a leading stage dim."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


# --------------------------------------------------------------- tables

def _1f1b_schedule_tables(S: int, V: int, M: int, fwd_only: bool = False):
    """Host-side supertick schedule for (interleaved) 1F1B.

    Global stage j = k*S + s (chunk k on device s), J = V*S stages.
    Microbatches run in groups of S (Megatron interleaving):
      fwd(j, m) at u = j + (m % S) + (m // S) * V*S
      bwd(j, m) at u = (2J - 2 - j) + (m % S) + (m // S) * V*S
    Consecutive stages are exactly one supertick apart (device +1 ring for
    activations, -1 for grads), each device has at most one fwd and one bwd
    unit per supertick, and the final chunk's last stage turns a microbatch
    around within its own supertick.  Returns [U, S] int32/bool lookup
    tables plus the residual ring size (max in-flight microbatches per
    (device, chunk) — the O(S·V) 1F1B working set).
    """
    J = V * S
    stride = V * S

    def u_f(j, m):
        return j + (m % S) + (m // S) * stride

    def u_b(j, m):
        return (2 * J - 2 - j) + (m % S) + (m // S) * stride

    U = u_f(J - 1, M - 1) + 1 if fwd_only else u_b(0, M - 1) + 1
    m_f = np.zeros((U, S), np.int32)
    k_f = np.zeros((U, S), np.int32)
    f_ok = np.zeros((U, S), bool)
    m_b = np.zeros((U, S), np.int32)
    k_b = np.zeros((U, S), np.int32)
    b_ok = np.zeros((U, S), bool)
    ring = 1
    for s in range(S):
        for k in range(V):
            j = k * S + s
            for m in range(M):
                uf = u_f(j, m)
                assert not f_ok[uf, s], "fwd slot conflict"
                m_f[uf, s], k_f[uf, s], f_ok[uf, s] = m, k, True
                if fwd_only:
                    continue
                ub = u_b(j, m)
                assert not b_ok[ub, s], "bwd slot conflict"
                m_b[ub, s], k_b[ub, s], b_ok[ub, s] = m, k, True
            if fwd_only:
                continue
            # max in-flight microbatches for this (device, chunk): FIFO, so
            # the live set is a contiguous m-window and `m % ring` is unique
            live = max(
                sum(1 for m2 in range(M) if u_f(j, m2) <= u_b(j, m1))
                - m1 for m1 in range(M))
            ring = max(ring, live)
    return {"m_f": m_f, "k_f": k_f, "f_ok": f_ok,
            "m_b": m_b, "k_b": k_b, "b_ok": b_ok,
            "n_superticks": U, "ring": ring}


def _gpipe_tables(S: int, V: int, M: int):
    """Fill-drain tables: the forward tables, then their mirror for the
    backward units (bwd(j, m) at the forward clock of stage J-1-j, so a
    gradient reaches stage j-1 one supertick after stage j made it)."""
    fwd = _1f1b_schedule_tables(S, V, M, fwd_only=True)
    uf = fwd["n_superticks"]
    J = V * S
    m_b = np.zeros((uf, S), np.int32)
    k_b = np.zeros((uf, S), np.int32)
    b_ok = np.zeros((uf, S), bool)
    for s in range(S):
        for k in range(V):
            jr = J - 1 - (k * S + s)
            for m in range(M):
                u = jr + (m % S) + (m // S) * J
                assert not b_ok[u, s], "bwd slot conflict"
                m_b[u, s], k_b[u, s], b_ok[u, s] = m, k, True
    zeros_i = np.zeros((uf, S), np.int32)
    zeros_b = np.zeros((uf, S), bool)
    return {"m_f": np.concatenate([fwd["m_f"], zeros_i]),
            "k_f": np.concatenate([fwd["k_f"], zeros_i]),
            "f_ok": np.concatenate([fwd["f_ok"], zeros_b]),
            "m_b": np.concatenate([zeros_i, m_b]),
            "k_b": np.concatenate([zeros_i, k_b]),
            "b_ok": np.concatenate([zeros_b, b_ok]),
            "n_superticks": 2 * uf, "ring": M}


def schedule_tables(schedule: str, S: int, V: int, M: int,
                    grad: bool = True):
    """The supertick tables a rank walks for `schedule` ("gpipe",
    "remat", "1f1b"); forward only when `grad` is False."""
    if schedule not in ("gpipe", "remat", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if not grad:
        return _1f1b_schedule_tables(S, V, M, fwd_only=True)
    if schedule == "1f1b":
        return _1f1b_schedule_tables(S, V, M)
    return _gpipe_tables(S, V, M)


# ------------------------------------------------------------ rank core

class PipeStats:
    """What one rank's run moved and kept: P2P sends and receives (count,
    bytes) and the most residual sets alive at once per chunk."""

    def __init__(self, V: int):
        self.sends = self.recvs = 0
        self.send_bytes = self.recv_bytes = 0
        self.live = [0] * V
        self.max_live = [0] * V

    def as_dict(self) -> Dict[str, object]:
        return {"sends": self.sends, "recvs": self.recvs,
                "send_bytes": self.send_bytes,
                "recv_bytes": self.recv_bytes,
                "max_live": list(self.max_live)}


def _float(t) -> bool:
    return t.is_floating_point() or t.is_complex()


def rank_core(prog, tables, M: int, train: bool):
    """One rank's walk of `tables` as a generator: it yields (sends,
    recvs) at the end of every supertick and is sent back the received
    tensors.  sends: [(peer stage, tag, [tensors])]; recvs: [(peer stage,
    tag, [(shape, dtype)])].  Returns {"loss": summed loss of the final
    stage's microbatches or None, "grads": [per chunk list of param
    gradients], "dx": {m: input gradients of global stage 0}, "out":
    {m: final stage outputs}, "stats": PipeStats}.

    `prog` is the rank's stage program: attributes S, s, V, device;
    params(k) -> leaf tensors of chunk k (requires_grad when training);
    first_inputs(m) -> inputs of global stage 0 for microbatch m;
    body(k, m, ins) -> outputs of chunk k (the final global stage returns
    [scalar loss] when training); in_meta(k) -> [(shape, dtype)] of chunk
    k's inputs."""
    S, s, V = prog.S, prog.s, prog.V
    J = V * S
    f_ok, m_f, k_f = tables["f_ok"], tables["m_f"], tables["k_f"]
    b_ok, m_b, k_b = tables["b_ok"], tables["m_b"], tables["k_b"]
    stats = PipeStats(V)
    acts: Dict = {}
    gins: Dict = {}
    saved: Dict = {}
    seeds: Dict = {}
    grads = [None] * V
    dx: Dict = {}
    out: Dict = {}
    loss = None
    nxt, prv = (s + 1) % S, (s - 1) % S
    for u in range(tables["n_superticks"]):
        sends, recvs, wants = [], [], []
        if f_ok[u, s]:
            k, m = int(k_f[u, s]), int(m_f[u, s])
            j = k * S + s
            ins = prog.first_inputs(m) if j == 0 else acts.pop((k, m))
            if train:
                ins = [x.detach().requires_grad_() if _float(x) else x
                       for x in ins]
                with torch.enable_grad():
                    outs = prog.body(k, m, ins)
                saved[(k, m)] = (ins, outs)
                stats.live[k] += 1
                stats.max_live[k] = max(stats.max_live[k], stats.live[k])
            else:
                with torch.no_grad():
                    outs = prog.body(k, m, ins)
            if j == J - 1:
                if train:
                    lval = outs[0].detach()
                    loss = lval if loss is None else loss + lval
                    seeds[(k, m)] = [torch.full_like(lval, 1.0 / M)]
                else:
                    out[m] = outs
            else:
                sends.append((nxt, ACT_TAG, [o.detach() for o in outs]))
        if b_ok[u, s]:
            k, m = int(k_b[u, s]), int(m_b[u, s])
            j = k * S + s
            g = seeds.pop((k, m)) if j == J - 1 else gins.pop((k, m))
            ins, outs = saved.pop((k, m))
            stats.live[k] -= 1
            pairs = [(o, gi) for o, gi in zip(
                [o for o in outs if _float(o)], g) if o.requires_grad]
            params = prog.params(k)
            wrt = [x for x in ins if _float(x)] + params
            got = torch.autograd.grad(
                [o for o, _ in pairs], wrt, [gi for _, gi in pairs],
                allow_unused=True) if pairs else [None] * len(wrt)
            n_in = len(wrt) - len(params)
            dins = [gi if gi is not None else torch.zeros_like(x)
                    for gi, x in zip(got[:n_in], wrt[:n_in])]
            acc = grads[k]
            grads[k] = [
                (a if gi is None else gi if a is None else a + gi)
                for a, gi in zip(acc or [None] * len(params), got[n_in:])]
            del ins, outs, got
            if j == 0:
                dx[m] = dins
            else:
                sends.append((prv, GRAD_TAG, dins))
        # what the neighbours send at this supertick, from their columns
        if f_ok[u, prv]:
            jp = int(k_f[u, prv]) * S + prv
            if jp != J - 1:
                k_me = (jp + 1) // S
                recvs.append((prv, ACT_TAG, prog.in_meta(k_me)))
                wants.append((acts, (k_me, int(m_f[u, prv]))))
        if b_ok[u, nxt]:
            jq = int(k_b[u, nxt]) * S + nxt
            if jq != 0:
                k_me = (jq - 1) // S
                metas = [mt for mt in prog.out_meta(k_me)
                         if mt[1].is_floating_point]
                recvs.append((nxt, GRAD_TAG, metas))
                wants.append((gins, (k_me, int(m_b[u, nxt]))))
        for _, _, ts in sends:
            stats.sends += len(ts)
            stats.send_bytes += sum(t.numel() * t.element_size() for t in ts)
        # every supertick yields, traffic or not, so chained cores stay
        # in lockstep
        received = yield sends, recvs
        for (box, key), ts in zip(wants, received):
            stats.recvs += len(ts)
            stats.recv_bytes += sum(t.numel() * t.element_size() for t in ts)
            box[key] = ts
    params_grads = []
    for k in range(V):
        ps = prog.params(k)
        gk = grads[k] or [None] * len(ps)
        params_grads.append([torch.zeros_like(p) if gi is None else gi
                             for gi, p in zip(gk, ps)])
    return {"loss": loss, "grads": params_grads, "dx": dx, "out": out,
            "stats": stats}


def _exchange(sends, recvs, group, s: int, device):
    """One supertick's messages as one batch_isend_irecv on `group`
    (messages to this rank itself, a one-stage ring, are handed over;
    bool tensors travel as uint8)."""
    local = [ts for peer, _, ts in sends if peer == s]
    ops = []
    for peer, tag, ts in sends:
        if peer != s:
            dst = dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, (t.to(torch.uint8)
                                            if t.dtype == torch.bool
                                            else t.contiguous()),
                               dst, group, tag + i)
                    for i, t in enumerate(ts)]
    got = []
    for peer, tag, metas in recvs:
        if peer == s:
            got.append(local.pop(0))
            continue
        src = dist.get_global_rank(group, peer)
        bufs = [torch.zeros(shape, device=device, dtype=torch.uint8
                            if dtype == torch.bool else dtype)
                for shape, dtype in metas]
        ops += [dist.P2POp(dist.irecv, b, src, group, tag + i)
                for i, b in enumerate(bufs)]
        got.append((bufs, [dtype for _, dtype in metas]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [m if isinstance(m, list) else
            [b.bool() if dt == torch.bool else b for b, dt in zip(*m)]
            for m in got]


def drive_p2p(core, group, s: int, device):
    """Run one rank's core against its pipeline group."""
    try:
        msg = next(core)
        while True:
            msg = core.send(_exchange(*msg, group, s, device))
    except StopIteration as stop:
        return stop.value


def drive_local(cores):
    """Run every stage's core in this process, in lockstep: each yields
    once per supertick with traffic (all of them at the same superticks,
    since the tables tie their columns), and the messages are handed
    over in memory."""
    results = [None] * len(cores)
    msgs = {}
    for s, c in enumerate(cores):
        try:
            msgs[s] = next(c)
        except StopIteration as stop:
            results[s] = stop.value
    while msgs:
        mail = {}
        for s, (sends, _) in msgs.items():
            for peer, tag, ts in sends:
                mail.setdefault((s, peer, tag), []).append(ts)
        nxt = {}
        for s, (_, recvs) in msgs.items():
            got = [mail[(peer, s, tag)].pop(0) for peer, tag, _ in recvs]
            try:
                nxt[s] = cores[s].send(got)
            except StopIteration as stop:
                results[s] = stop.value
        msgs = nxt
    return results


# ----------------------------------------------------- stacked programs

def _spec_tails(stage_params, config: PipelineConfig):
    """Per-leaf tail specs (tuples of axis names / None) or None."""
    if config.param_spec is None:
        return None
    leaves, spec = pytree.tree_flatten(stage_params)
    is_tail = lambda x: isinstance(x, tuple)  # noqa: E731
    tails, tspec = pytree.tree_flatten(config.param_spec, is_leaf=is_tail)
    if tspec == spec:
        return tails
    return [tuple(config.param_spec)] * len(leaves)


class _StackedProgram:
    """One rank's program of a homogeneous pipeline: chunk k runs
    `stage_fn` on global stage row k*S + s."""

    def __init__(self, stage_fn, rows, spec, S, s, V, mbs, targets,
                 loss3, loss_leaves, lspec, remat, train):
        self.S, self.s, self.V = S, s, V
        self.stage_fn, self.spec = stage_fn, spec
        self.mbs, self.targets = mbs, targets
        self.loss3, self.lspec = loss3, lspec
        self.remat = remat
        self.device = mbs.device
        self.rows = [[(p.detach().requires_grad_() if train else p)
                      for p in row] for row in rows]
        self.loss_leaves = [(p.detach().requires_grad_() if train else p)
                            for p in loss_leaves]
        self.final = s == S - 1

    def params(self, k):
        if self.final and k == self.V - 1:
            return self.rows[k] + self.loss_leaves
        return self.rows[k]

    def first_inputs(self, m):
        return [self.mbs[m]]

    def in_meta(self, k):
        return [(tuple(self.mbs.shape[1:]), self.mbs.dtype)]

    out_meta = in_meta

    def _stage(self, k, x):
        rows = self.rows[k]
        if not self.remat:
            return self.stage_fn(pytree.tree_unflatten(rows, self.spec), x)
        from torch.utils.checkpoint import checkpoint

        def run(x_, *leaves):
            return self.stage_fn(pytree.tree_unflatten(list(leaves),
                                                       self.spec), x_)

        return checkpoint(run, x, *rows, use_reentrant=False)

    def body(self, k, m, ins):
        y = self._stage(k, ins[0])
        if self.final and k == self.V - 1 and self.loss3 is not None:
            lp = pytree.tree_unflatten(self.loss_leaves, self.lspec)
            return [self.loss3(y, self.targets[m], lp)]
        return [y]


def _rank_rows(stage_params, S: int, V: int, s: int, tails, mesh):
    """[[leaves of chunk k's row] for k in range(V)] of rank `s`, the
    leaves cut per `tails` for the rank's coordinates."""
    leaves, spec = pytree.tree_flatten(stage_params)
    lead = leaves[0].shape[0]
    if lead == V * S:
        pick = [k * S + s for k in range(V)]
    elif lead == V:
        pick = list(range(V))
    else:
        raise ValueError(f"stage params lead with {lead} rows; expected "
                         f"n_virtual * n_stages = {V * S} (all stages) or "
                         f"n_virtual = {V} (this rank's)")
    rows = []
    for r in pick:
        row = []
        for i, p in enumerate(leaves):
            x = p[r]
            for d, name in enumerate(tails[i] if tails else ()):
                if name is not None:
                    ax = mesh_axis(mesh, name)
                    x = local_block(x, d, ax.size, ax.index, "param")
            row.append(x)
        rows.append(row)
    return rows, spec


def _check_mesh(mesh, config: PipelineConfig):
    S = config.n_stages
    if isinstance(mesh, LocalStages):
        if mesh.n != S:
            raise ValueError(f"LocalStages({mesh.n}), expected "
                             f"n_stages={S}")
        if config.data_axis or config.param_spec is not None:
            raise ValueError("LocalStages chains the stages alone: no "
                             "data_axis or param_spec")
        return None
    ax = mesh_axis(mesh, config.axis_name)
    if ax.size != S:
        raise ValueError(f"mesh axis {config.axis_name!r} has size "
                         f"{ax.size}, expected n_stages={S}")
    return ax


def _run(config, mesh, ax, make_prog, tables, train):
    """Every stage's core in this process (LocalStages) or this rank's
    against its pipeline group: ([results by stage], this rank's stage
    or None)."""
    M = config.n_microbatches
    if ax is None:
        progs = [make_prog(s) for s in range(config.n_stages)]
        return drive_local([rank_core(p, tables, M, train)
                            for p in progs]), None
    prog = make_prog(ax.index)
    return [drive_p2p(rank_core(prog, tables, M, train), ax.group,
                      ax.index, prog.device)], ax.index


def _microbatches(x, config: PipelineConfig, mesh):
    if config.data_axis is None:
        return x
    dax = mesh_axis(mesh, config.data_axis)
    return local_block(x, 1, dax.size, dax.index)


def spmd_pipeline(stage_fn: Callable, mesh, config: PipelineConfig):
    """Build fn(stage_params, microbatches) -> outputs [M, ...] of the
    last stage, replicated over the pipeline axis (a sum over its group,
    the JAX package's psum), forward only.  Interleaved with n_virtual >
    1.  Training goes through `spmd_pipeline_grad`."""
    S, V = config.n_stages, max(1, config.n_virtual)
    ax = _check_mesh(mesh, config)
    tables = schedule_tables(config.schedule, S, V, config.n_microbatches,
                             grad=False)

    def pipelined(stage_params, microbatches):
        tails = _spec_tails(stage_params, config)
        mbs = _microbatches(microbatches, config, mesh)

        def make_prog(s):
            rows, spec = _rank_rows(stage_params, S, V, s, tails, mesh)
            return _StackedProgram(stage_fn, rows, spec, S, s, V, mbs,
                                   None, None, [], None, False, False)

        results, s = _run(config, mesh, ax, make_prog, tables, False)
        pipelined.stats = [r["stats"].as_dict() for r in results]
        last = results[-1]
        if s is not None and s != S - 1:
            outs = torch.zeros_like(mbs)
        else:
            outs = torch.stack([last["out"][m][0]
                                for m in range(config.n_microbatches)])
        if s is not None:
            outs = comm.all_reduce_sum(outs, ax.group)
        return outs

    return pipelined


def spmd_pipeline_grad(stage_fn: Callable, loss_fn: Callable, mesh,
                       config: PipelineConfig, aux: bool = False):
    """Build fn(stage_params, microbatches, targets) -> (loss, grads).

    loss = mean over microbatches of ``loss_fn(last_stage_out_mb,
    target_mb)``; grads are those of the unpipelined step (this rank's
    rows on a mesh).  With ``aux=True`` the loss takes trailing
    parameters, ``loss_fn(out_mb, target_mb, loss_params)``, and the
    function becomes ``fn(stage_params, microbatches, targets,
    loss_params) -> (loss, stage_grads, dmicrobatches, dloss_params)``:
    what a larger model needs around its pipelined middle (embedding in
    front, head behind).  Loss, dmicrobatches and dloss_params are
    summed over the pipeline group (replicated, as the JAX package's
    psum); with `data_axis` they and the stage gradients are averaged
    over it (dmicrobatches divided by its size)."""
    S, M = config.n_stages, config.n_microbatches
    V = max(1, config.n_virtual)
    ax = _check_mesh(mesh, config)
    tables = schedule_tables(config.schedule, S, V, M)
    remat = config.schedule == "remat"
    loss3 = loss_fn if aux else (lambda o, t, lp: loss_fn(o, t))

    def pipelined(stage_params, microbatches, targets, loss_params=None):
        tails = _spec_tails(stage_params, config)
        mbs = _microbatches(microbatches, config, mesh)
        tgts = _microbatches(targets, config, mesh)
        l_leaves, l_spec = pytree.tree_flatten(loss_params if aux else ())

        def make_prog(s):
            rows, spec = _rank_rows(stage_params, S, V, s, tails, mesh)
            return _StackedProgram(stage_fn, rows, spec, S, s, V, mbs, tgts,
                                   loss3, l_leaves, l_spec, remat, True)

        results, s = _run(config, mesh, ax, make_prog, tables, True)
        pipelined.stats = [r["stats"].as_dict() for r in results]
        pipelined.tables = tables
        n_p = len(pytree.tree_leaves(stage_params))
        last = results[-1]
        final = last["loss"] is not None
        loss = last["loss"] / M if final else \
            torch.zeros((), device=mbs.device)
        dlp = last["grads"][V - 1][n_p:] if final else \
            [torch.zeros_like(p) for p in l_leaves]
        first = results[0]
        dxs = torch.stack([first["dx"][m][0] for m in range(M)]) \
            if first["dx"] else torch.zeros_like(mbs)
        # this rank's (or, chained, every stage's) rows [n_rows, ...]
        rows = []
        for r in results:
            rows.extend(r["grads"][k][:n_p] for k in range(V))
        if ax is None:  # chained: rows in global stage order j = k*S + s
            rows = [rows[s_ * V + k] for k in range(V) for s_ in range(S)]
        stacked = [torch.stack([row[i] for row in rows])
                   for i in range(len(rows[0]))]
        if s is not None:
            loss = comm.all_reduce_sum(loss, ax.group)
            dxs = comm.all_reduce_sum(dxs, ax.group)
            dlp = [comm.all_reduce_sum(d, ax.group) for d in dlp]
            if config.data_axis:
                dax = mesh_axis(mesh, config.data_axis)
                n = dax.size
                loss = comm.all_reduce_sum(loss, dax.group) / n
                stacked = [comm.all_reduce_sum(d, dax.group) / n
                           for d in stacked]
                dlp = [comm.all_reduce_sum(d, dax.group) / n for d in dlp]
                dxs = dxs / n
        grads = pytree.tree_unflatten(
            stacked, pytree.tree_structure(stage_params))
        if aux:
            return loss, grads, dxs, pytree.tree_unflatten(dlp, l_spec)
        return loss, grads

    return pipelined
