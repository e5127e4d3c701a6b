"""Capacity planner: "how many chips for X req/s at p99 < Y?" (port of
easydist_tpu/sim/capacity.py, which imports nothing of JAX; the traces
draw from the same numpy generator, so the plans are the same).

Couples the calibrated simulator (`sim.simulate` — per-replica service
times) to an open-loop queueing replay (`sim.events.ServerPool` — FCFS,
least-loaded dispatch, the fleet router's occupancy scoring term) over a
deterministic sampled traffic trace, and sweeps replica counts and
prefill/decode splits over a `MeshDesc` (reshard/plan.py).  AoiZora
(arXiv:2606.17566) does exactly this placement-over-mesh-description
reasoning for inference capacity; DistIR supplies the calibrated service
times underneath.

Everything is host-side python over descriptions — a full sweep of a
16-replica mesh runs in milliseconds, which is what lets the autoscaler
re-plan on every control tick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .events import EventLog, ServerPool, percentile

__all__ = ["TrafficSpec", "SLO", "ReplicaProfile", "CapacityPlan",
           "CapacityPlanner"]


@dataclass(frozen=True)
class TrafficSpec:
    """Open-loop arrival spec: Poisson arrivals at `req_per_s`, request
    shapes drawn from the (choice, weight) distributions, and
    `prefix_reuse` of requests hitting a warm prefix cache (their leading
    chunks are free — the serving layer's prefix-trie contract)."""

    req_per_s: float
    prompt_lens: Tuple[int, ...] = (64,)
    prompt_weights: Tuple[float, ...] = ()
    output_lens: Tuple[int, ...] = (16,)
    output_weights: Tuple[float, ...] = ()
    prefix_reuse: float = 0.0

    @classmethod
    def from_metrics(cls, snapshot: Dict[str, Any],
                     elapsed_s: float) -> "TrafficSpec":
        """Estimate a TrafficSpec from a live replica's
        `ServeMetrics.snapshot()` over an `elapsed_s` observation window —
        closing the loop from admission counters back into the planner
        (ROADMAP: feed `sim.capacity` from serving telemetry instead of
        hand-written specs).

          * arrival rate: admissions (`prefills`) / elapsed_s;
          * prompt distribution: the exact per-length admission histogram
            (`prompt_hist`), lengths as choices, counts as weights;
          * output length: mean tokens generated per completed request
            (one choice — the planner's queueing replay only needs the
            service-time mass, not the tail shape);
          * prefix_reuse: restored-token fraction
            (`prefix_tokens_reused / prefix_tokens_total`), the same
            quantity the prefix_cache_hit_rate gauge tracks.
        """
        if elapsed_s <= 0.0:
            raise ValueError(f"elapsed_s must be positive, got {elapsed_s}")
        counters = snapshot.get("counters", {})
        prefills = int(counters.get("prefills", 0))
        if prefills < 1:
            raise ValueError("snapshot has no admissions to estimate from")
        hist = {int(k): int(v)
                for k, v in (snapshot.get("prompt_hist") or {}).items()}
        if not hist:
            raise ValueError("snapshot carries no prompt_hist (admissions "
                             "predate the histogram, or a non-serving "
                             "snapshot was passed)")
        lens = tuple(sorted(hist))
        weights = tuple(float(hist[l]) for l in lens)
        completed = int(counters.get("requests_completed", 0)) or prefills
        generated = int(counters.get("tokens_generated", 0))
        out_mean = max(1, round(generated / completed)) if generated else 16
        total = int(counters.get("prefix_tokens_total", 0))
        reused = int(counters.get("prefix_tokens_reused", 0))
        return cls(req_per_s=prefills / elapsed_s,
                   prompt_lens=lens, prompt_weights=weights,
                   output_lens=(int(out_mean),),
                   prefix_reuse=(reused / total) if total else 0.0)

    def sample(self, n: int, seed: int = 0
               ) -> List[Tuple[float, int, int, bool]]:
        """Deterministic trace of `n` arrivals:
        [(arrival_s, prompt_len, output_len, prefix_hit)]."""
        import numpy as np

        rng = np.random.default_rng(seed)
        if self.req_per_s <= 0.0:
            raise ValueError("req_per_s must be positive")
        gaps = rng.exponential(1.0 / self.req_per_s, size=n)
        arrivals = np.cumsum(gaps)
        pw = (np.asarray(self.prompt_weights, dtype=float)
              if self.prompt_weights else None)
        ow = (np.asarray(self.output_weights, dtype=float)
              if self.output_weights else None)
        plens = rng.choice(np.asarray(self.prompt_lens), size=n,
                           p=pw / pw.sum() if pw is not None else None)
        olens = rng.choice(np.asarray(self.output_lens), size=n,
                           p=ow / ow.sum() if ow is not None else None)
        hits = rng.random(n) < self.prefix_reuse
        return [(float(arrivals[i]), int(plens[i]), int(olens[i]),
                 bool(hits[i])) for i in range(n)]


@dataclass(frozen=True)
class SLO:
    """The serving objective the plan must meet."""

    ttft_p99_s: float
    per_token_p99_s: float


@dataclass(frozen=True)
class ReplicaProfile:
    """Simulator-derived service model of ONE replica: what
    `sim.simulate` predicts for its decode step and prefill chunk."""

    per_token_s: float       # one batched decode round (all live slots)
    chunk_s: float           # one chunked-prefill step
    chunk_tokens: int        # prompt tokens absorbed per chunk
    n_slots: int             # decode slots per replica
    chips: int = 1           # devices one replica occupies

    def prefill_chunks(self, prompt_len: int, prefix_hit: bool) -> int:
        chunks = max(1, math.ceil(prompt_len / max(1, self.chunk_tokens)))
        if prefix_hit:
            # a warm prefix covers all but the trailing chunk (the trie
            # caches whole pages; the tail always recomputes)
            chunks = 1
        return chunks

    def ttft_service_s(self, prompt_len: int, prefix_hit: bool) -> float:
        from .simulate import predict_ttft

        n = self.prefill_chunks(prompt_len, prefix_hit)
        return predict_ttft(self.chunk_s, n, self.per_token_s)

    def decode_service_s(self, output_len: int) -> float:
        return max(0, output_len - 1) * self.per_token_s


@dataclass
class CapacityPlan:
    """One evaluated point of the sweep, rankable."""

    n_replicas: int
    n_prefill: int            # 0 = colocated prefill+decode
    chips: int
    feasible: bool
    ttft_p99_s: float
    per_token_p99_s: float
    utilization: float        # busy fraction of the decode slots
    headroom: float           # 1 - max(slo fractions); higher = safer
    detail: Dict[str, Any] = field(default_factory=dict)

    def sort_key(self) -> Tuple:
        # feasible plans first, then fewest chips, then most headroom
        return (not self.feasible, self.chips, -self.headroom)

    def as_dict(self) -> Dict[str, Any]:
        return {"n_replicas": self.n_replicas,
                "n_prefill": self.n_prefill, "chips": self.chips,
                "feasible": self.feasible,
                "ttft_p99_s": round(self.ttft_p99_s, 6),
                "per_token_p99_s": round(self.per_token_p99_s, 9),
                "utilization": round(self.utilization, 4),
                "headroom": round(self.headroom, 4)}


class CapacityPlanner:

    def __init__(self, profile: ReplicaProfile, mesh_desc,
                 n_requests: int = 512, seed: int = 0):
        self.profile = profile
        self.mesh = mesh_desc
        self.n_requests = int(n_requests)
        self.seed = int(seed)
        if profile.chips < 1:
            raise ValueError("chips per replica must be >= 1")
        self.max_replicas = max(1, self.mesh.n_devices // profile.chips)

    # ------------------------------------------------------------ evaluate

    def evaluate(self, n_replicas: int, traffic: TrafficSpec, slo: SLO,
                 n_prefill: int = 0) -> CapacityPlan:
        """Open-loop queueing replay of one configuration.

        Requests flow prefill -> decode.  With `n_prefill` > 0 the pools
        are disaggregated (the router's prefill/decode split); with 0,
        prefill steals the shared replica, which is modeled by folding
        prefill service into the same pool.  Decode capacity is
        slots x replicas (a decode round batches every live slot, so a
        slot is the unit of decode concurrency)."""
        p = self.profile
        n_decode = n_replicas - n_prefill
        if n_decode < 1:
            raise ValueError(
                f"split leaves no decode replicas "
                f"({n_replicas} total, {n_prefill} prefill)")
        trace = traffic.sample(self.n_requests, seed=self.seed)
        log = EventLog()
        prefill_pool = ServerPool(max(1, n_prefill) if n_prefill
                                  else n_decode, log, name="prefill")
        decode_pool = ServerPool(n_decode * p.n_slots, log, name="decode")

        ttfts: List[float] = []
        for arrival, plen, olen, hit in trace:
            svc = p.ttft_service_s(plen, hit)
            _, first_token_t, _ = prefill_pool.submit(arrival, svc)
            ttfts.append(first_token_t - arrival)
            decode_pool.submit(first_token_t, p.decode_service_s(olen))

        horizon = max(decode_pool.drain_time(), prefill_pool.drain_time())
        busy = sum(s - w for s, w in zip(decode_pool.sojourns,
                                         decode_pool.waits))
        util = (busy / (horizon * n_decode * p.n_slots)
                if horizon > 0 else 0.0)
        ttft_p99 = percentile(ttfts, 99.0)
        # a decoding slot commits one token per batched round; queueing
        # for a slot surfaces in TTFT, so steady-state per-token latency
        # is the round time itself
        per_token_p99 = p.per_token_s
        frac_ttft = ttft_p99 / slo.ttft_p99_s if slo.ttft_p99_s > 0 \
            else math.inf
        frac_tok = (per_token_p99 / slo.per_token_p99_s
                    if slo.per_token_p99_s > 0 else math.inf)
        worst = max(frac_ttft, frac_tok)
        return CapacityPlan(
            n_replicas=n_replicas, n_prefill=n_prefill,
            chips=n_replicas * p.chips,
            feasible=worst <= 1.0,
            ttft_p99_s=ttft_p99, per_token_p99_s=per_token_p99,
            utilization=min(1.0, util), headroom=1.0 - worst,
            detail={"ttft_p50_s": percentile(ttfts, 50.0),
                    "n_requests": len(trace)})

    # --------------------------------------------------------------- sweep

    def plan(self, traffic: TrafficSpec, slo: SLO,
             splits: Optional[Sequence[int]] = None) -> List[CapacityPlan]:
        """Sweep replica counts (and prefill/decode splits) across the
        mesh; returns every evaluated plan ranked best-first."""
        plans: List[CapacityPlan] = []
        for n in range(1, self.max_replicas + 1):
            for n_prefill in (splits if splits is not None
                              else range(0, max(1, n // 2) + 1)):
                if n - n_prefill < 1:
                    continue
                plans.append(self.evaluate(n, traffic, slo,
                                           n_prefill=n_prefill))
        plans.sort(key=lambda pl: pl.sort_key())
        return plans

    def min_feasible(self, traffic: TrafficSpec, slo: SLO
                     ) -> Optional[CapacityPlan]:
        """The cheapest plan meeting the SLO, or None when even the full
        mesh cannot (the autoscaler then pins max and warns)."""
        for pl in self.plan(traffic, slo):
            if pl.feasible:
                return pl
        return None

    def target_replicas(self, traffic: TrafficSpec, slo: SLO) -> int:
        """Replica count the autoscaler should converge to: the cheapest
        feasible plan's, or the whole mesh when nothing is feasible."""
        best = self.min_feasible(traffic, slo)
        return best.n_replicas if best is not None else self.max_replicas
