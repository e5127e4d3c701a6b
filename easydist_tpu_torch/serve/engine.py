"""`ServeEngine`: a shape-bucketed continuous-batching endpoint over an
easydist-compiled inference function, and `ServeConfig`, the bucketing,
batching and admission policy every serving layer of the port reads
(port of easydist_tpu/serve/engine.py).

Shape bucketing is the core economics: `fxfront.easydist_compile` traces
one program per input signature, so unconstrained request shapes would
trace per request.  The engine pads every packed batch up to configured
`batch_buckets` x `seq_buckets`, giving a closed, warmable set of
programs — each bucket traces exactly once (the signature cache
guarantees it) and every later request is a cache hit.

Robustness is layered in from `admission.py` and `resilience/`: bounded-
queue backpressure at submit, per-request deadlines enforced by the
batcher, transient-failure retry with jittered deadline-respecting backoff
around execution, and graceful degradation on three axes —

  * a batch bucket whose execution exhausts device memory is disabled and
    its requests re-packed into smaller enabled buckets on the same
    device (degrading never moves work to the CPU);
  * a per-batch execute watchdog (`exec_timeout_ms`) abandons a wedged
    dispatch and fails the batch with `ExecTimeoutError` instead of
    pinning every downstream request behind it;
  * a circuit breaker (`breaker_failure_threshold` > 0) sheds load at
    submit with `CircuitOpenError` once the executor fails persistently
    (or p99 execute latency brows out past `breaker_p99_threshold_ms`),
    probing recovery after `breaker_cooldown_ms`.

`health()` summarizes all of it for a readiness endpoint.  The paths are
exercised deterministically by the `serve.exec_timeout` and
`serve.oom_bucket` fault points (resilience/faultinject.py).

Threads: `MicroBatcher` dispatches from its own thread, and the watchdog
from another.  The CUDA current device is per thread, so every dispatch
enters the engine's device explicitly.
"""

from __future__ import annotations

import contextlib
import logging
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import resolve_device, torch_dtype
from easydist_tpu_torch.resilience import faultinject
from easydist_tpu_torch.resilience.breaker import CircuitBreaker

from .admission import (AdmissionController, CircuitOpenError,
                        ExecTimeoutError, QueueFullError,
                        RequestTooLargeError, ServeError, is_oom_error,
                        is_transient_error, retry_transient)
from .batcher import (MicroBatcher, Request, RequestQueue, pack_requests,
                      scatter_results, select_bucket)
from .metrics import ServeMetrics

logger = logging.getLogger(__name__)


def storage_dtype(name) -> torch.dtype:
    """The torch dtype a `kv_cache_dtype` name stores in: a torch dtype
    name ("bfloat16"), or any name numpy parses ("f4", "float16") — the
    JAX package accepts every numpy-parseable name."""
    try:
        return torch_dtype(name)
    except ValueError:
        return torch_dtype(np.dtype(name).name)


def _default_speculate_k() -> int:
    # read at ServeConfig construction (not import) so monkeypatching
    # edconfig.speculate_k takes effect without rebuilding the dataclass
    from easydist_tpu_torch import config as edconfig

    return int(getattr(edconfig, "speculate_k", 0))


def _default_speculate_drafter() -> str:
    from easydist_tpu_torch import config as edconfig

    return str(getattr(edconfig, "speculate_drafter", "ngram"))


@dataclass(frozen=True)
class ServeConfig:
    """Bucketing + batching + admission policy for one engine.

    batch_buckets: allowed padded batch sizes, ascending not required.
    seq_buckets: allowed padded leading-dim lengths for array args (None =
        requests must agree exactly on shapes; only the batch dim pads).
    max_wait_ms: how long the batcher holds the first request of a batch
        open for stragglers (latency floor vs occupancy knob).
    max_queue: bounded queue depth; submits beyond it raise QueueFullError.
    default_deadline_ms: deadline applied when submit() passes none.
    max_retries / retry_backoff_ms / retry_jitter: transient-failure policy
        per batch (jitter stretches each backoff by up to that fraction).
    pad_value: fill for seq padding (e.g. the pad token id).
    unpad_outputs: slice outputs back to each request's original length.
    exec_timeout_ms: per-batch execute watchdog; None disables.
    breaker_failure_threshold: consecutive executor failures before the
        circuit opens; 0 disables the breaker entirely.
    breaker_cooldown_ms: how long the open circuit sheds before probing.
    breaker_p99_threshold_ms / breaker_min_samples: optional brownout trip
        on observed p99 execute latency.
    decode_buckets: allowed KV-cache max-lengths for token-level decode
        (serve/generation.py); each bucket owns one slot pool and exactly
        one compiled decode step.
    kv_cache_dtype: cache storage dtype ("auto" = the model's dtype,
        else a torch or numpy dtype name); visible in every decode
        signature.
    max_decode_slots: slots per decode bucket — the fixed decode batch
        width (idle slots show up as occupancy, never as a new signature).
    prefill_chunk: token window of one chunked-prefill pass — prompts run
        in fixed [prefill_batch, prefill_chunk] chunk calls, so ONE
        compiled prefill signature per bucket serves every prompt length;
        also the prefix-cache chunk granularity (reuse is whole chunks).
    prefill_batch: staging rows — how many pending prompts pack into a
        single chunked-prefill call.
    prefill_chunks_per_step: chunk calls interleaved per `step()` before
        the decode rounds run — bounds decode p99 under prefill pressure.
    enable_prefix_cache: commit/restore prefix KV chunks via the token
        trie (serve/prefix_cache.py); off = every prompt recomputes from
        position 0 (bitwise-identical outputs either way).
    prefix_cache_bytes: LRU byte budget per decode bucket's trie; 0
        disables committing.
    kv_layout: decode KV storage — "bucketed" (one padded slot pool per
        decode bucket) or "paged" (ONE page-granular
        pool over a preallocated arena: arbitrary lengths in one compiled
        decode step, no bucket padding, zero-copy prefix restore; needs
        the paged model callables `for_gpt`/`for_llama` wire).
    kv_page_tokens: tokens per KV page in the paged layout; 0 = the
        effective prefill chunk (pages ARE the prefix-trie chunks, which
        is what makes restore a pure table mapping).
    kv_arena_pages: arena size in pages; 0 = auto
        (max_decode_slots * pages-per-sequence + one sequence's worth of
        headroom for trie-held pages).
    speculate_k: draft tokens proposed per speculative-decoding verify
        round (serve/speculate.py); 0 disables speculation.  The verify
        program scores [slots, k+1] positions in one fixed-shape call —
        k is a shape, so changing it means one new traced signature.
        Output is bitwise-identical to speculate_k=0 (greedy parity).
    speculate_drafter: "ngram" (zero-cost self-speculative prompt
        lookup) or "draft_model" (a second small model's cached greedy
        decode; the session must be given a drafter or draft_model).
    kv_quant_dtype: "none" (exact storage — the bitwise path) or "int8"
        (paged arena pages stored block-scaled int8 with a parallel f32
        scale arena; ~4x sequences per device byte, greedy output gated by
        the bounded-drift A/B harness rather than bitwise).  Paged layout
        only, and mutually exclusive with a non-auto kv_cache_dtype.
    kv_quant_block: head-dim elements per quantization block (one f32
        scale each); 0 = one block per K/V row (head_dim).  Must divide
        head_dim.
    kv_host_tier_bytes: host-RAM byte budget for demoting cold unpinned
        prefix-trie pages out of the device arena (kv/tier.py; chunked
        copies, sha256 manifests, promote-on-hit); 0 disables the tier.
        Paged layout with the prefix cache enabled only.
    """
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    seq_buckets: Optional[Tuple[int, ...]] = None
    max_wait_ms: float = 5.0
    max_queue: int = 256
    default_deadline_ms: Optional[float] = None
    max_retries: int = 2
    retry_backoff_ms: float = 10.0
    retry_jitter: float = 0.25
    pad_value: object = 0
    unpad_outputs: bool = True
    exec_timeout_ms: Optional[float] = None
    breaker_failure_threshold: int = 0
    breaker_cooldown_ms: float = 1000.0
    breaker_p99_threshold_ms: Optional[float] = None
    breaker_min_samples: int = 20
    decode_buckets: Tuple[int, ...] = (1024,)
    kv_cache_dtype: str = "auto"
    max_decode_slots: int = 8
    prefill_chunk: int = 64
    prefill_batch: int = 4
    prefill_chunks_per_step: int = 4
    enable_prefix_cache: bool = True
    prefix_cache_bytes: int = 64 * 2**20
    kv_layout: str = "bucketed"
    kv_page_tokens: int = 0
    kv_arena_pages: int = 0
    speculate_k: int = field(
        default_factory=lambda: _default_speculate_k())
    speculate_drafter: str = field(
        default_factory=lambda: _default_speculate_drafter())
    kv_quant_dtype: str = "none"
    kv_quant_block: int = 0
    kv_host_tier_bytes: int = 0

    def __post_init__(self):
        if not self.batch_buckets:
            raise ValueError("batch_buckets must be non-empty")
        if any(b < 1 for b in self.batch_buckets):
            raise ValueError(f"batch buckets must be >= 1: "
                             f"{self.batch_buckets}")
        if self.seq_buckets is not None and not self.seq_buckets:
            raise ValueError("seq_buckets must be None or non-empty")
        if not 0.0 <= self.retry_jitter <= 1.0:
            raise ValueError(
                f"retry_jitter must be in [0, 1], got {self.retry_jitter}")
        if self.exec_timeout_ms is not None and self.exec_timeout_ms <= 0:
            raise ValueError(f"exec_timeout_ms must be > 0 or None, "
                             f"got {self.exec_timeout_ms}")
        if self.breaker_failure_threshold < 0:
            raise ValueError(
                f"breaker_failure_threshold must be >= 0 (0 disables), "
                f"got {self.breaker_failure_threshold}")
        if self.breaker_cooldown_ms <= 0:
            raise ValueError(f"breaker_cooldown_ms must be > 0, "
                             f"got {self.breaker_cooldown_ms}")
        if not self.decode_buckets or any(b < 1 for b in self.decode_buckets):
            raise ValueError(f"decode_buckets must be non-empty with every "
                             f"bucket >= 1: {self.decode_buckets}")
        if self.kv_cache_dtype != "auto":
            try:
                storage_dtype(self.kv_cache_dtype)
            except (TypeError, ValueError):
                raise ValueError(
                    f"kv_cache_dtype must be 'auto' or a torch or "
                    f"numpy-parseable dtype name, got "
                    f"{self.kv_cache_dtype!r}") from None
        if self.max_decode_slots < 1:
            raise ValueError(f"max_decode_slots must be >= 1, "
                             f"got {self.max_decode_slots}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {self.prefill_chunk}")
        for b in self.decode_buckets:
            # the effective chunk (min(prefill_chunk, bucket)) must tile
            # the bucket exactly: a chunk write that would spill past the
            # bucket gets its start CLAMPED, silently overwriting earlier
            # cache rows
            eff = min(self.prefill_chunk, b)
            if b % eff != 0:
                raise ValueError(
                    f"decode bucket {b} is not a multiple of the "
                    f"effective prefill chunk {eff} "
                    f"(prefill_chunk={self.prefill_chunk}); chunked "
                    f"prefill windows must tile the bucket exactly")
        if self.prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, "
                             f"got {self.prefill_batch}")
        if self.prefill_chunks_per_step < 1:
            raise ValueError(f"prefill_chunks_per_step must be >= 1, "
                             f"got {self.prefill_chunks_per_step}")
        if self.prefix_cache_bytes < 0:
            raise ValueError(f"prefix_cache_bytes must be >= 0 "
                             f"(0 disables), got {self.prefix_cache_bytes}")
        if self.kv_layout not in ("bucketed", "paged"):
            raise ValueError(f"kv_layout must be 'bucketed' or 'paged', "
                             f"got {self.kv_layout!r}")
        if self.kv_page_tokens < 0:
            raise ValueError(f"kv_page_tokens must be >= 0 (0 = the "
                             f"effective prefill chunk), "
                             f"got {self.kv_page_tokens}")
        if self.kv_arena_pages < 0:
            raise ValueError(f"kv_arena_pages must be >= 0 (0 = auto), "
                             f"got {self.kv_arena_pages}")
        if self.kv_layout == "paged":
            cap = max(self.decode_buckets)
            pt = self.kv_page_tokens or min(self.prefill_chunk, cap)
            if pt != min(self.prefill_chunk, cap):
                # pages ARE the prefix-trie chunks: a paged prefill chunk
                # fills exactly one page, and a restored trie node maps
                # exactly one page — different granularities would force
                # copy-on-restore back in
                raise ValueError(
                    f"kv_page_tokens {pt} must equal the effective "
                    f"prefill chunk {min(self.prefill_chunk, cap)} in the "
                    f"paged layout (pages are the trie chunks)")
            if cap % pt != 0:
                raise ValueError(
                    f"max decode bucket {cap} is not a multiple of "
                    f"kv_page_tokens {pt}; pages must tile the sequence "
                    f"capacity exactly")
        if self.kv_quant_dtype not in ("none", "int8"):
            raise ValueError(f"kv_quant_dtype must be 'none' or 'int8', "
                             f"got {self.kv_quant_dtype!r}")
        if self.kv_quant_block < 0:
            raise ValueError(f"kv_quant_block must be >= 0 (0 = one block "
                             f"per row), got {self.kv_quant_block}")
        if self.kv_quant_dtype != "none":
            if self.kv_layout != "paged":
                raise ValueError(
                    f"kv_quant_dtype {self.kv_quant_dtype!r} requires the "
                    f"paged layout (quantize-on-commit lives in the page "
                    f"arena), got kv_layout={self.kv_layout!r}")
            if self.kv_cache_dtype != "auto":
                raise ValueError(
                    f"kv_quant_dtype {self.kv_quant_dtype!r} is mutually "
                    f"exclusive with a non-auto kv_cache_dtype "
                    f"({self.kv_cache_dtype!r}): the quantized arena owns "
                    f"its storage dtype (int8 payload + f32 scales)")
        if self.kv_host_tier_bytes < 0:
            raise ValueError(f"kv_host_tier_bytes must be >= 0 "
                             f"(0 disables), got {self.kv_host_tier_bytes}")
        if self.kv_host_tier_bytes:
            if self.kv_layout != "paged":
                raise ValueError(
                    f"kv_host_tier_bytes requires the paged layout (the "
                    f"tier demotes arena pages), got "
                    f"kv_layout={self.kv_layout!r}")
            if not self.enable_prefix_cache or not self.prefix_cache_bytes:
                raise ValueError(
                    "kv_host_tier_bytes requires the prefix cache (the "
                    "tier holds cold TRIE pages; with no trie there is "
                    "nothing to demote)")
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0 (0 disables "
                             f"speculation), got {self.speculate_k}")
        if self.speculate_k:
            if self.speculate_drafter not in ("ngram", "draft_model"):
                raise ValueError(
                    f"speculate_drafter must be 'ngram' or 'draft_model', "
                    f"got {self.speculate_drafter!r}")
            # the verify step writes a k+1-row window at a traced start:
            # a window wider than the smallest bucket could NEVER be
            # placed without the write's clamp moving it onto committed
            # rows, so k+1 must leave headroom in every bucket
            if self.speculate_k + 1 >= min(self.decode_buckets):
                raise ValueError(
                    f"speculate_k {self.speculate_k} leaves no bucket "
                    f"headroom: k+1 ({self.speculate_k + 1}) must be < "
                    f"the smallest decode bucket "
                    f"({min(self.decode_buckets)})")


class ServeEngine:
    """Continuous-batching server over `fn`.

    fn: a port `CompiledFunction` (from `fxfront.easydist_compile`), or a
        plain callable taking BATCHED tensors — plain callables are
        compiled with `easydist_compile(fn, state_io={})` unless
        `compile=False` (useful for tests and for functions that must
        run eagerly).
    state: optional leading argument (a params pytree on `device`)
        prepended to every batched call — keeps model weights an argument
        of the traced program rather than a constant baked into it.
    device: where batches run (default: the card); packed numpy batches
        are copied there before each call.
    Requests submit UNBATCHED args (numpy arrays or CPU tensors, or
    scalars shared by the batch); results come back unbatched, on the
    host.
    """

    def __init__(self, fn, config: Optional[ServeConfig] = None, *,
                 state=None, device=None, compile: object = "auto",
                 clock: Callable[[], float] = time.monotonic):
        from easydist_tpu_torch.fxfront import (CompiledFunction,
                                                easydist_compile)

        self.config = config or ServeConfig()
        self.state = state
        self.device = resolve_device(device)
        self.clock = clock
        self.metrics = ServeMetrics()
        if isinstance(fn, CompiledFunction):
            self._fn, self._compiled = fn, fn
        elif compile == "auto" or compile is True:
            self._fn = easydist_compile(fn, state_io={})
            self._compiled = self._fn
        else:
            self._fn, self._compiled = fn, None

        self.queue = RequestQueue(self.config.max_queue)
        self.admission = AdmissionController(
            self.config.max_queue, self.config.default_deadline_ms,
            clock=clock)
        self.batcher = MicroBatcher(
            self.queue, self._execute,
            max_batch_size=max(self.config.batch_buckets),
            max_wait_ms=self.config.max_wait_ms,
            metrics=self.metrics, clock=clock)
        self._disabled_buckets: set = set()
        self._seen_exec_keys: set = set()
        self._started = False
        self.breaker: Optional[CircuitBreaker] = None
        if self.config.breaker_failure_threshold > 0:
            p99_ms = self.config.breaker_p99_threshold_ms
            self.breaker = CircuitBreaker(
                failure_threshold=self.config.breaker_failure_threshold,
                cooldown_s=self.config.breaker_cooldown_ms / 1e3,
                p99_threshold_s=(p99_ms / 1e3 if p99_ms is not None
                                 else None),
                min_samples=self.config.breaker_min_samples,
                p99=lambda: self.metrics.execute.percentile(99),
                clock=clock)
        # watchdog pool: one worker — executions are serial anyway; a
        # timed-out dispatch abandons the whole pool (shutdown(wait=False))
        # so the next batch gets a fresh worker instead of queueing behind
        # the wedged call
        self._watchdog: Optional[ThreadPoolExecutor] = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ServeEngine":
        self.batcher.start()
        self._started = True
        return self

    def stop(self) -> None:
        self._started = False
        self.batcher.stop()
        if self._watchdog is not None:
            self._watchdog.shutdown(wait=False)
            self._watchdog = None

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------- submission
    def submit(self, *args, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one unbatched request; returns its result future.
        Raises QueueFullError (backpressure), RequestTooLargeError (no
        bucket fits) or CircuitOpenError (the breaker is shedding)
        synchronously — load shedding happens at the door."""
        self._reject_oversized(args)
        if self.breaker is not None and not self.breaker.allow():
            self.metrics.inc("requests_shed")
            retry_after = self.breaker.retry_after_s()
            raise CircuitOpenError(
                f"circuit open: executor failing persistently; retry in "
                f"{retry_after:.2f}s", retry_after_s=retry_after)
        try:
            self.admission.check_depth(self.queue.depth())
        except QueueFullError:
            self.metrics.inc("requests_rejected")
            raise
        req = Request(args=tuple(args), enqueue_t=self.clock(),
                      deadline_t=self.admission.resolve_deadline(deadline_ms))
        self.metrics.inc("requests_submitted")
        if not self.queue.put(req):  # racing submitters filled it first
            self.metrics.inc("requests_rejected")
            raise QueueFullError(
                f"request queue at capacity ({self.config.max_queue})")
        self.metrics.set_gauge("queue_depth", self.queue.depth())
        return req.future

    def infer(self, *args, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(*args, deadline_ms=deadline_ms).result(
            timeout=timeout)

    def _reject_oversized(self, args) -> None:
        if self.config.seq_buckets is None:
            return
        cap = max(self.config.seq_buckets)
        for j, a in enumerate(args):
            if hasattr(a, "shape") and getattr(a, "ndim", 0) >= 1 \
                    and int(a.shape[0]) > cap:
                raise RequestTooLargeError(
                    f"arg {j} length {int(a.shape[0])} exceeds the largest "
                    f"seq bucket {cap}")

    # ------------------------------------------------------------- warmup
    def warmup(self, example_args: Sequence[object]) -> int:
        """Eagerly trace + run every (batch bucket x seq bucket) shape
        using zero-filled stand-ins shaped like `example_args` (unbatched).
        Returns the number of bucket shapes warmed.  Serving traffic then
        never pays a trace."""
        seqs = self.config.seq_buckets or (None,)
        warmed = 0
        for b in sorted(set(self.config.batch_buckets)):
            if b in self._disabled_buckets:
                continue
            for s in seqs:
                reqs = [Request(args=tuple(
                    self._dummy_arg(a, s) for a in example_args))
                    for _ in range(b)]
                try:
                    # exact serving path (pack -> run), so the signature
                    # cache is warm for real traffic; results discarded
                    batched, meta = pack_requests(
                        reqs, (b,), self.config.seq_buckets,
                        self.config.pad_value)
                    self._run_batched(batched)
                    warmed += 1
                except Exception as e:
                    if is_oom_error(e):
                        self._disable_bucket(b)
                        break
                    raise
        return warmed

    @staticmethod
    def _dummy_arg(example, seq_len):
        if hasattr(example, "shape") and getattr(example, "ndim", 0) >= 1:
            a = np.asarray(example)
            shape = ((seq_len,) if seq_len is not None else a.shape[:1]) \
                + a.shape[1:]
            return np.zeros(shape, dtype=a.dtype)
        return example

    # ------------------------------------------------------------ execution
    def _enabled_buckets(self) -> Tuple[int, ...]:
        out = tuple(b for b in self.config.batch_buckets
                    if b not in self._disabled_buckets)
        if not out:
            raise ServeError(
                "every batch bucket is disabled (all executions OOMed)")
        return out

    def _disable_bucket(self, bucket: int) -> None:
        self._disabled_buckets.add(bucket)
        self.metrics.inc("oom_degradations")
        logger.warning(
            "[serve] batch bucket %d disabled after device-memory "
            "exhaustion; degrading to buckets %s", bucket,
            sorted(set(self.config.batch_buckets) - self._disabled_buckets))

    def _exec_key(self, batched) -> tuple:
        return tuple(
            (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape")
            else ("scalar", repr(a)) for a in batched)

    def _run_batched(self, batched):
        """One device execution of a packed batch, with executable-cache
        accounting and the optional execute watchdog.  Blocks until the
        result is ready (the scatter needs host values anyway, and
        execute latency should include it)."""
        if faultinject.fire("serve.oom_bucket"):
            # deterministic stand-in for the allocator failing at this
            # bucket shape — must route through the degrade path
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory: injected fake device OOM "
                "(serve.oom_bucket fault point)")
        timeout_ms = self.config.exec_timeout_ms
        if timeout_ms is None:
            return self._dispatch(batched)
        if self._watchdog is None:
            self._watchdog = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-exec")
        fut = self._watchdog.submit(self._dispatch, batched)
        try:
            return fut.result(timeout=timeout_ms / 1e3)
        except FutureTimeoutError:
            # a launched kernel cannot be cancelled: abandon the pool —
            # the wedged thread finishes into the void, the next batch
            # gets a fresh worker.  The abandoned dispatch may still be
            # running when the next batch starts; both launch on the
            # device's default stream, so their kernels serialise (the
            # next batch waits for the wedged one on the card, never
            # races it)
            self.metrics.inc("exec_timeouts")
            self._watchdog.shutdown(wait=False)
            self._watchdog = None
            raise ExecTimeoutError(
                f"batch execution exceeded the {timeout_ms:.0f}ms "
                f"watchdog; dispatch abandoned") from None

    def _device_ctx(self):
        """The engine's device as the calling thread's current CUDA
        device (per thread: the batcher's and the watchdog's threads do
        not inherit the main thread's)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _on_device(self, a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(self.device)
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return a

    def _dispatch(self, batched):
        if faultinject.fire("serve.exec_timeout"):
            # simulate a wedged dispatch: sleep well past the watchdog
            t_ms = self.config.exec_timeout_ms
            time.sleep((t_ms * 3 / 1e3) if t_ms is not None else 0.05)
        key = self._exec_key(batched)
        if key in self._seen_exec_keys:
            self.metrics.inc("compile_cache_hits")
        else:
            self.metrics.inc("compile_cache_misses")
            self._seen_exec_keys.add(key)
        with self._device_ctx():
            args = tuple(self._on_device(a) for a in batched)
            call_args = args if self.state is None else (self.state,) + args
            if self._compiled is not None:
                result = self._compiled.get_compiled(*call_args)
                out = result.tree_jitted(*call_args)
            else:
                out = self._fn(*call_args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return out

    def _execute(self, reqs) -> None:
        """Batcher callback: pack -> run (retry/degrade) -> scatter."""
        now = self.clock()
        for r in reqs:
            self.metrics.observe("queue_wait", now - r.enqueue_t)
        self._run_group(list(reqs))

    def _run_group(self, reqs) -> None:
        try:
            batched, meta = pack_requests(
                reqs, self._enabled_buckets(), self.config.seq_buckets,
                self.config.pad_value)
        except Exception as e:
            self._fail(reqs, e)
            return

        def attempt():
            return self._run_batched(batched)

        def transient_and_count(exc):
            ok = is_transient_error(exc)
            if ok:
                self.metrics.inc("transient_retries")
            return ok

        # a retry whose backoff outlives every waiter is pure waste: bound
        # the retry loop by the earliest request deadline in the group
        deadlines = [r.deadline_t for r in reqs if r.deadline_t is not None]
        group_deadline = min(deadlines) if deadlines else None

        t0 = self.clock()
        try:
            out = retry_transient(
                attempt, max_retries=self.config.max_retries,
                backoff_s=self.config.retry_backoff_ms / 1e3,
                is_transient=transient_and_count,
                jitter=self.config.retry_jitter,
                deadline_t=group_deadline, clock=self.clock)
        except Exception as e:
            if self.breaker is not None:
                self.breaker.record_failure()
            if is_oom_error(e):
                self._degrade(reqs, meta.batch_bucket, e)
                return
            self._fail(reqs, e)
            return
        if self.breaker is not None:
            self.breaker.record_success()
        self.metrics.record_batch(meta.n_real, meta.batch_bucket,
                                  self.clock() - t0)
        try:
            results = scatter_results(out, meta, self.config.unpad_outputs)
        except Exception as e:
            self._fail(reqs, e)
            return
        done = self.clock()
        for r, res in zip(reqs, results):
            if not r.future.done():
                r.future.set_result(res)
                self.metrics.inc("requests_completed")
                self.metrics.observe("e2e", done - r.enqueue_t)

    def _degrade(self, reqs, failed_bucket: int, exc: Exception) -> None:
        """OOM on `failed_bucket`: disable it and re-pack into the largest
        enabled smaller bucket on the same device; no smaller bucket ->
        the requests fail."""
        self._disable_bucket(failed_bucket)
        smaller = [b for b in self.config.batch_buckets
                   if b < failed_bucket and b not in self._disabled_buckets]
        if not smaller:
            self._fail(reqs, exc)
            return
        cap = max(smaller)
        for i in range(0, len(reqs), cap):
            self._run_group(reqs[i:i + cap])

    def _fail(self, reqs, exc: Exception) -> None:
        self.metrics.inc("requests_failed", len(reqs))
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)

    # ------------------------------------------------------------ reporting
    def stats(self) -> dict:
        """Metrics snapshot + executable-cache state (the e2e acceptance
        surface: trace count == distinct buckets, hit rate > 0)."""
        out = self.metrics.snapshot()
        out["distinct_executables"] = len(self._seen_exec_keys)
        out["disabled_batch_buckets"] = sorted(self._disabled_buckets)
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        if self._compiled is not None:
            out["backend_cache"] = self._compiled.cache_stats()
        return out

    def health(self) -> dict:
        """Liveness/readiness summary for an external health endpoint.

        ready: the engine accepts new work right now (started, circuit not
        open, at least one batch bucket still enabled).
        degraded: serving, but with reduced capability (disabled buckets,
        watchdog timeouts or shed requests observed, half-open circuit).
        """
        breaker_state = (self.breaker.state if self.breaker is not None
                         else "disabled")
        enabled = tuple(b for b in self.config.batch_buckets
                        if b not in self._disabled_buckets)
        m = self.metrics
        ready = bool(self._started and enabled and breaker_state != "open")
        degraded = bool(
            self._disabled_buckets or breaker_state in ("open", "half_open")
            or m.counter("exec_timeouts") or m.counter("requests_shed"))
        return {
            "started": self._started,
            "ready": ready,
            "degraded": degraded,
            "breaker_state": breaker_state,
            "enabled_batch_buckets": list(enabled),
            "disabled_batch_buckets": sorted(self._disabled_buckets),
            "exec_timeouts": m.counter("exec_timeouts"),
            "requests_shed": m.counter("requests_shed"),
            "oom_degradations": m.counter("oom_degradations"),
        }

    def export_metrics(self, db=None, sub_key: Optional[str] = None):
        """Push the snapshot into the port's runtime PerfDB (serving
        history lands next to the op-time history)."""
        name = sub_key or getattr(self._fn, "__name__", "engine")
        return self.metrics.export(db=db, sub_key=name)

    # convenience for bucket-selection introspection/tests
    def bucket_for(self, n_requests: int) -> Optional[int]:
        return select_bucket(n_requests, self._enabled_buckets())
