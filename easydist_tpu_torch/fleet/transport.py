"""KV-page transport for prefill/decode disaggregation and drain
migration (port of easydist_tpu/fleet/transport.py).

The unit of transfer is the prefix trie's committed page: one aligned
`prefill_chunk`-token window of K/V, a tensor of [layers, (kv_)heads,
chunk, head_dim] per key (serve/prefix_cache.py; a paged session
materializes its arena page into the same form, an int8 arena's scale
planes ride along).  A transfer ships a root-to-leaf chunk *path* —
pages are only meaningful with every ancestor present (causal
attention: a page's K/V depends on all tokens before it).

Every transfer carries a **manifest** in the checkpoint MANIFEST.json
idiom: per-page sha256 over the token ids and the raw K/V bytes, so the
receiver verifies integrity before committing — a corrupt page restored
into a live trie poisons every future request sharing that prefix,
bitwise-silently.  The digest hashes numpy's dtype name and shape text
and the tensor's raw bytes (`view(torch.uint8)`: numpy has no bfloat16),
so a page's digest, and a manifest's key, equal the JAX package's on the
same data.  Hashing is the only host copy a transfer makes.

`InProcessTransport` moves device tensors by reference (same process,
same device) and still builds + verifies the manifest — the serialized
format is the contract a network transport implements later; the
in-process one proves it round-trips.

Hardening (`send_pages`): a single `transfer()` is one verify-then-commit
attempt; `send_pages` wraps it with a deadline and jittered exponential
backoff, classifies only transport faults as retryable
(`TransportStallError` — the attempt hung; `PageCorruptError` — the
payload failed manifest verification BEFORE any commit), and relies on
idempotent manifest-keyed commits so an attempt retried after a
late/duplicated delivery never double-commits.  The abort-on-partial
property is structural: verification covers page count and every
digest, and runs before the first page touches the trie — a
half-arrived prefix can never enter it.  Fault points
`fleet.transport.stall` / `fleet.transport.page_corrupt` inject both
failure shapes deterministically.  The corrupt attempt flips the lowest
bit of the first byte of a COPY of one in-flight page (the JAX package
adds 1e-3 to its first value, which a bfloat16 value of magnitude 0.5 or
more rounds away, leaving the bytes as they were), so every dtype is
really damaged and the retry resends pristine bytes.
"""

from __future__ import annotations

import hashlib
import logging
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from easydist_tpu_torch.analyze import check_page_handoff
from easydist_tpu_torch.resilience import faultinject

logger = logging.getLogger(__name__)

MANIFEST_FORMAT = 1

Page = Tuple[Tuple[int, ...], Dict[str, object]]  # (chunk_tokens, {"k","v"})


class TransportError(RuntimeError):
    """Base for transfer failures a router can act on (retry/fallback)."""


class TransportStallError(TransportError):
    """One transfer attempt hung past its budget — transient, retryable."""


class PageCorruptError(TransportError):
    """Manifest verification failed: the payload was damaged in flight.
    Raised BEFORE anything commits (abort-on-partial); retryable because
    the source still holds pristine pages."""


def path_nbytes(path: Sequence[Page]) -> int:
    """Payload bytes of one chunk path (K/V tensors only; token ids are
    noise at page granularity).  `.nbytes` is metadata — sizing a path
    never forces a host copy."""
    return sum(int(t.nbytes) for _tokens, kv in path for t in kv.values())


def manifest_key(manifest: Dict[str, object]) -> str:
    """Stable identity of one transfer's CONTENT: sha256 over the ordered
    page digests.  Two attempts shipping the same pages share a key, so
    the receiver can make commits idempotent under retry."""
    h = hashlib.sha256()
    for entry in manifest.get("pages", []):
        h.update(str(entry.get("sha256")).encode())
    return h.hexdigest()


def _corrupt_in_flight(path: Sequence[Page]) -> List[Page]:
    """Copy the path and flip the lowest bit of the first byte of the
    last page's first tensor (in key order) — the deterministic stand-in
    for damage on the wire.  The caller's tensors are untouched (a retry
    resends pristine bytes)."""
    damaged = [(tokens, dict(kv)) for tokens, kv in path]
    _tokens, kv = damaged[-1]
    name = sorted(kv)[0]
    copy = kv[name].contiguous().clone()
    raw = copy.view(-1).view(torch.uint8)
    raw[0] ^= 1
    kv[name] = copy
    return damaged


def _numpy_dtype_name(t: torch.Tensor) -> str:
    """numpy's name for a tensor's dtype (`float32`, `bfloat16`, `int8`)
    — the text the JAX package's digest hashes."""
    return str(t.dtype).replace("torch.", "")


def _page_digest(tokens: Sequence[int], kv: Dict[str, object]) -> Tuple[str, int]:
    """sha256 over the page identity AND payload: token ids, then each
    tensor's dtype/shape/raw bytes in key order — any bit flip anywhere in
    the page changes the digest.  Key order covers every arena leaf, so
    quantized pages' scale planes (`k_scale`/`v_scale`) enter the digest
    alongside the int8 payloads — a scale/payload desync across the wire
    fails verification exactly like a flipped payload bit."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(int(t).to_bytes(8, "big", signed=True))
    nbytes = 0
    for name in sorted(kv):
        t = kv[name]
        h.update(name.encode())
        h.update(_numpy_dtype_name(t).encode())
        h.update(str(tuple(t.shape)).encode())
        buf = t.detach().contiguous().view(-1).view(torch.uint8).cpu() \
            .numpy().tobytes()
        h.update(buf)
        nbytes += len(buf)
    return h.hexdigest(), nbytes


def page_manifest(path: Sequence[Page], src: str = "?",
                  dst: str = "?") -> Dict[str, object]:
    """Serializable description of one chunk-path transfer (JSON-safe:
    token ids + digests, never array payloads)."""
    pages = []
    for idx, (tokens, kv) in enumerate(path):
        digest, nbytes = _page_digest(tokens, kv)
        pages.append({"index": idx, "tokens": [int(t) for t in tokens],
                      "sha256": digest, "bytes": nbytes})
    return {"format": MANIFEST_FORMAT, "src": src, "dst": dst,
            "pages": pages}


def verify_manifest(manifest: Dict[str, object],
                    path: Sequence[Page]) -> List[str]:
    """Recompute every page digest against the manifest; returns problem
    strings (empty = intact).  The FLEET002 audit wraps this."""
    problems: List[str] = []
    entries = manifest.get("pages", [])
    if manifest.get("format") != MANIFEST_FORMAT:
        problems.append(f"manifest format {manifest.get('format')!r} != "
                        f"{MANIFEST_FORMAT}")
    if len(entries) != len(path):
        problems.append(f"manifest lists {len(entries)} pages, transfer "
                        f"carries {len(path)}")
    for entry, (tokens, kv) in zip(entries, path):
        want_tokens = [int(t) for t in entry.get("tokens", [])]
        if want_tokens != [int(t) for t in tokens]:
            problems.append(f"page {entry.get('index')}: token ids differ "
                            f"from manifest")
            continue
        digest, nbytes = _page_digest(tokens, kv)
        if digest != entry.get("sha256"):
            problems.append(
                f"page {entry.get('index')}: sha256 mismatch (manifest "
                f"{str(entry.get('sha256'))[:12]}.., payload "
                f"{digest[:12]}..)")
        elif nbytes != entry.get("bytes"):
            problems.append(f"page {entry.get('index')}: {nbytes} payload "
                            f"bytes != manifest {entry.get('bytes')}")
    return problems


class KVTransport:
    """Moves one committed chunk path between replicas.  Implementations
    must build a manifest at the source and verify it at the destination
    before committing anything, and keep commits idempotent under the
    manifest key (send_pages retries on transient failures)."""

    def transfer(self, path: Sequence[Page], dst_session, prompt,
                 src: str = "?", dst: str = "?",
                 bucket: Optional[int] = None) -> int:
        raise NotImplementedError

    def send_pages(self, path: Sequence[Page], dst_session, prompt=None,
                   *, bucket: Optional[int] = None,
                   src: str = "?", dst: str = "?",
                   deadline_s: Optional[float] = None, retries: int = 2,
                   backoff_s: float = 0.005, jitter: float = 0.25,
                   clock=time.monotonic, sleep=time.sleep,
                   rng=random.random) -> int:
        """`transfer` with a deadline and jittered-backoff retry (the
        checkpoint `_retry_io` idiom).  Only transport faults retry —
        a stalled attempt (`TransportStallError`, injectable via
        `fleet.transport.stall`) or a payload that failed verification
        (`PageCorruptError`); logic errors propagate immediately, and a
        retry that would start past the deadline raises the last error
        instead of sleeping through it.  Commit with `prompt` (trie path
        for that prompt's bucket) or `bucket` (drain-migration hot
        pages)."""
        deadline_t = None if deadline_s is None else clock() + deadline_s
        attempt = 0
        while True:
            try:
                if faultinject.fire("fleet.transport.stall"):
                    raise TransportStallError(
                        f"injected transfer stall ({src}->{dst}, "
                        f"attempt {attempt + 1})")
                return self.transfer(path, dst_session, prompt,
                                     src=src, dst=dst, bucket=bucket)
            except (TransportStallError, PageCorruptError) as e:
                attempt += 1
                if attempt > retries:
                    raise
                delay = backoff_s * (2 ** (attempt - 1)) \
                    * (1.0 + jitter * rng())
                if deadline_t is not None and clock() + delay >= deadline_t:
                    logger.warning(
                        "page transfer %s->%s: deadline exhausted after "
                        "%d attempt(s): %s", src, dst, attempt, e)
                    raise
                logger.warning(
                    "page transfer %s->%s attempt %d failed (%s); "
                    "retrying in %.1fms", src, dst, attempt, e,
                    delay * 1e3)
                sleep(delay)

    def send_paths_chunked(self, paths: Sequence[Sequence[Page]],
                           dst_session, *, bucket: Optional[int] = None,
                           max_wave_bytes: Optional[int] = None,
                           on_drop=None, src: str = "?", dst: str = "?",
                           **send_kw) -> Dict[str, int]:
        """Migrate many chunk paths in byte-bounded WAVES.

        Drain migration ships a draining replica's whole hot working set;
        unbatched, its in-flight bytes scale with trie warmth.  This
        reuses the reshard planner's wave batcher (`reshard.chunk_waves`
        — the same greedy prefix grouping that bounds redistribution
        chunks) to cap the bytes entering `send_pages` per wave at
        `max_wave_bytes` (falls back to `edconfig.reshard_chunk_bytes`;
        a single path over the cap ships alone — paths are indivisible,
        ancestors must land with descendants).

        Per-path semantics are unchanged: each path still goes through
        `send_pages` (manifest verify, retry, idempotent commit), and a
        path that fails permanently is reported via `on_drop(i, error)`
        and skipped — best-effort drain, never half-committed.  Returns
        {"chunks", "paths_sent", "paths_dropped", "waves", "bytes"}.
        """
        from easydist_tpu_torch.reshard import chunk_waves

        paths = list(paths)
        if max_wave_bytes is None:
            from easydist_tpu_torch import config as edconfig

            max_wave_bytes = edconfig.reshard_chunk_bytes
        sizes = [path_nbytes(p) for p in paths]
        out = {"chunks": 0, "paths_sent": 0, "paths_dropped": 0,
               "waves": 0, "bytes": 0}
        for lo, hi in chunk_waves(sizes, max_wave_bytes):
            out["waves"] += 1
            for i in range(lo, hi):
                try:
                    out["chunks"] += self.send_pages(
                        paths[i], dst_session, None, bucket=bucket,
                        src=src, dst=dst, **send_kw)
                    out["paths_sent"] += 1
                    out["bytes"] += sizes[i]
                except TransportError as e:
                    out["paths_dropped"] += 1
                    if on_drop is not None:
                        on_drop(i, e)
                    else:
                        logger.warning(
                            "chunked migration %s->%s dropped path %d: "
                            "%s", src, dst, i, e)
        return out


class InProcessTransport(KVTransport):
    """Same-process transfer: pages move by reference (they stay on their
    device), the manifest still
    round-trips (and is kept in `manifests` for audit/tests).  Commits
    are idempotent per (destination, commit target, manifest key): a
    retried/duplicated delivery of the same pages returns the first
    commit's result without touching the trie again."""

    def __init__(self, verify: bool = True, keep: int = 32,
                 keep_commits: int = 256):
        self.verify = verify
        self.keep = keep
        self.keep_commits = keep_commits
        self.manifests: List[Dict[str, object]] = []
        self.pages_moved = 0
        self.commits_deduped = 0
        self._committed: Dict[tuple, int] = {}
        # layer-12 conformance surface: committed/deduped/rejected per
        # manifest key, replayed through the TransportSpec's idempotence
        # relation by `replay_transport_commits` (PROTO003)
        self.events: List[Dict[str, object]] = []
        self._event_cap = 512

    def _event(self, event: str, key: tuple, src: str, dst: str) -> None:
        # the whole idempotence key, destination included: a drain
        # migrates one hot path to every survivor, and those are distinct
        # commits (the JAX package's stream drops the destination, so its
        # replay reads them as one key committed twice)
        self.events.append({"event": event, "key": key,
                            "src": src, "dst": dst})
        del self.events[:-self._event_cap]

    def transitions(self) -> List[Dict[str, object]]:
        """The commit event stream, oldest first — the surface
        `replay_transport_commits` (PROTO003) validates against the
        TransportSpec."""
        return list(self.events)

    def transfer(self, path: Sequence[Page], dst_session, prompt,
                 src: str = "?", dst: str = "?",
                 bucket: Optional[int] = None) -> int:
        """One verify-then-commit attempt: commit `path` into
        `dst_session`'s trie for `prompt`'s decode bucket (or as hot
        pages under `bucket` when prompt is None); returns chunks present
        after import.  Verification failure raises `PageCorruptError`
        BEFORE anything commits.

        The idempotence lookup runs FIRST: a duplicate delivery of
        already-committed content (the manifest key is computed over the
        pristine source pages) is a pure no-op — it must not re-append
        to the audit trail, burn a fault-plan occurrence, or re-run
        verification (a duplicate damaged in flight after a successful
        commit would otherwise turn a no-op into a spurious
        PageCorruptError).  This is the commit-boundary idempotence the
        TransportSpec model-checks."""
        if not path:
            return 0
        manifest = page_manifest(path, src=src, dst=dst)
        target = (tuple(int(t) for t in prompt) if prompt is not None
                  else ("bucket", bucket))
        key = (id(dst_session), target, manifest_key(manifest))
        if key in self._committed:
            self.commits_deduped += 1
            self._event("deduped", key, src, dst)
            return self._committed[key]
        self.manifests = (self.manifests + [manifest])[-self.keep:]
        if faultinject.fire("fleet.transport.page_corrupt"):
            # damage on the wire: manifest was built over pristine pages,
            # the payload mutates after — verification must catch it
            path = _corrupt_in_flight(path)
        if self.verify:
            try:
                self._check(manifest, path)
            except Exception as e:
                self._event("rejected", key, src, dst)
                raise PageCorruptError(
                    f"KV page handoff corrupt; aborted before commit "
                    f"({src}->{dst}): {e}") from e
        if prompt is not None:
            n = dst_session.import_prefix_path(prompt, path)
        else:
            n = dst_session.import_hot_pages({bucket: [path]})
        self.pages_moved += len(path)
        self._committed[key] = n
        self._event("committed", key, src, dst)
        while len(self._committed) > self.keep_commits:
            self._committed.pop(next(iter(self._committed)))
        return n

    def _check(self, manifest, path) -> None:
        # FLEET002 audit trail; raises AnalysisError under
        # config.analyze_raise (the caller turns it into PageCorruptError)
        check_page_handoff(manifest, path,
                           node=f"handoff[{manifest['src']}->"
                                f"{manifest['dst']}]")
        # commits abort on damage even with analyze_raise off
        problems = verify_manifest(manifest, path)
        if problems:
            raise RuntimeError(f"KV page handoff corrupt: {problems}")
