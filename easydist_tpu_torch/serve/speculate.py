"""Speculative decoding: drafters + the greedy accept rule (port of
easydist_tpu/serve/speculate.py).

The serving loop (serve/generation.py) pays one full target-model forward
per emitted token — single-stream latency is bounded by sequential
decode.  Speculative decoding breaks the bound without touching the
output: a cheap drafter proposes k tokens, ONE batched target-model
verify step (`models/*.py::*_verify_step*`) scores all k+1 positions in a
fixed-shape program, and the session commits the longest prefix the
target model itself would have produced.  The accept rule is
self-validating under greedy decoding — position i's verify logits equal
what sequential decode would produce whenever positions < i carry the
true sequence, so every committed token is exactly the plain-greedy
token REGARDLESS of where the drafts came from.  Drafters therefore only
affect speed (acceptance rate), never output; `speculate_k=0` and any
drafter produce identical streams.

Two built-in drafters:

  * `NGramDrafter` — zero-cost self-speculative prompt lookup: find the
    most recent earlier occurrence of the sequence's own trailing n-gram
    and propose the tokens that followed it.  Free (no model, no device
    work), surprisingly strong on repetitive text (code, templated
    prose, retrieval-augmented prompts that quote their context).
  * `SmallModelDrafter` — a second, smaller model's cached greedy decode
    kept in sync with each request's committed sequence by
    teacher-forced steps (every feed is one batch-1 decode step: on the
    card, one launch of the decode kernel B4 per layer).  Proposals are a pure function of the
    committed token prefix (greedy draft model), so a crash-resumed
    request re-drafts identically — fleet recovery stays bitwise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from easydist_tpu_torch import resolve_device

__all__ = ["NGramDrafter", "SmallModelDrafter", "accept_length"]


def accept_length(draft: Sequence[int], target: Sequence[int]) -> int:
    """Number of draft tokens accepted: the length of the longest prefix
    where draft[i] == target[i].  The round commits target[0..n]
    INCLUSIVE (n = the returned count) — the first n committed tokens
    ratify accepted drafts, the (n+1)-th is the target model's own
    correction (or bonus token on full acceptance), so every round emits
    at least one token and never advances past the first mismatch
    (the JAX package's analyze rule SERVE003 audits exactly this)."""
    n = 0
    for d, t in zip(draft, target):
        if int(d) != int(t):
            break
        n += 1
    return n


class NGramDrafter:
    """Prompt-lookup drafting over the request's own emitted+prompt ids.

    `propose` looks up the most recent PRIOR occurrence of the
    sequence's trailing n-gram (longest n first, `max_ngram` down to
    `min_ngram`) that has k following tokens, and proposes those tokens
    (falling back to a truncated tail match only when no occurrence is
    k deep).  Proposals are a pure function of the token sequence — the
    per-request n-gram position index is only an accelerator and is
    rebuilt whenever the sequence is not an extension of what was
    indexed, so a crash-resumed request (prompt' = prompt + accepted
    ids) re-drafts identically.  `propose` runs on the host inside
    every scheduling round, so its cost rides the decode critical path:
    the index makes it O(new tokens) per call instead of a full
    right-to-left rescan."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram}, max_ngram={max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # request_id -> (indexed ids copy, {ngram tuple: [positions]})
        self._index: Dict[int, tuple] = {}

    def _positions(self, request_id: int, ids: List[int]):
        """The request's n-gram position index, extended (or rebuilt on
        a prefix mismatch) to cover `ids`."""
        st = self._index.get(request_id)
        if st is not None:
            seen, idx = st
            if len(seen) > len(ids) or seen != ids[:len(seen)]:
                st = None
        if st is None:
            seen, idx = [], {}
            self._index[request_id] = (seen, idx)
        n_ids = len(ids)
        for n in range(self.min_ngram, self.max_ngram + 1):
            for i in range(max(0, len(seen) - n + 1), n_ids - n + 1):
                idx.setdefault(tuple(ids[i:i + n]), []).append(i)
        seen.extend(ids[len(seen):])
        return idx

    def propose(self, request_id: int, ids: Sequence[int],
                k: int) -> Optional[List[int]]:
        """Up to `k` proposed continuation tokens for the sequence
        `ids`, or None when no trailing n-gram recurs."""
        ids = list(ids)
        n_ids = len(ids)
        index = self._positions(request_id, ids)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if n_ids < n + 1:
                continue
            occ = index.get(tuple(ids[n_ids - n:]))
            if not occ:
                continue
            # most recent prior occurrence WITH k continuation tokens:
            # on cyclic text the most recent match always sits near the
            # tail, where the continuation is truncated by the end of
            # the sequence — an earlier full-depth match proposes k
            # tokens where the tail match proposes one or two.  The
            # truncated most-recent match is kept as a fallback when no
            # occurrence has k following tokens.
            fallback = None
            for i in reversed(occ):
                if i == n_ids - n:
                    continue  # the trailing n-gram itself
                cont = ids[i + n:i + n + k]
                if len(cont) == k:
                    return cont
                if cont and fallback is None:
                    fallback = cont
            if fallback is not None:
                return fallback
        return None

    def forget(self, request_id: int) -> None:
        """Drop the request's position index (proposals are a pure
        function of the sequence; this only frees the accelerator)."""
        self._index.pop(request_id, None)


class SmallModelDrafter:
    """Draft-model drafting: a second cached greedy forward (the same
    `model_decode(params, cache, token, pos) -> (cache, logits)` contract
    `GenerationSession` uses, batch=1) teacher-forced along each
    request's committed sequence.

    Per round: roll the per-request cursor back to the longest common
    prefix of what was fed and what is now committed (stale cache rows
    past the cursor are masked by the position-based attention and
    overwritten on re-feed — the same rewind rule the target cache
    uses), feed the newly committed tokens, then autoregressively
    propose k draft tokens.  With acceptance rate a, sync costs ~1-2
    teacher-forced steps per round.  ONE compiled signature total (the
    batch=1 cache shape is fixed).  Each request holds its own batch-1
    cache (layers x 2 x heads x max_len x head_dim elements) until
    `forget`, which the session calls on retire and on evacuate.

    `device` is where the feeds' token tensors go (default: the card);
    `params` and the caches `init_cache` builds must live there."""

    def __init__(self, params, *, model_decode: Callable,
                 init_cache: Callable, max_len: int, device=None):
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        self._init_cache = init_cache
        self._states: Dict[int, dict] = {}
        self.feeds = 0

        def _step(cache, params, token, pos):
            cache, logits = model_decode(params, cache, token, pos)
            return cache, torch.argmax(logits, dim=-1).to(torch.int32)

        self._step_def = _step
        self._step_c = None

    def _step_compiled(self):
        if self._step_c is None:
            from easydist_tpu_torch.fxfront import easydist_compile

            self._step_c = easydist_compile(self._step_def)
        return self._step_c

    def _feed(self, st: dict, token: int, pos: int) -> int:
        st["cache"], nxt = self._step_compiled()(
            st["cache"], self.params,
            torch.tensor([token], dtype=torch.int32, device=self.device),
            torch.tensor([pos], dtype=torch.int32, device=self.device))
        self.feeds += 1
        return int(nxt[0])

    def propose(self, request_id: int, ids: Sequence[int],
                k: int) -> Optional[List[int]]:
        ids = [int(t) for t in ids]
        st = self._states.get(request_id)
        if st is None:
            st = {"cache": self._init_cache(1, self.max_len), "fed": []}
            self._states[request_id] = st
        fed = st["fed"]
        common = 0
        for a, b in zip(fed, ids):
            if a != b:
                break
            common += 1
        seq = list(ids)
        nxt = None
        for pos in range(common, len(seq)):        # teacher-forced sync
            if pos >= self.max_len:
                st["fed"] = seq[:self.max_len]
                return None
            nxt = self._feed(st, seq[pos], pos)
        if nxt is None:                            # nothing new to feed:
            if not seq:                            # re-derive from cache
                return None
            pos = len(seq) - 1
            nxt = self._feed(st, seq[pos], pos)
        proposals = [nxt]
        while len(proposals) < k and len(seq) + len(proposals) < self.max_len:
            seqpos = len(seq) + len(proposals) - 1
            nxt = self._feed(st, proposals[-1], seqpos)
            proposals.append(nxt)
        st["fed"] = seq + proposals[:-1]
        return proposals

    def forget(self, request_id: int) -> None:
        self._states.pop(request_id, None)

    @property
    def n_states(self) -> int:
        """Requests holding a draft cache right now."""
        return len(self._states)

    def cache_stats(self) -> Dict[str, int]:
        """{size, hits, misses} of the draft step's signature cache."""
        return ({"size": 0, "hits": 0, "misses": 0} if self._step_c is None
                else self._step_c.cache_stats())
