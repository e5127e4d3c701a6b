"""Token data loading backed by the native C++ loader: the port of
easydist_tpu/runtime/data.py.

A flat binary token file (the llm.c / nanoGPT .bin convention: uint16 or
int32 tokens) is memory-mapped and sampled into [batch, seq+1] windows by
the prefetch thread of `native/csrc/dataloader.cpp`, so preparing the
next batch overlaps the card's step.  The native stream (std::mt19937_64
+ uniform_int_distribution from the seed) is the JAX package's native
stream, window for window.  Without a compiler the loader falls back to
numpy, which draws a different stream (`native` says which one runs).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Tuple

import numpy as np

from easydist_tpu_torch import native


class TokenLoader:
    """Random-window sampler over a flat binary token file."""

    def __init__(self, path: str, batch: int, seq: int,
                 token_bytes: int = 2, prefetch: int = 4, seed: int = 0):
        self.path = path
        self.batch = batch
        self.seq = seq
        self.window = seq + 1
        self.token_bytes = token_bytes
        self._handle = None
        self._np_tokens: Optional[np.ndarray] = None
        self._rng = np.random.default_rng(seed)
        self._lib = native.get_lib()
        if self._lib is not None:
            self._handle = self._lib.ed_loader_open(
                path.encode(), token_bytes, batch, self.window, prefetch,
                seed)
        if self._handle is None:
            dtype = np.uint16 if token_bytes == 2 else np.int32
            self._np_tokens = np.memmap(path, dtype=dtype, mode="r")
        # the data cursor: batches drawn so far.  The stream is
        # deterministic per seed, so (seed, batches_consumed) is the
        # iterator's position, which the elastic loop commits with the
        # state so a restart skips forward instead of drawing again
        self.batches_consumed = 0

    @property
    def native(self) -> bool:
        """True when the C++ loader serves the windows."""
        return self._handle is not None

    @property
    def n_tokens(self) -> int:
        if self._handle is not None:
            return int(self._lib.ed_loader_num_tokens(self._handle))
        return len(self._np_tokens)

    def next_batch(self) -> np.ndarray:
        """[batch, seq+1] int32 windows."""
        self.batches_consumed += 1
        if self._handle is not None:
            out = np.empty((self.batch, self.window), dtype=np.int32)
            self._lib.ed_loader_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return out
        starts = self._rng.integers(0, self.n_tokens - self.window,
                                    self.batch)
        return np.stack([self._np_tokens[s:s + self.window]
                         for s in starts]).astype(np.int32)

    def skip(self, n_batches: int) -> None:
        """Advance the stream by `n_batches` without returning data (the
        restart's positioning): the draws are replayed, so the stream stays
        the uninterrupted run's."""
        if n_batches <= 0:
            return
        if self._handle is not None:
            scratch = np.empty((self.batch, self.window), dtype=np.int32)
            ptr = scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            for _ in range(n_batches):
                self._lib.ed_loader_next(self._handle, ptr)
        else:
            for _ in range(n_batches):
                self._rng.integers(0, self.n_tokens - self.window,
                                   self.batch)
        self.batches_consumed += n_batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            w = self.next_batch()
            yield w[:, :-1], w[:, 1:]

    def close(self):
        if self._handle is not None:
            self._lib.ed_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
