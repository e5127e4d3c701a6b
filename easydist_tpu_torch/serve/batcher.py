"""Bucket selection (the part of easydist_tpu/serve/batcher.py the
generation session uses)."""

from typing import Optional, Sequence


def select_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    fitting = [b for b in buckets if b >= n]
    return min(fitting) if fitting else None
