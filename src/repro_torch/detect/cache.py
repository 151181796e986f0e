"""Shape bucketing + bucket accounting for the detection plane (port of
`repro/detect/cache.py`).

In the JAX package, jit/Pallas executables are keyed by concrete shapes: a
streaming detector sees a different window length every sweep, so it pads
the row count to a power-of-two bucket and passes the true row count as a
*traced* ``nvalid`` argument, and one executable serves every window size
in the bucket.

The port's CUDA kernels take N and ``nvalid`` at run time, so nothing
compiles per shape here. The bucketing is kept all the same, so that the
port launches the kernels on the reference's shapes (the padding rows are
masked by ``nvalid``) and `ShapeBucketCache` counts the same hits and
misses per (bucket, D, K) signature; a miss here costs no compile.

The reference's ``enable_persistent_cache`` (JAX's on-disk compilation
cache) has no counterpart: there is nothing to cache across processes
beyond the kernels' build in ``build/kernels/``.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np

MIN_BUCKET = 256


def bucket_rows(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Next power-of-two row count >= max(n, min_bucket)."""
    b = max(int(min_bucket), 1)
    n = int(n)
    while b < n:
        b <<= 1
    return b


def pad_to_bucket(X: np.ndarray, min_bucket: int = MIN_BUCKET
                  ) -> Tuple[np.ndarray, int]:
    """Zero-pad X's rows to its bucket; returns (padded, true row count).

    Padding rows are masked out inside the kernels via ``nvalid``, so they
    contribute nothing — they only stabilise the compiled shape."""
    n = int(X.shape[0])
    b = bucket_rows(n, min_bucket)
    if b == n:
        return X, n
    pad = np.zeros((b - n,) + X.shape[1:], dtype=X.dtype)
    return np.concatenate([X, pad], axis=0), n


class ShapeBucketCache:
    """Tracks which shape signatures the detection plane has launched on.
    Record one signature per kernel call site; the first sighting is a miss
    (in the JAX package, an XLA compile on that sweep), repeats are hits."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seen: Dict[Tuple, int] = {}
        self._hits = 0
        self._misses = 0

    def record(self, *signature) -> bool:
        """Record a call with this shape signature; True if seen before."""
        with self._lock:
            if signature in self._seen:
                self._seen[signature] += 1
                self._hits += 1
                return True
            self._seen[signature] = 1
            self._misses += 1
            return False

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "shapes": len(self._seen)}


# Process-wide instance: every detector shares one accounting surface.
SHAPE_CACHE = ShapeBucketCache()
