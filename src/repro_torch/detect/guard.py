"""Thread-local detection-zone guard (port of `repro/detect/guard.py`).

Background detection sweeps run torch work (EM iterations, the GMM kernels)
on the executor's worker thread. The runtime probe (`CudaRuntimeProbe`)
hooks torch's CUDA runtime entry points for the whole process, so without a
guard those sweeps would show up in the very event stream they analyse — a
feedback loop where each sweep manufactures runtime-layer "anomalies" for
the next one.

The Python probe needs no guard (``sys.setprofile`` is per-thread and is
never installed on the worker), but the runtime hooks check
``in_detection_zone()`` and drop calls made inside a sweep.

The zone is a depth counter (re-entrant) in thread-local storage, so the
step thread's own synchronous sweeps — already bracketed by the session's
``_detection_pause`` — compose with it without interference.
"""
from __future__ import annotations

import contextlib
import threading

_local = threading.local()


def in_detection_zone() -> bool:
    """True iff the *current thread* is inside a detection sweep."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def detection_zone():
    """Mark the current thread as running detection work (re-entrant)."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1
