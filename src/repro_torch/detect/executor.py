"""Background detection executor: sweeps off the step thread (port of
`repro/detect/executor.py`).

One daemon worker drains a per-key queue of detection tasks (closures built
over *snapshots* — never live, mutating window state). Results come back via
``drain()`` at the caller's next cadence point, with submit/start/finish
timestamps so the session can account for staleness explicitly instead of
pretending detection was instantaneous.

Design points:

- **Per-key coalescing.** Keys name logical detection streams ("batch",
  "stream"). If a task for a key is still queued (not started) when another
  arrives, the queued one is *replaced* — running every stale sweep would
  only add lag, the newest snapshot supersedes it. Coalesced counts are
  reported so the operator can see backpressure.
- **Sequential per worker.** A single worker thread means tasks for the same
  key never overlap, so detector state mutated inside a task (warm-started
  GMM params, thresholds) needs no locking of its own.
- **Inline mode.** ``mode="inline"`` executes at submit() on the calling
  thread. Combined with submit-then-drain ordering at each cadence point,
  inline publishes the same step it swept — byte-identical to the old
  synchronous path. This is the determinism anchor the parity tests lock in.
- **Errors are data.** A task that raises produces a SweepResult with
  ``error`` set; the worker never dies. Callers decide whether to re-raise.

Worker tasks run inside ``guard.detection_zone()`` so the process-wide
runtime-probe hooks drop the calls the sweep itself makes.

Streams (new in the port): given a CUDA ``stream``, every task runs on it,
and the worker waits for it before publishing the result. The training
thread's stream then never queues behind a sweep's kernels, and a sweep's
host reads wait only for its own kernels, not for the training step queued
before them. The step probe waits on the training stream alone, so a sweep
in flight does not stretch the measured step either. The session runs its
synchronous detection work on the same stream (`on_stream`), so every
tensor of the detector is allocated, used and freed on one stream, and the
caching allocator never hands a block still read by one stream to another.
The session gives a stream to the thread executor only: an inline sweep
runs on the training thread between steps anyway, and work on a second
stream moves the job's later graph replays between two levels (`Session`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.detect.guard import detection_zone


@dataclasses.dataclass
class SweepResult:
    """One completed (or failed) detection task."""

    key: str
    seq: int  # monotonically increasing per executor
    step: int  # caller-supplied cadence marker (step index / tick count)
    submitted_ts: float
    started_ts: float
    finished_ts: float
    value: Any = None
    error: Optional[BaseException] = None

    @property
    def wall_s(self) -> float:
        return self.finished_ts - self.started_ts

    @property
    def lag_s(self) -> float:
        """Queue + compute latency: submit to finish."""
        return self.finished_ts - self.submitted_ts


@dataclasses.dataclass
class _Task:
    key: str
    seq: int
    step: int
    fn: Callable[[], Any]
    submitted_ts: float


class DetectionExecutor:
    """Single-worker async detection plane with per-key coalescing.

    ``mode``: "thread" (default — background daemon worker) or "inline"
    (execute at submit on the calling thread; deterministic, used by tests
    and by callers that want the old synchronous behaviour). ``stream``: a
    ``torch.cuda.Stream`` every task runs on (None: the calling thread's
    current stream).
    """

    def __init__(self, mode: str = "thread", name: str = "eacgm-detect",
                 stream=None):
        if mode not in ("thread", "inline"):
            raise ValueError(f"unknown executor mode: {mode!r}")
        self.mode = mode
        self.stream = stream
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._queue: Dict[str, _Task] = {}  # pending, not yet started
        self._done: List[SweepResult] = []
        self._seq = 0
        self._active_key: Optional[str] = None
        self._closed = False
        # counters (read under lock)
        self._submitted = 0
        self._completed = 0
        self._coalesced = 0
        self._errors = 0
        self._busy_seconds = 0.0
        self._worker: Optional[threading.Thread] = None
        if mode == "thread":
            self._worker = threading.Thread(target=self._run, name=name,
                                            daemon=True)
            self._worker.start()

    # -- submission / collection ------------------------------------------

    def submit(self, key: str, fn: Callable[[], Any], *, step: int = 0) -> int:
        """Enqueue a sweep; returns its seq. Coalesces onto a queued task
        for the same key (the newer snapshot supersedes the older)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("executor is closed")
            self._seq += 1
            self._submitted += 1
            task = _Task(key, self._seq, step, fn, time.monotonic())
            if self.mode == "thread":
                if key in self._queue:
                    self._coalesced += 1
                self._queue[key] = task
                self._wakeup.notify()
                return task.seq
        # inline: run now, on the caller's thread (nothing ever queues)
        self._execute(task)
        return task.seq

    def drain(self) -> List[SweepResult]:
        """Collect every completed sweep since the last drain (FIFO)."""
        with self._lock:
            done, self._done = self._done, []
        return done

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and no task is running.
        Returns False on timeout (results so far still drainable)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._queue or self._active_key is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._wakeup.wait(min(remaining, 0.05))
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Flush, then stop the worker. Idempotent."""
        self.flush(timeout)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wakeup.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=timeout)

    # -- introspection ----------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "mode": self.mode,
                "submitted": self._submitted,
                "completed": self._completed,
                "coalesced": self._coalesced,
                "errors": self._errors,
                "queue_depth": len(self._queue)
                + (1 if self._active_key is not None else 0),
                "busy_seconds": self._busy_seconds,
            }

    # -- worker -----------------------------------------------------------

    def _execute(self, task: _Task) -> None:
        started = time.monotonic()
        value, error = None, None
        try:
            with detection_zone(), self.on_stream():
                value = task.fn()
        except BaseException as exc:  # noqa: BLE001 — errors are data here
            error = exc
        finished = time.monotonic()
        result = SweepResult(task.key, task.seq, task.step, task.submitted_ts,
                             started, finished, value, error)
        with self._lock:
            self._done.append(result)
            self._completed += 1
            self._busy_seconds += finished - started
            if error is not None:
                self._errors += 1

    @contextlib.contextmanager
    def on_stream(self):
        """Run the block on the executor's stream (if it has one) and wait
        for the stream at its end."""
        if self.stream is None:
            yield
            return
        import torch

        with torch.cuda.stream(self.stream):
            yield
        self.stream.synchronize()  # the result is complete when published

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._wakeup.wait(0.1)
                if self._closed and not self._queue:
                    return
                # oldest-submitted first across keys
                key = min(self._queue, key=lambda k: self._queue[k].seq)
                task = self._queue.pop(key)
                self._active_key = key
            try:
                self._execute(task)
            finally:
                with self._lock:
                    self._active_key = None
                    self._wakeup.notify_all()
