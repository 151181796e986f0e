"""CUDA-runtime-layer probe: the uprobe-on-libcudart analogue (port of
`repro/core/probes/jax_probe.py`; registry name and layer ``xla``, so the
wire and the `Layer` codes stay those of the reference).

The reference listens on JAX's own runtime bus (`jax.monitoring`): the
runtime reports its compiles and dispatches with durations, from every
thread, and the probe drops what a detection sweep raised. Torch has no such
bus. This probe attaches, at runtime, hooks on the entry points through which
torch itself issues the CUDA runtime's launch and synchronisation calls, and
restores them on detach — the monitored code is never touched, as eBPF
uprobes on libcudart leave the application alone:

    torch.cuda.CUDAGraph.replay    -> cudaGraphLaunch
    torch.cuda.synchronize         -> cudaDeviceSynchronize
    torch.cuda.Stream.synchronize  -> cudaStreamSynchronize
    torch.cuda.Event.synchronize   -> cudaEventSynchronize

Each call made outside a detection zone emits one row named after the
runtime call, with the host time the call took — what a row of the
reference's layer measures (``jax.monitoring`` reports the host time of
the runtime's work). Calls made inside ``detect.guard.detection_zone()``
(the async detection plane's worker) are counted in ``dropped_in_zone``
and emit nothing, and the monitor's own calls (the step probe's wait for
the step, inside `unobserved`) are passed through unrecorded: the
reference's step probe waits with ``jax.block_until_ready``, which raises
no ``jax.monitoring`` event. So a graphed training step leaves the
reference's ``executable_run`` (the step probe's) and one
``cudaGraphLaunch`` row a step, and no device time: the graph's device
time is the card's, not a runtime call's (on the H100 its spread in a
fitted window, a MAD of 0.0009 in log duration, was a fifteenth of
``executable_run``'s).

While a monitored step is in flight (`hold` ... `release`, which the step
probe calls around the part of the step it times), the rows are queued and
written once the step's time is taken: writing a row can fault in a fresh
page of the event table, and a host stall there, inside the step, would
show as a slow step on every layer. The reference's runtime listeners run
during dispatch, not between the device's completion and the step's
timestamp.

The hooks are process-wide, like the reference's listeners: they are
installed when the first runtime probe attaches and removed when the last
one detaches, and every attached probe receives every call.

Why hooks and not the alternatives: torch.profiler/Kineto records the
runtime calls exactly (CUPTI), but a process has one Kineto session, whose
records arrive only when it stops, and CUPTI records every kernel node of a
replayed graph too (~1,800 a GPT-2 step), so continuous monitoring would
stop, parse and restart the session on the training thread and collide
with any other profiler in the process. ``torch.cuda._gpu_trace`` gives
synchronous callbacks, but no durations, and its activation cannot be
undone, so a detached probe would leave a hook behind on every allocation.
What the hooks do not see: the launches and copies that aten ops issue from
C++ (kernel launches of eager ops, the copies of ``.item()``).
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Callable, List, Tuple

import torch

from repro_torch.core.events import Layer
from repro_torch.core.probes.base import Probe
from repro_torch.detect.guard import in_detection_zone

GRAPH_LAUNCH = "cudaGraphLaunch"


def hook_targets() -> List[Tuple[object, str, str]]:
    """(owner, attribute, runtime call) of every hooked entry point."""
    return [(torch.cuda.CUDAGraph, "replay", GRAPH_LAUNCH),
            (torch.cuda, "synchronize", "cudaDeviceSynchronize"),
            (torch.cuda.Stream, "synchronize", "cudaStreamSynchronize"),
            (torch.cuda.Event, "synchronize", "cudaEventSynchronize")]


_LOCK = threading.Lock()
_ACTIVE: List["CudaRuntimeProbe"] = []  # attached probes, in attach order
_HELD = [0]  # monitored steps in flight (`hold` / `release`)
_OWN = threading.local()  # .depth: the thread is inside `unobserved`
# (owner, attribute, whether the owner defined it itself, its own value)
_SAVED: List[Tuple[object, str, bool, object]] = []


def hold() -> None:
    """A monitored step is in flight: queue every probe's rows."""
    _HELD[0] += 1


def release() -> None:
    """The step's time is taken: write the queued rows."""
    _HELD[0] = max(_HELD[0] - 1, 0)
    if not _HELD[0]:
        for p in list(_ACTIVE):
            p._flush()


@contextlib.contextmanager
def unobserved():
    """The block's runtime calls are the monitor's own, not the job's: the
    hooks pass them through and record nothing."""
    _OWN.depth = getattr(_OWN, "depth", 0) + 1
    try:
        yield
    finally:
        _OWN.depth -= 1


def _listeners() -> List["CudaRuntimeProbe"]:
    """The attached probes, or none inside a detection zone (counted) or
    inside `unobserved`."""
    probes = list(_ACTIVE)
    if not probes or getattr(_OWN, "depth", 0):
        return []
    if in_detection_zone():
        for p in probes:
            p.dropped_in_zone += 1
        return []
    return probes


def _hook(orig: Callable, call: str) -> Callable:
    @functools.wraps(orig)
    def hook(*args, **kwargs):
        probes = _listeners()
        if not probes:
            return orig(*args, **kwargs)
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        t1 = time.perf_counter()
        for p in probes:
            p._record(call, t0, t1)
        return out

    return hook


def _install() -> None:
    for owner, attr, call in hook_targets():
        own = attr in vars(owner)
        _SAVED.append((owner, attr, own, vars(owner).get(attr)))
        setattr(owner, attr, _hook(getattr(owner, attr), call))


def _uninstall() -> None:
    while _SAVED:
        owner, attr, own, value = _SAVED.pop()
        if own:
            setattr(owner, attr, value)
        else:
            delattr(owner, attr)


class CudaRuntimeProbe(Probe):
    name = "xla"

    def __init__(self):
        super().__init__()
        self.dropped_in_zone = 0  # calls seen inside a detection zone
        # calls recorded while a step is in flight: (call, t0, t1, thread)
        self._queued: List[Tuple[str, float, float, int]] = []

    def _attach(self) -> None:
        with _LOCK:
            if not _ACTIVE:
                _install()
            _ACTIVE.append(self)

    def _detach(self) -> None:
        self._flush()
        with _LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
            if not _ACTIVE:
                _uninstall()

    def _record(self, call: str, t0: float, t1: float) -> None:
        if _HELD[0]:
            self._queued.append((call, t0, t1, threading.get_ident()))
        else:
            self._write(call, t0, t1, threading.get_ident())

    def _write(self, call: str, t0: float, t1: float, tid: int) -> None:
        self.emit_rows(Layer.XLA, call, t0 - self._t0, dur=t1 - t0,
                       pid=os.getpid(), tid=tid)

    def _flush(self) -> None:
        """Write the queued rows."""
        queued, self._queued = self._queued, []
        for rec in queued:
            self._write(*rec)
