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
runtime call, with the host time the call took. A graph launch is also
timed on the device: CUDA events are recorded around it on the caller's
stream, and once a later hooked synchronisation has returned and the end
event is complete, a ``graph_exec`` row carries the graph's device time.
Calls made inside ``detect.guard.detection_zone()`` (the async detection
plane's worker) are counted in ``dropped_in_zone`` and emit nothing.

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
GRAPH_EXEC = "graph_exec"


def hook_targets() -> List[Tuple[object, str, str]]:
    """(owner, attribute, runtime call) of every hooked entry point."""
    return [(torch.cuda.CUDAGraph, "replay", GRAPH_LAUNCH),
            (torch.cuda, "synchronize", "cudaDeviceSynchronize"),
            (torch.cuda.Stream, "synchronize", "cudaStreamSynchronize"),
            (torch.cuda.Event, "synchronize", "cudaEventSynchronize")]


_LOCK = threading.Lock()
_ACTIVE: List["CudaRuntimeProbe"] = []  # attached probes, in attach order
# (owner, attribute, whether the owner defined it itself, its own value)
_SAVED: List[Tuple[object, str, bool, object]] = []


def _listeners() -> List["CudaRuntimeProbe"]:
    """The attached probes, or none inside a detection zone (counted)."""
    probes = list(_ACTIVE)
    if probes and in_detection_zone():
        for p in probes:
            p.dropped_in_zone += 1
        return []
    return probes


def _sync_hook(orig: Callable, call: str) -> Callable:
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
            p._resolve_graphs()
        return out

    return hook


def _graph_hook(orig: Callable, call: str) -> Callable:
    @functools.wraps(orig)
    def hook(graph, *args, **kwargs):
        probes = _listeners()
        if not probes:
            return orig(graph, *args, **kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = orig(graph, *args, **kwargs)
        t1 = time.perf_counter()
        end.record()
        for p in probes:
            p._record(call, t0, t1)
            p._pending.append((t0, start, end))
        return out

    return hook


def _install() -> None:
    for owner, attr, call in hook_targets():
        own = attr in vars(owner)
        _SAVED.append((owner, attr, own, vars(owner).get(attr)))
        make = _graph_hook if call == GRAPH_LAUNCH else _sync_hook
        setattr(owner, attr, make(getattr(owner, attr), call))


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
        # graph launches whose device time is not read yet: (host ts of the
        # launch, start event, end event)
        self._pending: List[Tuple[float, object, object]] = []

    def _attach(self) -> None:
        with _LOCK:
            if not _ACTIVE:
                _install()
            _ACTIVE.append(self)

    def _detach(self) -> None:
        self._resolve_graphs()
        with _LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
            if not _ACTIVE:
                _uninstall()
        self._pending = []

    def _record(self, call: str, t0: float, t1: float) -> None:
        self.emit_rows(Layer.XLA, call, t0 - self._t0, dur=t1 - t0,
                       pid=os.getpid(), tid=threading.get_ident())

    def _resolve_graphs(self) -> None:
        """Emit the device time of every graph launch that has finished."""
        while self._pending and self._pending[0][2].query():
            t0, start, end = self._pending.pop(0)
            self.emit_rows(Layer.XLA, GRAPH_EXEC, t0 - self._t0,
                           dur=start.elapsed_time(end) / 1e3,
                           pid=os.getpid())
