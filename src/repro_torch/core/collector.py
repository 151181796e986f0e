"""Collector: owns the columnar event table and the probe suite; the eACGM
daemon (port of `repro/core/collector.py`).

Usage (the model/training code is never modified — the launcher simply asks
the collector to observe the step callable it already has):

    col = Collector.standard()
    with col.monitoring():
        step_fn = col.observe_step_fn(step_fn, sample_args=(state, batch))
        for batch in data:
            state, metrics = step_fn(state, batch)
    cols = col.drain_columns()

Probes emit row blocks straight into the `EventTable`; `drain_columns` /
`snapshot_columns` hand the same columns to the feature builder. The
Event-list `drain()`/`snapshot()` remain as compat shims that materialise
objects on demand (export, legacy tooling) — never on the monitoring hot
path.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.events import Event, EventTable, export_perfetto
from repro_torch.core.probes import Probe
from repro_torch.core.probes.device_probe import H100_POWER_LIMIT_W


class Collector:
    def __init__(self, probes: List[Probe], capacity: int = 1_000_000):
        self.buffer = EventTable(capacity)
        self.probes = probes
        self.t0 = time.perf_counter()
        self._by_name = {p.name: p for p in probes}
        step = self._by_name.get("step")
        if step is not None:
            for p in probes:
                p.current_step = lambda s=step: s.step_count

    # -- construction ---------------------------------------------------------
    @staticmethod
    def standard(python_sampling: int = 1, device_interval: float = 0.25,
                 n_devices: int = 1, capacity: int = 1_000_000,
                 with_python: bool = True,
                 python_include=("repro_torch", "torch"),
                 peak_w: float = H100_POWER_LIMIT_W) -> "Collector":
        """Deprecated shim: the standard suite now comes from the session
        probe registry (`repro_torch.session.registry`); prefer building a
        `repro_torch.session.Session` from a `MonitorSpec`. ``peak_w`` is
        the power limit the simulated card telemetry peaks at."""
        # late import: the session package imports this module
        from repro_torch.session.registry import build_probes

        names = (["python"] if with_python else []) + \
            ["xla", "operator", "collective", "device", "step"]
        options = {
            "python": {"include": python_include,
                       "sample_every": python_sampling},
            "device": {"interval": device_interval, "n_devices": n_devices,
                       "peak_w": peak_w},
        }
        return Collector(build_probes(names, options), capacity)

    def __getitem__(self, name: str) -> Probe:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(
                f"no probe named {name!r} in this collector; "
                f"available: {sorted(self._by_name)}") from None

    @property
    def step_probe(self) -> Probe:
        return self["step"]

    # -- lifecycle ------------------------------------------------------------
    def attach(self) -> None:
        for p in self.probes:
            p.attach(self.buffer, t0=self.t0)

    def detach(self) -> None:
        for p in reversed(self.probes):
            p.detach()

    @contextlib.contextmanager
    def monitoring(self):
        self.attach()
        try:
            yield self
        finally:
            self.detach()

    # -- observation hooks ------------------------------------------------------
    def observe_step_fn(self, fn: Callable, *, lowered=None,
                        sample_args: Optional[tuple] = None,
                        flops_per_step: float = 0.0,
                        mem_gb: float = 0.0) -> Callable:
        """Wrap a built step callable and read its operator stream off one
        meta-tensor run on ``sample_args``. Non-intrusive: operates only on
        objects the launcher already holds, and leaves them unchanged.

        ``lowered`` is a collective schedule in HLO text, or anything whose
        ``as_text()`` gives one (the reference passes a lowered JAX step):
        the collective probe reads its schedule off it, as the reference's
        does. A one-card torch step has no such artifact; a caller that
        models a sharded step passes the text itself."""
        step = self.step_probe
        step.flops_per_step = flops_per_step
        step.mem_gb_per_step = mem_gb
        if lowered is not None:
            try:
                hlo = lowered if isinstance(lowered, str) else \
                    lowered.as_text()
                self._by_name["collective"].register_compiled(hlo)
            except Exception as e:
                warnings.warn(
                    f"probe 'collective': register_compiled failed ({e!r}); "
                    "collective-layer events will be missing", RuntimeWarning,
                    stacklevel=2)
        if sample_args is not None and "operator" in self._by_name:
            # the record is the monitor's own work: the python probe's hook
            # would log it, and slows a deep model's record several-fold
            python = self._by_name.get("python")
            paused = python is not None and python.attached
            if paused:
                python.detach()
            try:
                self._by_name["operator"].register_fn(fn, *sample_args)
            except Exception as e:
                warnings.warn(
                    f"probe 'operator': register_fn failed ({e!r}); "
                    "operator-layer events will be missing", RuntimeWarning,
                    stacklevel=2)
            finally:
                if paused:
                    python.attach(self.buffer, t0=self.t0)
        return step.wrap(fn)

    # -- data -----------------------------------------------------------------
    def drain_columns(self) -> Dict[str, np.ndarray]:
        """Remove and return all rows as a ColumnView (the native path)."""
        return self.buffer.drain_columns()

    def snapshot_columns(self) -> Dict[str, np.ndarray]:
        return self.buffer.snapshot_columns()

    def drain(self) -> List[Event]:
        """Compat shim: drain and materialise `Event` objects."""
        return self.buffer.drain()

    def snapshot(self) -> List[Event]:
        return self.buffer.snapshot()

    def export_trace(self, path: str) -> str:
        return export_perfetto(self.snapshot(), path)

    def overhead_stats(self) -> Dict[str, Any]:
        return {
            "events": len(self.buffer),
            "events_total": self.buffer.pushed,
            "dropped": self.buffer.dropped,
            "names_truncated": self.buffer.names_truncated,
            "emitted_per_probe": {p.name: p.emitted for p in self.probes},
        }
