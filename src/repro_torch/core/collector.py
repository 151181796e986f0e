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
        # where the COLLECTIVE layer's schedule came from ("hlo" text or
        # the meshed "step"'s own record) and its length; None: no schedule
        self.collective_schedule: Optional[Dict[str, Any]] = None
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
        done = []
        try:
            for p in self.probes:
                p.attach(self.buffer, t0=self.t0)
                done.append(p)
        except BaseException:  # a probe that cannot attach: none stays on
            for p in reversed(done):
                p.detach()
            raise

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
        does. A torch step has no such artifact: a step built over a mesh
        (``fn.mesh``, set by `train.step.make_train_step`) has its schedule
        read off the collectives its meta record issues, and a step over a
        mesh that issues none (one rank) leaves the COLLECTIVE layer empty
        (``collective_schedule`` says so). A caller that models a sharded
        step passes HLO text itself."""
        step = self.step_probe
        step.flops_per_step = flops_per_step
        step.mem_gb_per_step = mem_gb
        if lowered is not None:
            try:
                hlo = lowered if isinstance(lowered, str) else \
                    lowered.as_text()
                self._by_name["collective"].register_compiled(hlo)
                self.collective_schedule = {
                    "source": "hlo",
                    "ops": len(self._by_name["collective"]._schedule)}
            except Exception as e:
                warnings.warn(
                    f"probe 'collective': register_compiled failed ({e!r}); "
                    "collective-layer events will be missing", RuntimeWarning,
                    stacklevel=2)
        meshed = (lowered is None and getattr(fn, "mesh", None) is not None
                  and "collective" in self._by_name)
        if sample_args is not None and ("operator" in self._by_name
                                        or meshed):
            # the record is the monitor's own work: the python probe's hook
            # would log it, and slows a deep model's record several-fold
            python = self._by_name.get("python")
            paused = python is not None and python.attached
            if paused:
                python.detach()
            try:
                self._record(fn, sample_args, meshed)
            finally:
                if paused:
                    python.attach(self.buffer, t0=self.t0)
        return step.wrap(fn)

    def _record(self, fn: Callable, sample_args: tuple,
                meshed: bool) -> None:
        """The operator probe's record of ``fn`` and, for a meshed step,
        the COLLECTIVE layer's schedule from the same record."""
        from repro_torch.core.probes.operator_probe import record_step

        op = self._by_name.get("operator")
        try:
            if op is not None:
                op.register_fn(fn, *sample_args)
                collectives = op.collectives
            else:
                collectives = record_step(fn, *sample_args)[1]
        except Exception as e:
            warnings.warn(
                f"probe 'operator': register_fn failed ({e!r}); "
                "operator-layer events will be missing", RuntimeWarning,
                stacklevel=3)
            return
        if meshed:
            self._by_name["collective"].register_schedule(collectives)
            self.collective_schedule = {"source": "step",
                                        "ops": len(collectives)}

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
