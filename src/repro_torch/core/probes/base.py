"""Probe contract: runtime attach/detach, zero user-code modification.

A probe is the eBPF-uprobe analogue: it observes an existing boundary of the
running process (profile hook, telemetry bus, compiled artifact, /proc) and
emits event *rows* into the collector's columnar `EventTable`. Probes MUST be
attachable and detachable at any time without the monitored code cooperating.

Emission is columnar-native: `emit_rows` hands whole row blocks (arrays or
scalars) to the sink in one locked block copy — no per-event Python objects
on the hot path. The scalar `emit(Event)` API remains as a thin adapter so
existing third-party probes keep working, and both APIs accept a legacy
`RingBuffer` sink (rows are materialised into `Event`s there).
"""
from __future__ import annotations

import abc
import time
from typing import Callable, Optional, Union

from repro_torch.core.events import Event, EventTable, Layer, RingBuffer

_NAN = float("nan")


class Probe(abc.ABC):
    name: str = "probe"

    def __init__(self):
        self._sink: Optional[Union[EventTable, RingBuffer]] = None
        self._attached = False
        self._t0 = 0.0
        self.emitted = 0
        self.current_step: Callable[[], int] = lambda: -1

    # -- lifecycle ----------------------------------------------------------
    def attach(self, sink: Union[EventTable, RingBuffer],
               t0: Optional[float] = None) -> None:
        if self._attached:
            return
        self._sink = sink
        self._t0 = time.perf_counter() if t0 is None else t0
        self._attach()
        self._attached = True

    def detach(self) -> None:
        if not self._attached:
            return
        self._detach()
        self._attached = False

    @property
    def attached(self) -> bool:
        return self._attached

    # -- implementation hooks -------------------------------------------------
    @abc.abstractmethod
    def _attach(self) -> None: ...

    @abc.abstractmethod
    def _detach(self) -> None: ...

    # -- emission -------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def emit_rows(self, layer: Layer, name, ts, dur=0.0, size=0.0, pid=0,
                  tid=0, step=None, util=_NAN, mem_gb=_NAN, power_w=_NAN,
                  temp_c=_NAN, meta="") -> int:
        """Emit a block of rows (arrays) or one row (scalars) for ``layer``.

        ``step=None`` stamps every row with the driver's current step. The
        native path is one `EventTable.append_rows` block copy; a legacy
        `RingBuffer` sink gets materialised `Event`s instead."""
        sink = self._sink
        if sink is None or not self._attached:
            return 0
        if step is None:
            step = self.current_step()
        append = getattr(sink, "append_rows", None)
        if append is not None:
            n = append(layer, name, ts, dur=dur, size=size, pid=pid, tid=tid,
                       step=step, util=util, mem_gb=mem_gb, power_w=power_w,
                       temp_c=temp_c, meta=meta)
            self.emitted += n
            return n
        return self._emit_rows_as_events(sink, layer, name, ts, dur, size,
                                         pid, tid, step, util, mem_gb,
                                         power_w, temp_c, meta)

    def _emit_rows_as_events(self, sink, layer, name, ts, dur, size, pid,
                             tid, step, util, mem_gb, power_w, temp_c,
                             meta) -> int:
        """RingBuffer compat: expand a row block into Event pushes."""
        import json as _json

        import numpy as np

        cols = [np.atleast_1d(np.asarray(v)) for v in
                (name, ts, dur, size, pid, tid, step)]
        tele = [np.atleast_1d(np.asarray(v, np.float64)) for v in
                (util, mem_gb, power_w, temp_c)]
        metas = np.atleast_1d(np.asarray(meta, dtype=object))
        # block length: set by the ARRAY arguments only (scalar defaults
        # became length-1 arrays above and broadcast); mirrors append_rows —
        # empty blocks emit nothing, mismatched lengths are an error
        n = None
        for v in (name, ts, dur, size, pid, tid, step, util, mem_gb,
                  power_w, temp_c, meta):
            if isinstance(v, np.ndarray) and v.ndim:
                if n is None:
                    n = int(v.shape[0])
                elif v.shape[0] != n and v.shape[0] != 1:
                    raise ValueError(
                        f"emit_rows column has length {v.shape[0]}, "
                        f"expected {n}")
        if n is None:
            n = 1
        if n == 0:
            return 0
        for i in range(n):
            pick = lambda a: a[i if a.shape[0] > 1 else 0]
            md = {k: float(pick(t)) for k, t in
                  zip(("util", "mem_gb", "power_w", "temp_c"), tele)
                  if not np.isnan(pick(t))}
            raw = str(pick(metas))
            if raw:
                md.update(_json.loads(raw))
            sink.push(Event(
                layer=layer, name=str(pick(cols[0])),
                ts=float(pick(cols[1])), dur=float(pick(cols[2])),
                size=float(pick(cols[3])), pid=int(pick(cols[4])),
                tid=int(pick(cols[5])), step=int(pick(cols[6])),
                meta=md or None))
        self.emitted += n
        return n

    def emit(self, ev: Event) -> None:
        """Scalar Event adapter (compat for third-party probes)."""
        if self._sink is not None and self._attached:
            if ev.step < 0:
                ev.step = self.current_step()
            self._sink.push(ev)
            self.emitted += 1
