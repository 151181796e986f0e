"""Backpressure governor: adaptive, stratified load shedding on the
agent -> group path (port of `repro/fleet/governor.py`; only the imports
differ).

At fleet scale an event storm (a pathological step, a chatty probe) can
outrun the aggregation tier. The ring buffer's answer — overwrite the oldest
events and count ``dropped`` — loses whole time ranges blindly. The governor
sheds load *before* encoding instead, under an AIMD budget driven by the
receiving group's window occupancy:

* **budget**: events admitted per flush. Multiplicative decrease when the
  group reports pressure >= ``high_water``; additive recovery toward the
  ceiling otherwise (classic AIMD, so colliding agents back off fast and
  recover fairly).
* **stratified sampling**: the admitted quota is split across LAYERS —
  every layer present keeps at least ``min_per_layer`` events (or all it
  has), the rest of the budget is shared proportionally. A storm in the
  operator layer can never starve step/device telemetry out of the stream.
* **even-stride selection** within a layer keeps the kept events spread
  across the flush interval (a uniform thinning, not a truncation), and is
  deterministic — the same flush sheds the same rows on every run.
* **accounting**: every shed event is counted per layer, stamped into the
  batch header (``shed``), and surfaced in ``eacgm_*`` self-metrics and
  `MonitorReport.collection_losses()` — shedding is never silent.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.events import LAYERS, Layer, select_columns


class BackpressureGovernor:
    """AIMD event budget + stratified per-layer sampler for one agent."""

    def __init__(self, max_events_per_flush: int, min_per_layer: int = 32,
                 high_water: float = 0.85, decrease: float = 0.5,
                 recover_fraction: float = 0.05):
        if max_events_per_flush < 1:
            raise ValueError("max_events_per_flush must be >= 1 (use no "
                             "governor at all to disable shedding)")
        self.max_budget = int(max_events_per_flush)
        self.budget = self.max_budget
        self.min_per_layer = int(min_per_layer)
        self.high_water = float(high_water)
        self.decrease = float(decrease)
        self.recover = max(1, int(round(recover_fraction * self.max_budget)))
        self.pressure = 0.0  # last occupancy signal from the group tier
        self.events_admitted = 0
        self.events_shed = 0
        self.shed_by_layer: Dict[str, int] = {}  # layer name -> cumulative

    # -- control loop ---------------------------------------------------------
    def feedback(self, pressure: float) -> None:
        """Group-tier occupancy signal in [0, 1]; adjusts the AIMD budget."""
        self.pressure = float(pressure)
        if self.pressure >= self.high_water:
            floor = max(1, self.min_per_layer)
            self.budget = max(floor, int(self.budget * self.decrease))
        else:
            self.budget = min(self.max_budget, self.budget + self.recover)

    # -- admission ------------------------------------------------------------
    def admit(self, cols: Dict[str, np.ndarray]
              ) -> Tuple[Dict[str, np.ndarray], Dict[int, int]]:
        """Apply the current budget to one flush's columns.

        Returns ``(admitted columns, {layer_code: events shed})``; the input
        dict is returned untouched when everything fits."""
        n = int(cols["ts"].shape[0])
        if n <= self.budget:
            self.events_admitted += n
            return cols, {}
        codes = np.asarray(cols["layer"], np.int8)
        present, counts = np.unique(codes, return_counts=True)
        quotas = self._quotas({int(c): int(k)
                               for c, k in zip(present, counts)})
        keep = np.zeros(n, dtype=bool)
        shed: Dict[int, int] = {}
        for code, quota in quotas.items():
            idx = np.flatnonzero(codes == np.int8(code))
            cnt = idx.shape[0]
            if quota >= cnt:
                keep[idx] = True
                continue
            # even-stride thinning: quota distinct picks spread over [0, cnt)
            picks = (np.arange(quota, dtype=np.int64) * cnt) // quota
            keep[idx[picks]] = True
            shed[code] = cnt - quota
            name = LAYERS[code].value
            self.shed_by_layer[name] = (self.shed_by_layer.get(name, 0)
                                        + cnt - quota)
        n_shed = int(sum(shed.values()))
        self.events_shed += n_shed
        self.events_admitted += n - n_shed
        if not n_shed:
            return cols, {}
        return select_columns(cols, keep), shed

    def _quotas(self, counts: Dict[int, int]) -> Dict[int, int]:
        """Split the budget across present layers: min_per_layer guaranteed
        (or all a layer has), remainder proportional to layer volume via
        largest remainder — integer quotas that sum to <= budget."""
        budget = self.budget
        guarantee = {c: min(k, self.min_per_layer)
                     for c, k in counts.items()}
        total_g = sum(guarantee.values())
        if total_g >= budget:
            # budget below the guarantees: split evenly, >= 1 per layer
            per = max(1, budget // len(counts))
            return {c: min(k, per) for c, k in counts.items()}
        quotas = dict(guarantee)
        spare = {c: counts[c] - quotas[c] for c in counts}
        total_spare = sum(spare.values())
        rest = budget - total_g
        if total_spare <= rest:  # everything fits after all
            return dict(counts)
        shares = {c: rest * spare[c] / total_spare for c in counts}
        floors = {c: int(shares[c]) for c in counts}
        leftover = rest - sum(floors.values())
        for c in sorted(counts, key=lambda c: shares[c] - floors[c],
                        reverse=True):
            if leftover <= 0:
                break
            if floors[c] < spare[c]:
                floors[c] += 1
                leftover -= 1
        return {c: quotas[c] + floors[c] for c in counts}

    def stats(self) -> Dict[str, object]:
        return {"budget": self.budget, "max_budget": self.max_budget,
                "pressure": self.pressure,
                "events_admitted": self.events_admitted,
                "events_shed": self.events_shed,
                "shed_by_layer": dict(self.shed_by_layer)}
