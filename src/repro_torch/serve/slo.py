"""SLO monitoring: request-plane thresholding, distinct from GMM anomalies
(port of `repro/serve/slo.py`; only the imports differ).

Request latencies are workload-shaped — queue wait under load is not a
density anomaly, it is a *policy* violation — so ``Layer.REQUEST`` rows are
excluded from the GMM detectors entirely and judged here against declared
targets (`SLOSpec`, carried on the session's `MonitorSpec`). Each breach row
becomes a synthetic detection with

* ``flags[i]``  — value exceeded its target,
* ``scores[i]`` — ``-scale * (value/target - 1)`` so the incident engine's
  deficit (``log_delta - score`` with ``log_delta = 0``) encodes breach
  severity exactly as GMM deficits encode density shortfall,
* ``nodes[i]``  — the **tenant** id, so the engine's suspect-node machinery
  yields per-tenant attribution for free.

Breaches cluster through a dedicated `IncidentEngine` (never mixed with
anomaly flags) and close as incidents stamped ``kind="slo_breach"``. The
monitor also retains every observed row in a bounded history;
`evidence_for` slices it per incident for the request-plane diagnoser,
which is what keeps SLO diagnosis identical across batch and stream modes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.stream.incidents import Incident, IncidentEngine


def _check_fields(cls, d: Mapping) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} field(s): {sorted(unknown)}; "
            f"known: {sorted(known)}")


@dataclasses.dataclass
class SLOSpec:
    """Declared service-level objectives for the request plane.

    Latency targets are in engine-clock seconds (virtual seconds when the
    engine runs a `VirtualClock`); ``queue_depth`` is a count. A metric with
    a non-positive target is not judged.
    """

    ttft_s: float = 0.5           # enqueue -> first token
    tpot_s: float = 0.25          # mean inter-token time
    queue_wait_s: float = 1.0     # enqueue -> admission
    queue_depth: float = 64.0     # sampled backlog
    min_breaches: int = 6         # breach rows needed to close an incident
    gap_s: float = 0.5            # breach clustering gap
    close_after_s: float = 1.0    # quiet time before an incident closes
    breach_scale: float = 10.0    # deficit per unit of relative excess
    deficit_cap: float = 100.0    # per-row deficit cap

    @classmethod
    def from_dict(cls, d: Mapping) -> "SLOSpec":
        _check_fields(cls, d)
        return cls(**d)

    def targets(self) -> Dict[str, float]:
        """Row name -> threshold over that row's judged column."""
        return {
            "serve/queue_wait": self.queue_wait_s,
            "serve/ttft": self.ttft_s,
            "serve/tpot": self.tpot_s,
            # a stalling client inflates delivery beyond the per-token
            # budget; judged against the same target as TPOT
            "serve/client_stall": self.tpot_s,
            "serve/queue_depth": self.queue_depth,
        }


# rows judged on `size` (counts); everything else is judged on `dur`
_SIZE_METRICS = ("serve/queue_depth",)


@dataclasses.dataclass
class SLODetection:
    """WindowDetection-shaped container for SLO breach flags."""

    layer: Layer
    flags: np.ndarray    # (n,) bool
    scores: np.ndarray   # (n,) float, <= 0 where flagged
    log_delta: float     # always 0.0: deficit == -score
    steps: np.ndarray    # (n,) int
    ts: np.ndarray       # (n,) float
    nodes: np.ndarray    # (n,) int — tenant ids (-1 for queue samples)

    @property
    def anomaly_rate(self) -> float:
        return float(np.mean(self.flags)) if len(self.flags) else 0.0

    def anomalous_steps(self) -> np.ndarray:
        return np.unique(self.steps[self.flags & (self.steps >= 0)])


class SLOMonitor:
    """Threshold request rows against an `SLOSpec`; emit breach incidents."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.engine = IncidentEngine(
            gap_s=spec.gap_s, close_after_s=spec.close_after_s,
            min_flags=spec.min_breaches, deficit_cap=spec.deficit_cap)
        self.closed: List[Incident] = []
        self.breaches_total = 0
        self.rows_total = 0
        self._t_max = 0.0
        # bounded history of every judged row (breach or not): the
        # request-plane diagnoser reads this, independent of detector mode
        self._hist: List[tuple] = []  # (ts, name, value, ratio, size,
        #                                step, tenant, flagged)
        self._hist_cap = 16384
        # running reference prompt size (mean over every TTFT row, breach
        # or not): the diagnoser compares breaching prompts against this to
        # separate heavy-prompt skew from queue pressure
        self._size_sum = 0.0
        self._size_n = 0
        # running tenant mix (TTFT-row counts per tenant): the diagnoser
        # compares a breach cluster's tenant concentration against this —
        # the in-incident mix is contaminated by the fault itself
        self._tenant_counts: Dict[int, int] = {}

    def observe(self, rows: Optional[Dict[str, np.ndarray]]) -> int:
        """Judge one drained batch of request rows; returns breach count."""
        if rows is None or not len(rows.get("name", ())):
            return 0
        names = rows["name"]
        n = len(names)
        values = np.where(np.isin(names, _SIZE_METRICS),
                          rows["size"], rows["dur"])
        targets = np.array(
            [self.spec.targets().get(str(nm), 0.0) for nm in names])
        judged = targets > 0.0
        # single-token requests have no inter-token interval to judge
        judged &= ~((names == "serve/tpot") & (rows["dur"] <= 0.0))
        ratio = np.divide(values, targets, out=np.zeros(n),
                          where=targets > 0)
        flags = judged & (ratio > 1.0)
        scores = np.where(
            flags,
            -np.minimum(self.spec.breach_scale * (ratio - 1.0),
                        self.spec.deficit_cap),
            0.0)
        det = SLODetection(
            layer=Layer.REQUEST, flags=flags, scores=scores, log_delta=0.0,
            steps=rows["step"], ts=rows["ts"],
            nodes=rows["tenant"].astype(np.int32))
        self._t_max = max(self._t_max,
                          self.engine.ingest({Layer.REQUEST: det}))
        self.rows_total += int(judged.sum())
        self.breaches_total += int(flags.sum())
        ttft_rows = names == "serve/ttft"
        self._size_sum += float(rows["size"][ttft_rows].sum())
        self._size_n += int(ttft_rows.sum())
        for t in rows["tenant"][ttft_rows]:
            if t >= 0:
                self._tenant_counts[int(t)] = \
                    self._tenant_counts.get(int(t), 0) + 1
        for i in range(n):
            if not judged[i]:
                continue
            self._hist.append((
                float(rows["ts"][i]), str(names[i]), float(values[i]),
                float(ratio[i]), float(rows["size"][i]),
                int(rows["step"][i]), int(rows["tenant"][i]),
                bool(flags[i])))
        if len(self._hist) > self._hist_cap:
            del self._hist[:len(self._hist) - self._hist_cap]
        return int(flags.sum())

    def _stamp(self, closed: List[Incident]) -> List[Incident]:
        for inc in closed:
            inc.kind = "slo_breach"
        self.closed.extend(closed)
        return closed

    def tick(self, now: Optional[float] = None) -> List[Incident]:
        """Close breach clusters quiet for longer than ``close_after_s``."""
        return self._stamp(
            self.engine.finalise(self._t_max if now is None else now))

    def flush(self) -> List[Incident]:
        """Force-close everything pending (end of run)."""
        return self._stamp(self.engine.flush())

    def evidence_for(self, incident: Incident,
                     pad_s: float = 0.25) -> Dict[str, Any]:
        """Row history within the incident span, columnar, for diagnosis."""
        lo, hi = incident.t_start - pad_s, incident.t_end + pad_s
        rows = [r for r in self._hist if lo <= r[0] <= hi]
        return {
            "ts": np.array([r[0] for r in rows]),
            "name": np.array([r[1] for r in rows]),
            "value": np.array([r[2] for r in rows]),
            "ratio": np.array([r[3] for r in rows]),
            "size": np.array([r[4] for r in rows]),
            "step": np.array([r[5] for r in rows], dtype=np.int64),
            "tenant": np.array([r[6] for r in rows], dtype=np.int64),
            "flagged": np.array([r[7] for r in rows], dtype=bool),
            "ref_prompt_size": (self._size_sum / self._size_n
                                if self._size_n else 0.0),
            "ref_tenant_share": {
                t: c / max(sum(self._tenant_counts.values()), 1)
                for t, c in self._tenant_counts.items()},
        }
