"""Request probe: bridges the continuous-batching engine into the monitor
(port of `repro/serve/probe.py`; only the imports differ).

The engine knows nothing about monitoring — it publishes plain per-request
records and per-step queue samples onto a module-level bus. Any attached
`RequestProbe` turns them into columnar ``Layer.REQUEST`` rows (the same
emit path every other probe uses) and additionally retains a bounded row
buffer for the SLO monitor, so SLO thresholding and request-plane diagnosis
work identically in batch and stream modes (no dependency on detector
windows).

Row shape (one block of rows per finished request):

==================== ======================= ====== ===== ======
name                 ts                      dur    size  util
==================== ======================= ====== ===== ======
``serve/queue_wait`` finish time of request  wait_s  P
``serve/ttft``       finish time of request  ttft_s  P
``serve/tpot``       finish time of request  tpot_s  N
``serve/e2e``        finish time of request  e2e_s   P+N
``serve/client_stall`` finish time (if >0)   stall_s N
``serve/queue_depth`` sample time            0      depth  occ%
==================== ======================= ====== ===== ======

All rows of one request share its *finish* timestamp: the incident engine
dedups rows behind a per-node watermark, and finish times are monotone in
publication order while e.g. enqueue times are not. ``pid`` carries the
request id and ``tid`` the tenant id (SLO detections use the tenant as the
node axis, which is what makes per-tenant incident attribution fall out of
the existing suspect-node machinery).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.probes.base import Probe

# ---------------------------------------------------------------------------
# publish bus: engines publish, attached probes subscribe

_LOCK = threading.Lock()
_SUBS: List["RequestProbe"] = []


def publish(kind: str, payload: Dict[str, float]) -> None:
    """Deliver an engine record to every attached request probe.

    ``kind`` is ``"request"`` (a finished request's lifecycle record) or
    ``"sample"`` (a per-step queue-depth/occupancy sample). No-op when no
    probe is attached, so the engine runs unmonitored at zero cost.
    """
    with _LOCK:
        subs = list(_SUBS)
    for p in subs:
        p.on_record(kind, payload)


REQUEST_ROW_NAMES = (
    "serve/queue_wait", "serve/ttft", "serve/tpot", "serve/e2e",
    "serve/client_stall", "serve/queue_depth",
)


class RequestProbe(Probe):
    """Non-intrusive request-plane probe (``Layer.REQUEST`` rows).

    ``sample_every`` thins queue-depth samples (every step would dominate the
    row stream at high step rates); per-request rows are never thinned.
    """

    name = "request"

    def __init__(self, sample_every: int = 4, slo_buffer: int = 8192):
        super().__init__()
        self.sample_every = max(1, int(sample_every))
        self._slo_buffer = int(slo_buffer)
        self._lock = threading.Lock()
        # serve rows are stamped on the *engine's* clock, which may be a
        # VirtualClock starting at 0 rather than the collector's wall clock;
        # the first record anchors a dedicated base so row timestamps are
        # non-negative and monotone on either clock
        self._serve_base: Optional[float] = None
        self._slo_rows: List[tuple] = []  # (name, ts, dur, size, step, tid, pid)
        self._n_samples = 0
        # running aggregates surfaced via stats() -> obs self-metrics
        self.requests_total = 0
        self.tokens_total = 0
        self.queue_wait_sum = 0.0
        self.ttft_sum = 0.0
        self.tpot_sum = 0.0
        self.stall_total = 0.0
        self.last_queue_depth = 0.0
        self.last_occupancy = 0.0

    def _attach(self) -> None:
        with _LOCK:
            if self not in _SUBS:
                _SUBS.append(self)

    def _detach(self) -> None:
        with _LOCK:
            if self in _SUBS:
                _SUBS.remove(self)

    # -- record ingestion ---------------------------------------------------

    def on_record(self, kind: str, rec: Dict[str, float]) -> None:
        if kind == "request":
            self._on_request(rec)
        elif kind == "sample":
            self._on_sample(rec)

    def _rel(self, t: float) -> float:
        if self._serve_base is None:
            self._serve_base = float(t)
        return float(t) - self._serve_base

    def _on_request(self, rec: Dict[str, float]) -> None:
        ts = self._rel(rec["finish_ts"])
        step = int(rec.get("step", -1))
        rid, tid = int(rec["req_id"]), int(rec["tenant"])
        plen, nout = float(rec["prompt_len"]), float(rec["tokens_out"])
        rows = [
            ("serve/queue_wait", float(rec["queue_wait"]), plen),
            ("serve/ttft", float(rec["ttft"]), plen),
            ("serve/tpot", float(rec["tpot"]), nout),
            ("serve/e2e", float(rec["e2e"]), plen + nout),
        ]
        stall = float(rec.get("stall_s", 0.0))
        if stall > 0.0:
            rows.append(("serve/client_stall", stall, nout))
        names = np.array([r[0] for r in rows])
        durs = np.array([r[1] for r in rows])
        sizes = np.array([r[2] for r in rows])
        n = len(rows)
        self.emit_rows(Layer.REQUEST, names, ts=np.full(n, ts), dur=durs,
                       size=sizes, pid=np.full(n, rid, dtype=np.int64),
                       tid=np.full(n, tid, dtype=np.int64),
                       step=np.full(n, step, dtype=np.int64))
        with self._lock:
            for nm, d, sz in rows:
                self._slo_rows.append((nm, ts, d, sz, step, tid, rid))
            if len(self._slo_rows) > self._slo_buffer:
                del self._slo_rows[:len(self._slo_rows) - self._slo_buffer]
            self.requests_total += 1
            self.tokens_total += int(nout)
            self.queue_wait_sum += float(rec["queue_wait"])
            self.ttft_sum += float(rec["ttft"])
            self.tpot_sum += float(rec["tpot"])
            self.stall_total += stall

    def _on_sample(self, rec: Dict[str, float]) -> None:
        depth = float(rec.get("depth", 0.0))
        occ = float(rec.get("occupancy", 0.0))
        step = int(rec.get("step", -1))
        ts = self._rel(rec["ts"])
        with self._lock:
            self.last_queue_depth = depth
            self.last_occupancy = occ
            self._n_samples += 1
            emit = self._n_samples % self.sample_every == 0
            if emit:
                self._slo_rows.append(
                    ("serve/queue_depth", ts, 0.0, depth, step, -1, -1))
                if len(self._slo_rows) > self._slo_buffer:
                    del self._slo_rows[:len(self._slo_rows) - self._slo_buffer]
        if emit:
            self.emit_rows(Layer.REQUEST, "serve/queue_depth", ts=ts,
                           size=depth, tid=-1, step=step, util=occ * 100.0)

    # -- SLO/diagnosis surface ----------------------------------------------

    def drain_slo_rows(self) -> Optional[Dict[str, np.ndarray]]:
        """Take all buffered rows as a columnar dict (None when empty)."""
        with self._lock:
            rows, self._slo_rows = self._slo_rows, []
        if not rows:
            return None
        return {
            "name": np.array([r[0] for r in rows]),
            "ts": np.array([r[1] for r in rows], dtype=np.float64),
            "dur": np.array([r[2] for r in rows], dtype=np.float64),
            "size": np.array([r[3] for r in rows], dtype=np.float64),
            "step": np.array([r[4] for r in rows], dtype=np.int64),
            "tenant": np.array([r[5] for r in rows], dtype=np.int64),
            "req_id": np.array([r[6] for r in rows], dtype=np.int64),
        }

    def stats(self) -> Dict[str, float]:
        """Running request-plane aggregates for the obs self-metrics."""
        with self._lock:
            n = max(self.requests_total, 1)
            return {
                "requests_total": float(self.requests_total),
                "tokens_total": float(self.tokens_total),
                "queue_wait_mean_s": self.queue_wait_sum / n,
                "ttft_mean_s": self.ttft_sum / n,
                "tpot_mean_s": self.tpot_sum / n,
                "client_stall_total_s": self.stall_total,
                "queue_depth": self.last_queue_depth,
                "occupancy": self.last_occupancy,
            }
