"""Detection-quality metrics: per-layer event flags -> per-step scores
(port of `repro/eval/metrics.py`: NumPy arithmetic, the same numbers).

The detectors flag *events*; chaos labels *steps*. The bridge is a per-layer
majority vote: a layer votes a step anomalous when at least ``vote`` of its
events at that step are flagged (always at least one event). A step is
predicted anomalous when any layer votes for it. The vote is what keeps the
false-alarm floor near the per-event contamination rate instead of its union
across every event at the step — see docs/evaluation.md#step-predictions.

All metrics are computed over the evaluation region ``[eval_start, n_steps)``
only: earlier steps are the detector's clean reference window (stream warmup
/ batch holdoff), where detection is not armed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.governor import policy_for


def step_predictions(detections: Dict[Layer, object], n_steps: int,
                     vote: float = 0.5) -> Dict[str, np.ndarray]:
    """Per-layer boolean step predictions (+ their union under "any").

    ``detections`` maps layers to DetectionResult / WindowDetection — both
    carry per-event ``flags`` and ``steps``. Events with unknown steps
    (step < 0) are ignored.
    """
    out: Dict[str, np.ndarray] = {"any": np.zeros(n_steps, dtype=bool)}
    for layer, det in detections.items():
        steps = np.asarray(det.steps)
        ok = (steps >= 0) & (steps < n_steps)
        steps = steps[ok].astype(np.int64)
        flags = np.asarray(det.flags)[ok]
        total = np.bincount(steps, minlength=n_steps)
        flagged = np.bincount(steps, weights=flags.astype(np.float64),
                              minlength=n_steps)
        need = np.maximum(np.ceil(total * vote), 1.0)
        pred = (total > 0) & (flagged >= need)
        out[layer.value] = pred
        out["any"] |= pred
    return out


def debounce(pred: np.ndarray, min_run: int = 2) -> np.ndarray:
    """Suppress predicted runs shorter than ``min_run`` consecutive steps.

    Injected faults are multi-step bursts; an isolated single-step flag is
    almost always a calibration false positive (probability ~p per layer per
    step), and requiring persistence drops the false-alarm floor from ~p to
    ~p^min_run while costing at most ``min_run - 1`` steps of detection lag.
    """
    if min_run <= 1 or not pred.any():
        return pred
    pred = np.asarray(pred, dtype=bool)
    out = np.zeros_like(pred)
    edges = np.flatnonzero(np.diff(np.concatenate(([0], pred.view(np.int8),
                                                   [0]))))
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi - lo >= min_run:
            out[lo:hi] = True
    return out


def first_flag_ts(detections: Dict[Layer, object]) -> Optional[float]:
    """Earliest flagged-event timestamp across layers (None without ts)."""
    firsts = []
    for det in detections.values():
        ts = getattr(det, "ts", None)
        flags = np.asarray(det.flags)
        if ts is not None and flags.any():
            firsts.append(float(np.asarray(ts)[flags].min()))
    return min(firsts) if firsts else None


@dataclasses.dataclass
class DetectionMetrics:
    """One scenario run's scores against the chaos labels."""

    precision: float
    recall: float
    f1: float
    false_alarm_rate: float  # flagged fraction of the clean eval steps
    ttd_steps: Optional[float]  # mean steps from fault start to first hit
    ttd_s: Optional[float]  # same in seconds (needs step timestamps)
    faults_total: int
    faults_detected: int
    eval_steps: int  # steps scored (eval region size)
    anomalous_steps: int  # labelled-anomalous steps in the eval region

    @property
    def fault_recall(self) -> float:
        """Window-level recall: detected fault windows / all windows."""
        return (self.faults_detected / self.faults_total
                if self.faults_total else 1.0)

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["fault_recall"] = self.fault_recall
        return d


def detection_metrics(pred: np.ndarray, labels: np.ndarray,
                      windows: Sequence[Tuple[int, int]],
                      eval_start: int = 0,
                      grace_steps: int = 0,
                      step_ts: Optional[np.ndarray] = None
                      ) -> DetectionMetrics:
    """Score per-step predictions against per-step labels + fault windows.

    * precision / recall / F1: step-level, over ``[eval_start, n)``.
    * false-alarm rate: predicted fraction of the *clean* steps in the eval
      region — for a clean-control run (no faults) this is the headline
      number, and the one CI holds below the documented ceiling.
    * time-to-detect: per merged fault window ``[lo, hi)``, the first
      predicted step in ``[lo, hi + grace_steps)``; TTD = that step - lo,
      averaged over detected windows. ``grace_steps`` covers detection
      cadence lag (a stream flush interval). With ``step_ts`` (per-step
      wall timestamps) the same quantity is also reported in seconds.
    """
    pred = np.asarray(pred, dtype=bool)
    labels = np.asarray(labels, dtype=bool)
    n = len(labels)
    region = np.zeros(n, dtype=bool)
    region[eval_start:] = True
    p, y = pred[region], labels[region]
    tp = int((p & y).sum())
    fp = int((p & ~y).sum())
    fn = int((~p & y).sum())
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    clean = int((~y).sum())
    far = fp / clean if clean else 0.0

    ttds: List[int] = []
    ttds_s: List[float] = []
    detected = 0
    windows = sorted(w for w in windows if w[0] >= eval_start)
    for i, (lo, hi) in enumerate(windows):
        # grace never reaches into the NEXT window: detecting fault i+1
        # must not credit fault i
        cap = min(hi + grace_steps, n,
                  windows[i + 1][0] if i + 1 < len(windows) else n)
        hits = np.flatnonzero(pred[lo:cap])
        if len(hits) == 0:
            continue
        detected += 1
        ttds.append(int(hits[0]))
        if step_ts is not None:
            first = lo + int(hits[0])
            if first < len(step_ts) and lo < len(step_ts):
                ttds_s.append(float(step_ts[first] - step_ts[lo]))
    return DetectionMetrics(
        precision=float(precision), recall=float(recall), f1=float(f1),
        false_alarm_rate=float(far),
        ttd_steps=float(np.mean(ttds)) if ttds else None,
        ttd_s=float(np.mean(ttds_s)) if ttds_s else None,
        faults_total=len(windows), faults_detected=detected,
        eval_steps=int(region.sum()), anomalous_steps=int(y.sum()))


# ---------------------------------------------------------------------------
# SLO-breach scoring (request-plane incidents vs serve fault windows)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SLOBreachMetrics:
    """SLO-breach incidents scored against serve-path fault windows.

    Only incidents stamped ``kind == "slo_breach"`` count — the request
    plane is thresholded, not density-modelled, so its quality question is
    different from detection: did each serve fault window raise a breach
    incident (recall), and did the *clean* control raise none
    (``incidents_total == 0`` when ``windows_total == 0``)?
    """

    incidents_total: int
    windows_total: int
    windows_detected: int
    spurious: int  # breach incidents overlapping no fault window

    @property
    def recall(self) -> float:
        return (self.windows_detected / self.windows_total
                if self.windows_total else 1.0)

    @property
    def clean(self) -> bool:
        """True when a fault-free run stayed breach-free (vacuously True
        for faulted runs — their score is recall/spurious)."""
        return self.windows_total > 0 or self.incidents_total == 0

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d.update(recall=self.recall, clean=self.clean)
        return d


def slo_breach_metrics(incidents: Sequence, windows: Sequence[Tuple[int, int]],
                       grace_steps: int = 0) -> SLOBreachMetrics:
    """Score a report's SLO-breach incidents against fault step windows.

    Breach rows lag their cause — a flooded request breaches when it
    *finishes*, which can be a full queue-drain after the burst window ends
    — so serve scoring uses a larger ``grace_steps`` than detection scoring.
    """
    from repro_torch.stream.incidents import match_incidents

    breaches = [i for i in incidents
                if getattr(i, "kind", "anomaly") == "slo_breach"]
    m = match_incidents(breaches, windows, grace_steps=grace_steps)
    return SLOBreachMetrics(
        incidents_total=len(breaches), windows_total=len(windows),
        windows_detected=m.windows_detected, spurious=len(m.spurious))


# ---------------------------------------------------------------------------
# diagnosis scoring (blamed kind / nodes / action vs the injected labels)
# ---------------------------------------------------------------------------

def window_kinds(faults: Sequence) -> List[Tuple[Tuple[int, int], Set[str]]]:
    """Merged ``[lo, hi)`` fault windows with the set of injected kinds
    active in each — the ground truth a diagnosis is scored against.
    ``faults`` is a `Fault` sequence (``FaultInjector.faults``)."""
    spans = sorted(((f.start_step, f.end_step, f.kind) for f in faults))
    merged: List[Tuple[Tuple[int, int], Set[str]]] = []
    for lo, hi, kind in spans:
        if merged and lo <= merged[-1][0][1]:
            (mlo, mhi), kinds = merged[-1]
            merged[-1] = ((mlo, max(mhi, hi)), kinds | {kind})
        else:
            merged.append(((lo, hi), {kind}))
    return merged


@dataclasses.dataclass
class DiagnosisMetrics:
    """Diagnosis quality for one scenario run.

    Accuracies are over *emitted* diagnoses: a spurious diagnosis (no
    overlapping fault window) counts as wrong on every axis, and a faulted
    run that produced no diagnoses at all scores 0 (undetected is
    undiagnosed). A clean run with no diagnoses scores None (vacuous).
    """

    diagnoses_total: int
    matched: int  # diagnoses overlapping >= 1 fault window
    spurious: int
    kind_correct: int  # blamed kind in the overlapped windows' kinds
    node_correct: int  # blamed nodes intersect the faulted nodes
    action_correct: int  # recommended action matches the true kind's policy
    windows_total: int
    windows_diagnosed: int  # fault windows overlapped by >= 1 diagnosis

    def _rate(self, num: int) -> Optional[float]:
        if self.diagnoses_total:
            return num / self.diagnoses_total
        return None if self.windows_total == 0 else 0.0

    @property
    def kind_accuracy(self) -> Optional[float]:
        return self._rate(self.kind_correct)

    @property
    def node_accuracy(self) -> Optional[float]:
        return self._rate(self.node_correct)

    @property
    def action_match_rate(self) -> Optional[float]:
        return self._rate(self.action_correct)

    @property
    def coverage(self) -> Optional[float]:
        return (self.windows_diagnosed / self.windows_total
                if self.windows_total else None)

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d.update(kind_accuracy=self.kind_accuracy,
                 node_accuracy=self.node_accuracy,
                 action_match_rate=self.action_match_rate,
                 coverage=self.coverage)
        return d


def diagnosis_metrics(diagnoses: Sequence, faults: Sequence,
                      grace_steps: int = 0,
                      fault_nodes: Sequence[int] = (0,),
                      step_clock: Optional[Tuple[np.ndarray, np.ndarray]]
                      = None) -> DiagnosisMetrics:
    """Score `repro_torch.diagnosis.Diagnosis` records against the injected
    schedule. A diagnosis matches window ``[lo, hi)`` when any of its steps
    lands in ``[lo, hi + grace_steps)`` (same overlap rule as
    `match_incidents`); its blamed kind is correct when it names any kind
    injected in a matched window, its action when it matches the policy of
    any such kind, its nodes when they intersect ``fault_nodes`` (the nodes
    the chaos schedule perturbed).

    ``step_clock`` is an optional ``(step_ids, ts)`` pair on the collector
    clock (e.g. the step layer's detection steps/ts): device-layer
    telemetry carries no step ids, so a device-only diagnosis has no steps
    of its own and is matched by mapping its ``[t_start, t_end]`` span onto
    the steps that ran concurrently."""
    windows = window_kinds(faults)
    fault_nodes = set(int(n) for n in fault_nodes)
    matched = spurious = kind_ok = node_ok = action_ok = 0
    hit_windows: Set[int] = set()
    for d in diagnoses:
        steps = set(d.steps)
        if not steps and step_clock is not None:
            ids, ts = step_clock
            span = (ts >= d.t_start) & (ts <= d.t_end)
            steps = set(int(x) for x in np.asarray(ids)[span])
        true_kinds: Set[str] = set()
        for w, ((lo, hi), kinds) in enumerate(windows):
            if any(lo <= s < hi + grace_steps for s in steps):
                true_kinds |= kinds
                hit_windows.add(w)
        if not true_kinds:
            spurious += 1
            continue
        matched += 1
        if d.fault_kind in true_kinds:
            kind_ok += 1
        if fault_nodes & set(int(n) for n in d.blamed_nodes):
            node_ok += 1
        if d.action.kind in {policy_for(k).action for k in true_kinds}:
            action_ok += 1
    return DiagnosisMetrics(
        diagnoses_total=len(diagnoses), matched=matched, spurious=spurious,
        kind_correct=kind_ok, node_correct=node_ok, action_correct=action_ok,
        windows_total=len(windows), windows_diagnosed=len(hit_windows))
