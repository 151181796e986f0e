"""Root-cause diagnosis: ranked incidents -> scored, actionable diagnoses
(port of `repro/diagnosis/engine.py`; only the imports differ).

An `Incident` names a suspect layer and suspect nodes; a `Diagnosis` commits
to a **fault kind** from the chaos taxonomy (`repro_torch.core.chaos.ALL_KINDS`),
a **causal chain** across layers, a **confidence**, and the **recommended
action** from the governor's policy registry. The attribution combines three
signal families (see docs/diagnosis.md for the methodology):

1. **deficit shares** — how much of the incident's score deficit each layer
   carries. Cause layers map to fault kinds directly (operator ->
   ``op_latency``, xla -> ``xla_latency``, python -> ``python_latency``).
   The step layer is the whole-stack symptom: a genuine cause-layer fault
   drags it along with a *comparable* deficit, so only the symptom deficit
   **in excess of the best cause layer** credits the host-stall hypothesis
   (``python_latency`` — a real sleep stretches the step without any
   layer-specific signature, exactly like the ``straggler_host`` scenario).
2. **deficit lead/lag** — `Incident.layer_first_ts` orders the flagged
   layers by when each first crossed the threshold; the earliest layer
   leads the causal chain (device thermal -> operator slowdown -> step
   latency).
3. **telemetry/event corroboration** — evidence columns disambiguate kinds
   that share a layer: on the device layer a sustained ``mem_gb`` ramp
   separates ``mem_leak`` from the elevated ``util`` of ``hw_contention``;
   on the collective layer the *slowed fraction* of messages (vs their
   per-name clean baselines) separates the uniform inflation of
   ``net_latency`` from the partial, retransmit-shaped inflation of
   ``packet_loss``.

Evidence is a per-layer column dict (the streaming aggregator's window
views, or `evidence_from_columns` over a batch drain). Without evidence the
engine still diagnoses from deficit shares alone, at reduced confidence.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.events import LAYERS, Layer
from repro_torch.core.governor import Action, Governor, policy_for
from repro_torch.stream.incidents import Incident

# fault kind -> the taxonomy family label used in reports and docs
FAULT_FAMILY = {
    "op_latency": "latency",
    "xla_latency": "runtime",
    "python_latency": "host-stall",
    "hw_contention": "device-contention",
    "mem_leak": "mem-leak",
    "net_latency": "comm-slowdown",
    "packet_loss": "packet-loss",
    # request-plane kinds (SLO-breach incidents of the serve plane)
    "tenant_flood": "serve-flood",
    "heavy_prompt_skew": "serve-skew",
    "slow_client_stall": "serve-stall",
}

# per-layer evidence columns (matching LayerWindow.view() / wire schema)
EVIDENCE_KEYS = ("ts", "dur", "size", "name", "step", "node",
                 "util", "mem_gb", "power_w", "temp_c")

Evidence = Dict[Layer, Dict[str, np.ndarray]]


def evidence_from_columns(cols: Dict[str, np.ndarray]) -> Evidence:
    """Split a wire-schema ColumnView (int8 ``layer`` codes, ``pid`` as the
    node id) into the per-layer evidence dicts the diagnoser reads."""
    out: Evidence = {}
    if not cols or not cols["ts"].shape[0]:
        return out
    codes = cols["layer"]
    for code, layer in enumerate(LAYERS):
        m = np.flatnonzero(codes == code)
        if not m.shape[0]:
            continue
        ev = {k: cols[k][m] for k in EVIDENCE_KEYS
              if k in cols and k != "node"}
        ev["node"] = cols["pid"][m] if "pid" in cols else np.zeros(
            m.shape[0], dtype=np.int32)
        out[layer] = ev
    return out


@dataclasses.dataclass
class ChainLink:
    """One layer's position in the causal chain of an incident."""

    layer: str
    t_first: float  # first flagged ts (collector clock)
    lag_s: float  # seconds behind the chain's leading layer
    deficit: float
    share: float  # fraction of the incident's total deficit

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Diagnosis:
    """One incident, attributed: blamed kind, chain, nodes, action."""

    incident_id: int
    fault_kind: str  # chaos taxonomy kind
    family: str  # FAULT_FAMILY label
    confidence: float  # 0..1
    severity: float  # 0..1 (normalised incident severity)
    blamed_nodes: List[int]
    causal_chain: List[ChainLink]  # lead layer first
    action: Action  # the governor's recommended mitigation
    steps: List[int]  # anomalous steps inherited from the incident
    t_start: float
    t_end: float
    candidates: Dict[str, float]  # kind -> normalised score
    evidence: Dict[str, object]  # corroboration details (see docs)

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["causal_chain"] = [c.to_json() for c in self.causal_chain]
        return d

    def chain_str(self) -> str:
        parts = []
        for link in self.causal_chain:
            lag = f"(+{link.lag_s:.2f}s)" if link.lag_s > 0 else ""
            parts.append(f"{link.layer}{lag}")
        return " -> ".join(parts) if parts else "-"

    def render(self) -> str:
        nodes = ",".join(str(n) for n in self.blamed_nodes) or "?"
        ev = " ".join(f"{k}={v}" for k, v in sorted(self.evidence.items())
                      if not isinstance(v, (dict, list)))
        lines = [
            f"[diagnosis #{self.incident_id}] fault={self.fault_kind} "
            f"({self.family}) confidence={self.confidence:.2f} "
            f"node(s)={nodes} severity={self.severity:.2f}",
            f"    chain: {self.chain_str()}",
            f"    action: {self.action.kind} — {self.action.reason}",
        ]
        if ev:
            lines.append(f"    evidence: {ev}")
        return "\n".join(lines)


class Diagnoser:
    """Scores the chaos fault kinds against one incident's evidence.

    Deterministic and stateless per incident: the same incident + evidence
    always yields the same diagnosis (no RNG, no fitted state), so report
    rendering is reproducible and testable against goldens.
    """

    SYMPTOM_LAYERS = (Layer.STEP.value,)
    # cause layer -> the kind(s) its deficit supports
    LAYER_KINDS = {
        Layer.OPERATOR.value: ("op_latency",),
        Layer.XLA.value: ("xla_latency",),
        Layer.PYTHON.value: ("python_latency",),
        Layer.DEVICE.value: ("hw_contention", "mem_leak"),
        Layer.COLLECTIVE.value: ("net_latency", "packet_loss"),
    }

    def __init__(self, slow_ratio: float = 1.5,
                 uniform_slow_fraction: float = 0.75,
                 leak_min_rise_gb: float = 1.0,
                 util_excess_pts: float = 10.0,
                 severity_scale: float = 50.0,
                 uncorroborated_discount: float = 0.7,
                 min_confidence: float = 0.0,
                 min_mean_deficit: float = 20.0):
        # collective split: a message is "slowed" when its duration exceeds
        # slow_ratio x its per-name clean baseline; a slowed fraction at or
        # above uniform_slow_fraction reads as uniform inflation (delay),
        # below it as partial inflation (loss/retransmits)
        self.slow_ratio = float(slow_ratio)
        self.uniform_slow_fraction = float(uniform_slow_fraction)
        # device split: an in-window mem ramp must clear leak_min_rise_gb to
        # count as a leak; util_excess_pts (percentage points over the clean
        # reference) is the contention yardstick
        self.leak_min_rise_gb = float(leak_min_rise_gb)
        self.util_excess_pts = float(util_excess_pts)
        self.severity_scale = float(severity_scale)
        self.uncorroborated_discount = float(uncorroborated_discount)
        self.min_confidence = float(min_confidence)
        # the attribution floor: calibration/timing-noise false positives
        # score just below the contamination threshold (clean-control runs
        # measure spurious incidents at ~1-9 nats of mean per-flag deficit
        # on a quiet host, up to ~10-15 under noisy-neighbour CPU
        # contention — an OS stall makes operators GENUINELY slow, so the
        # detector is right to flag and the floor is what keeps the
        # diagnosis honest), while genuine faults land far below it
        # (>= ~25 nats for the weakest injected scenario, hundreds for
        # network faults).
        # Incidents whose mean per-flag deficit sits inside the calibration
        # band are statistically indistinguishable from the detector's own
        # false-positive floor and are left undiagnosed — this is what
        # keeps the clean-control scenario at zero diagnoses.
        self.min_mean_deficit = float(min_mean_deficit)
        self.governor = Governor()

    # -- public API -----------------------------------------------------------
    def diagnose(self, incident: Incident,
                 evidence: Optional[Evidence] = None) -> Optional[Diagnosis]:
        """Attribute one incident. Returns None when the incident sits
        below the attribution floor (``min_mean_deficit``) or the diagnosis
        falls below ``min_confidence``."""
        if (incident.severity / max(incident.n_flags, 1)
                < self.min_mean_deficit):
            return None
        scores, detail = self._candidate_scores(incident, evidence or {})
        total = sum(scores.values())
        if total <= 0:  # no deficit at all: nothing to blame
            return None
        norm = {k: v / total for k, v in scores.items() if v > 0}
        kind = max(norm, key=norm.get)
        confidence = norm[kind]
        if kind in ("hw_contention", "mem_leak", "net_latency",
                    "packet_loss") and not detail.get("corroborated", False):
            confidence *= self.uncorroborated_discount
        confidence = float(min(1.0, confidence))
        if confidence < self.min_confidence:
            return None
        diag = Diagnosis(
            incident_id=incident.incident_id,
            fault_kind=kind,
            family=FAULT_FAMILY.get(kind, "unknown"),
            confidence=confidence,
            severity=float(1.0 - math.exp(
                -incident.severity / self.severity_scale)),
            blamed_nodes=list(incident.suspect_nodes),
            causal_chain=self._chain(incident),
            action=None,  # filled below (act() reads the diagnosis)
            steps=list(incident.steps),
            t_start=incident.t_start, t_end=incident.t_end,
            candidates={k: round(v, 4) for k, v in sorted(
                norm.items(), key=lambda kv: -kv[1])},
            evidence=detail)
        diag.action = self.governor.act(diag)
        return diag

    def diagnose_all(self, incidents: Sequence[Incident],
                     evidence: Optional[Evidence] = None) -> List[Diagnosis]:
        """Diagnose a ranked incident list (severity order preserved)."""
        out = []
        for inc in incidents:
            d = self.diagnose(inc, evidence)
            if d is not None:
                out.append(d)
        return out

    def diagnose_slo(self, incident: Incident,
                     rows: Optional[Dict[str, np.ndarray]] = None,
                     spec=None) -> Optional[Diagnosis]:
        """Attribute one request-plane SLO-breach incident.

        ``rows`` is the SLO monitor's row history within the incident span
        (`SLOMonitor.evidence_for`): every judged request metric, breached
        or not. This path deliberately bypasses the ``min_mean_deficit``
        gate — SLO deficits measure relative target excess, not GMM density
        shortfall, and a breach incident is by construction not detector
        calibration noise. The three request-plane kinds separate on

        * **tenant_flood** — queue-dominated breaches (queue wait explains
          the TTFT excess) concentrated on one tenant,
        * **heavy_prompt_skew** — TTFT-dominated breaches whose prompts are
          much larger than the run's reference prompt size,
        * **slow_client_stall** — per-token (TPOT/client-stall) breaches.
        """
        if incident.kind != "slo_breach":
            return None
        names = None if rows is None else rows.get("name")
        if names is None or not len(names):
            return None
        flagged = rows["flagged"]
        if not flagged.any():
            return None
        f_names = names[flagged]
        n_b = len(f_names)

        def share(*metrics):
            return float(sum((f_names == m).sum() for m in metrics)) / n_b

        b_queue = share("serve/queue_wait", "serve/queue_depth")
        b_ttft = share("serve/ttft")
        b_rate = share("serve/tpot", "serve/client_stall")
        # does queue wait explain the TTFT excess? (TTFT includes the wait)
        qw = rows["value"][names == "serve/queue_wait"]
        tf = rows["value"][(names == "serve/ttft") & flagged]
        wait_frac = 0.0
        if len(qw) and len(tf):
            wait_frac = float(np.clip(
                np.median(qw) / max(float(np.median(tf)), 1e-9), 0.0, 1.0))
        # prompt-size signal: heavy prompts are a *subset* of the breaching
        # requests (normal-size requests stuck behind them breach too), so
        # compare the upper quantile of breaching prompt sizes against the
        # run's *global* running reference — the incident span itself is
        # contaminated by the fault, so span-local references are useless
        ttft_rows = names == "serve/ttft"
        f_sizes = rows["size"][ttft_rows & flagged]
        ref_size = float(rows.get("ref_prompt_size", 0.0) or 0.0)
        size_ratio = (float(np.quantile(f_sizes, 0.75)) / ref_size
                      if len(f_sizes) and ref_size > 0 else 1.0)
        size_sig = max(0.0, size_ratio - 1.0)
        # tenant concentration among tenant-attributed breaches (queue
        # samples carry tenant -1 and are excluded) — as a *lift* over that
        # tenant's share of the run's global arrival mix, so a tenant that
        # naturally dominates the mix does not read as a flood
        tenants = rows["tenant"][flagged]
        tenants = tenants[tenants >= 0]
        ref_share = rows.get("ref_tenant_share") or {}
        conc, lift, top_tenant = 0.0, 1.0, None
        if len(tenants):
            ids, counts = np.unique(tenants, return_counts=True)
            conc = float(counts.max()) / float(counts.sum())
            top_tenant = int(ids[np.argmax(counts)])
            base_share = float(ref_share.get(top_tenant, conc))
            lift = conc / max(base_share, 1e-9)
        flood_sig = float(np.clip(lift - 1.0, 0.0, 1.0))
        stall_rows = bool((f_names == "serve/client_stall").any())
        scores = {
            "tenant_flood": (b_queue + b_ttft * wait_frac)
            * (0.25 + 0.75 * conc) * (0.5 + flood_sig)
            * (0.5 if size_sig >= 1.0 else 1.0),
            "heavy_prompt_skew": (b_ttft + 0.5 * b_queue)
            * min(size_sig, 2.0),
            "slow_client_stall": 2.0 * b_rate + (1.0 if stall_rows else 0.0),
        }
        total = sum(scores.values())
        if total <= 0:
            return None
        norm = {k: v / total for k, v in scores.items() if v > 0}
        kind = max(norm, key=norm.get)
        detail = {
            "breach_share_queue": round(b_queue, 3),
            "breach_share_ttft": round(b_ttft, 3),
            "breach_share_rate": round(b_rate, 3),
            "wait_frac_of_ttft": round(wait_frac, 3),
            "prompt_size_ratio": round(size_ratio, 2),
            "tenant_concentration": round(conc, 3),
            "tenant_lift": round(lift, 2),
        }
        if top_tenant is not None:
            detail["top_tenant"] = top_tenant
        diag = Diagnosis(
            incident_id=incident.incident_id,
            fault_kind=kind,
            family=FAULT_FAMILY.get(kind, "unknown"),
            confidence=float(min(1.0, norm[kind])),
            severity=float(1.0 - math.exp(
                -incident.severity / self.severity_scale)),
            blamed_nodes=[n for n in incident.suspect_nodes if n >= 0],
            causal_chain=self._slo_chain(rows),
            action=None,
            steps=list(incident.steps),
            t_start=incident.t_start, t_end=incident.t_end,
            candidates={k: round(v, 4) for k, v in sorted(
                norm.items(), key=lambda kv: -kv[1])},
            evidence=detail)
        diag.action = self.governor.act(diag)
        return diag

    def _slo_chain(self, rows: Dict[str, np.ndarray]) -> List[ChainLink]:
        """Breach ordering across request metrics (queue wait breaching
        before TTFT before TPOT is the flood signature, etc.)."""
        names, flagged = rows["name"], rows["flagged"]
        ts, ratio = rows["ts"], rows["ratio"]
        total = float(np.maximum(ratio[flagged] - 1.0, 0.0).sum()) or 1.0
        links = []
        for metric in np.unique(names[flagged]):
            on = flagged & (names == metric)
            deficit = float(np.maximum(ratio[on] - 1.0, 0.0).sum())
            links.append((float(ts[on].min()), str(metric), deficit))
        links.sort()
        t0 = links[0][0] if links else 0.0
        return [ChainLink(layer=metric, t_first=t, lag_s=float(t - t0),
                          deficit=round(deficit, 2),
                          share=float(deficit / total))
                for t, metric, deficit in links]

    # -- attribution ----------------------------------------------------------
    def _candidate_scores(self, inc: Incident, evidence: Evidence):
        """Per-kind scores (non-negative, arbitrary scale) + evidence
        detail. Cause-layer deficit shares anchor the scores; telemetry and
        event evidence split the two-kind layers."""
        detail: Dict[str, object] = {}
        cause = {l: d for l, d in inc.layer_deficit.items()
                 if l not in self.SYMPTOM_LAYERS and d > 0}
        symptom = sum(d for l, d in inc.layer_deficit.items()
                      if l in self.SYMPTOM_LAYERS)
        scores = {k: 0.0 for k in FAULT_FAMILY}
        if not cause:
            # only the whole-stack symptom flagged: a host stall stretches
            # the step without leaving a layer-specific trace
            scores["python_latency"] = float(symptom or 1.0)
            detail["corroborated"] = True
            return scores, detail
        # a genuine cause-layer fault drags the step symptom along with a
        # COMPARABLE deficit (the step mirrors the cause); a host stall
        # leaves the step deficit unexplained by any cause layer. Only the
        # unexplained excess credits the host-stall hypothesis — the rest of
        # the symptom deficit is accounted for by the leading cause.
        stall_credit = max(0.0, symptom - max(cause.values()))
        if stall_credit:
            detail["symptom_excess"] = round(stall_credit, 1)
        pool = sum(cause.values()) + stall_credit
        scores["python_latency"] += stall_credit / pool
        corroborated = True
        for layer, deficit in cause.items():
            share = deficit / pool
            kinds = self.LAYER_KINDS.get(layer)
            if kinds is None:
                continue
            if len(kinds) == 1:
                scores[kinds[0]] += share
            elif layer == Layer.DEVICE.value:
                w_leak, ok = self._device_split(inc, evidence, detail)
                corroborated &= ok
                scores["mem_leak"] += share * w_leak
                scores["hw_contention"] += share * (1.0 - w_leak)
            elif layer == Layer.COLLECTIVE.value:
                w_loss, ok = self._collective_split(inc, evidence, detail)
                corroborated &= ok
                scores["packet_loss"] += share * w_loss
                scores["net_latency"] += share * (1.0 - w_loss)
        detail["corroborated"] = bool(corroborated)
        return scores, detail

    def _device_split(self, inc: Incident, evidence: Evidence,
                      detail: Dict[str, object]):
        """w_leak in [0, 1]: 1 = the device deficit looks like a memory
        ramp, 0 = like contention. Three telemetry signatures against the
        pre-incident reference: a leak raises ``mem_gb`` **monotonically**
        and leaves ``util`` alone; contention raises ``util`` and adds
        *jittery* (non-monotone) memory pressure."""
        ev = evidence.get(Layer.DEVICE)
        if ev is None or not len(ev["ts"]):
            return 0.0, False  # default: contention, uncorroborated
        ts, util, mem = ev["ts"], ev.get("util"), ev.get("mem_gb")
        if util is None or mem is None:
            return 0.0, False
        # telemetry rows only (host.process rows carry NaN telemetry)
        tel = ~np.isnan(np.asarray(util, dtype=np.float64))
        ts, util, mem = ts[tel], util[tel], mem[tel]
        nodes = ev["node"][tel] if "node" in ev else np.zeros(tel.sum())
        names = ev["name"][tel].astype(str, copy=False)
        inside = (ts >= inc.t_start) & (ts <= inc.t_end)
        before = ts < inc.t_start
        if inside.sum() < 4 or not before.any():
            return 0.0, False
        ref_mem = float(np.median(mem[before]))
        ref_util = float(np.mean(util[before]))
        util_excess = float(np.quantile(util[inside], 0.9) - ref_util)
        mem_excess = float(np.quantile(mem[inside], 0.9) - ref_mem)
        # monotone fraction of the elevated-memory samples: a leak ramps
        # (successive diffs >= 0 inside each burst), contention draws fresh
        # jitter per sample (diffs split ~50/50). Each (node, device)
        # telemetry series is measured on its own, time-sorted — pooling
        # interleaved devices would compare samples across series and read
        # any multi-device leak as jitter
        monotone = 0.0
        if mem_excess > 0:
            elev = inside & (mem > ref_mem + 0.25 * mem_excess)
            keys = np.char.add(nodes.astype(np.int64).astype("<U20"),
                               np.char.add("/", names))
            for key in np.unique(keys[elev]):
                on = elev & (keys == key)
                if on.sum() < 3:
                    continue
                series = mem[on][np.argsort(ts[on], kind="stable")]
                monotone = max(monotone,
                               float(np.mean(np.diff(series) >= -1e-3)))
        cont_like = max(0.0, util_excess) / self.util_excess_pts
        leak_like = (max(0.0, mem_excess) / self.leak_min_rise_gb
                     * max(0.0, 2.0 * monotone - 1.0))
        detail["mem_rise_gb"] = round(mem_excess, 2)
        detail["mem_monotone"] = round(monotone, 2)
        detail["util_excess_pts"] = round(util_excess, 1)
        if leak_like <= 0 and cont_like <= 0:
            return 0.0, False
        return float(leak_like / (leak_like + cont_like)), True

    def _collective_split(self, inc: Incident, evidence: Evidence,
                          detail: Dict[str, object]):
        """w_loss in [0, 1]: 1 = partial, retransmit-shaped inflation
        (packet loss), 0 = uniform inflation (network delay). Measures the
        fraction of in-window messages slower than slow_ratio x their
        per-name pre-incident median."""
        ev = evidence.get(Layer.COLLECTIVE)
        if ev is None or not len(ev["ts"]):
            return 0.0, False  # default: delay, uncorroborated
        ts, dur = ev["ts"], ev["dur"]
        names = ev["name"].astype(str, copy=False)
        live = ~np.char.startswith(names, "static/")
        ts, dur, names = ts[live], dur[live], names[live]
        steps = ev.get("step")
        if steps is not None and inc.steps:
            # slice by the incident's anomalous steps, not its time span: a
            # multi-burst incident cluster includes the clean gaps between
            # bursts, and counting those messages as "not slowed" would make
            # a uniform delay look partial (i.e. like loss)
            inside = np.isin(steps[live], np.asarray(inc.steps))
            before = (ts < inc.t_start) & ~inside
        else:
            inside = (ts >= inc.t_start) & (ts <= inc.t_end)
            before = ts < inc.t_start
        if inside.sum() < 4 or not before.any():
            return 0.0, False
        # baseline per (name, size): one collective schedule reuses one op
        # name across very different message sizes, and a pooled median
        # would hide a uniform slowdown of the small messages
        size = ev["size"][live] if "size" in ev else np.zeros_like(dur)
        keys = np.char.add(np.char.add(names.astype("<U80"), "/"),
                           size.astype(np.int64).astype("<U20"))
        base: Dict[str, float] = {}
        for key in np.unique(keys[before]):
            base[key] = float(np.median(dur[before & (keys == key)]))
        gbase = float(np.median(dur[before]))
        ref = np.array([base.get(k, gbase) for k in keys[inside]])
        slow = (dur[inside] / np.maximum(ref, 1e-12)) > self.slow_ratio
        detail["slowed_fraction"] = round(float(np.mean(slow)), 3)
        # the sharp signature is per-STEP uniformity: a delay scales every
        # message of a faulted step together (per-step slowed fraction f_s
        # is ~1), loss retransmits a random subset (f_s ~ the drop
        # probability). u = mean |2 f_s - 1| over steps with >= 2 messages
        # and >= 1 slowed message: ~1 under delay, well below under loss.
        # Steps with no slowed message are excluded — incident clusters
        # sweep in spuriously flagged clean steps, and an all-clean step's
        # f_s = 0 would read as "uniform" and mask the loss signature.
        u = None
        if steps is not None:
            in_steps = steps[live][inside]
            fracs = []
            for st in np.unique(in_steps):
                on = in_steps == st
                if on.sum() >= 2 and slow[on].any():
                    fracs.append(abs(2.0 * float(np.mean(slow[on])) - 1.0))
            if len(fracs) >= 3:
                u = float(np.mean(fracs))
        if u is not None:
            detail["step_uniformity"] = round(u, 3)
            w_loss = 1.0 / (1.0 + math.exp((u - 0.7) * 10.0))
        else:
            # no step ids: fall back to the overall slowed fraction
            w_loss = 1.0 / (1.0 + math.exp(
                (float(np.mean(slow)) - self.uniform_slow_fraction) * 10.0))
        return float(w_loss), True

    def _chain(self, inc: Incident) -> List[ChainLink]:
        total = sum(inc.layer_deficit.values()) or 1.0
        firsts = inc.layer_first_ts or {
            l: inc.t_start for l in inc.layer_deficit}
        ordered = sorted(firsts.items(), key=lambda kv: kv[1])
        t0 = ordered[0][1] if ordered else inc.t_start
        return [ChainLink(layer=layer, t_first=float(t),
                          lag_s=float(t - t0),
                          deficit=float(inc.layer_deficit.get(layer, 0.0)),
                          share=float(
                              inc.layer_deficit.get(layer, 0.0) / total))
                for layer, t in ordered]


def diagnoses_to_json(diagnoses: Sequence[Diagnosis]) -> str:
    return json.dumps([d.to_json() for d in diagnoses], indent=1,
                      default=float)
