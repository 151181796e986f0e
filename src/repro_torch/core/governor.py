"""Governance: map diagnosed faults to operational actions (the "G" in
eACGM). At 1000+ node scale the monitor's job is not just flagging — it must
recommend mitigations: straggler drain, checkpoint-restart, comm re-route.

Policies are a **registry keyed by fault kind** (the chaos taxonomy of
`repro_torch.core.chaos.ALL_KINDS`), not by layer: the diagnosis engine
(`repro_torch.diagnosis`) turns ranked incidents into a blamed fault kind,
and the governor turns that kind into the recommended `Action`. Third-party
policies register with `register_policy` and become addressable the moment
a diagnosis blames their kind.

Consumers:

* `repro_torch.session.Session.on_step` runs `Governor.decide` on each
  detection sweep and `Governor.act` on each finalised diagnosis; the
  launcher (`repro_torch.launch.train --monitor-spec ...`) prints the
  actions and honours ``checkpoint_now`` with an immediate snapshot when
  given ``--checkpoint-dir`` (`repro_torch.train.checkpoint`).
* `repro_torch.quickstart` runs `Governor.decide` on the detection results
  of a monitored training run and prints the actions.
* `docs/runbook.md` documents one operator playbook per fault kind; each
  `Policy.runbook` anchor points into it (coverage is enforced by
  `tools/check_docs.py`).

`Governor.decide` remains the legacy per-layer path — layers map to their
default fault kind via `LAYER_DEFAULT_KIND` — so detection-rate governance
works even when no incident (and hence no diagnosis) has formed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.detector import DetectionResult
from repro_torch.core.events import Layer

# the closed set of action kinds a policy may recommend (documented one by
# one in docs/runbook.md; tools/check_docs.py keeps that in sync)
ACTION_KINDS = ("checkpoint_now", "restart_rank", "throttle", "reroute",
                "alert")


@dataclasses.dataclass
class Action:
    kind: str  # one of ACTION_KINDS
    reason: str
    severity: float  # 0..1
    steps: List[int]


@dataclasses.dataclass(frozen=True)
class Policy:
    """One mitigation policy: what to do when a fault kind is blamed."""

    fault_kind: str  # chaos taxonomy kind (repro_torch.core.chaos.ALL_KINDS)
    tag: str  # short operator-facing family tag
    action: str  # one of ACTION_KINDS
    reason: str  # what the action is and why it helps
    runbook: str = ""  # docs/runbook.md anchor of the matching playbook


# fault kind -> Policy. Keyed by the chaos taxonomy so a diagnosis maps to a
# mitigation without knowing which layer carried the signal.
POLICIES: Dict[str, Policy] = {}


def register_policy(policy: Policy) -> Policy:
    """Add (or override) the policy for ``policy.fault_kind``."""
    if policy.action not in ACTION_KINDS:
        raise ValueError(f"unknown action kind {policy.action!r}; "
                         f"pick from {ACTION_KINDS}")
    POLICIES[policy.fault_kind] = policy
    return policy


GENERIC_POLICY = Policy(
    fault_kind="unknown", tag="generic", action="alert",
    reason="anomaly detected; no specific mitigation registered for this "
           "fault kind — inspect the incident report",
    runbook="unknown-unattributed-anomaly")


def policy_for(fault_kind: str) -> Policy:
    """The registered policy for a fault kind (generic alert fallback)."""
    return POLICIES.get(fault_kind, GENERIC_POLICY)


BUILTIN_POLICIES = [
    Policy("python_latency", "straggler", "checkpoint_now",
           "host-side stall (GIL/input pipeline): snapshot state now and "
           "drain the slow host before it stalls the collective",
           runbook="pythonlatency-host-stall-straggler"),
    Policy("op_latency", "operator", "alert",
           "operator-level latency regression: check JIT/fusion changes and "
           "recent library bumps before restarting anything",
           runbook="oplatency-operator-latency-spike"),
    Policy("xla_latency", "runtime", "alert",
           "runtime/kernel-level slowdown: check for recompilation storms "
           "and executable cache misses",
           runbook="xlalatency-runtime-kernel-stall"),
    Policy("hw_contention", "hardware", "restart_rank",
           "device contention (co-scheduled process stealing the "
           "accelerator): reschedule the affected process on a clean host",
           runbook="hwcontention-device-contention"),
    Policy("mem_leak", "hardware", "checkpoint_now",
           "device memory ramping toward OOM: snapshot state now, then "
           "restart the leaking process before the allocator falls over",
           runbook="memleak-device-memory-leak"),
    Policy("net_latency", "comm", "reroute",
           "collective latency uniformly inflated: suspect a degraded "
           "ICI/DCN link, re-route or restart the slice",
           runbook="netlatency-communication-slowdown"),
    Policy("packet_loss", "comm", "reroute",
           "retransmit inflation on a subset of messages: suspect a flaky "
           "NIC/link, replace the path",
           runbook="packetloss-packet-loss"),
    # request-plane kinds (SLO-breach incidents of the serve plane)
    Policy("tenant_flood", "serve-queue", "throttle",
           "one tenant's arrival rate is starving the admission queue: "
           "rate-limit that tenant at admission until the backlog drains",
           runbook="tenantflood-tenant-admission-flood"),
    Policy("heavy_prompt_skew", "serve-prefill", "reroute",
           "oversized prompts are monopolising prefill and inflating TTFT: "
           "route long-prompt requests to a dedicated prefill pool",
           runbook="heavypromptskew-heavy-prompt-skew"),
    Policy("slow_client_stall", "serve-client", "alert",
           "token delivery is stalling on slow clients, not on compute: "
           "enable client-side backpressure/timeouts before evicting",
           runbook="slowclientstall-slow-client-stall"),
]
for _p in BUILTIN_POLICIES:
    register_policy(_p)


# legacy per-layer governance: the fault kind a flagging layer defaults to
# when only detection rates (no diagnosis) are available. The step layer is
# the whole-stack symptom, so a step-dominated detection reads as a host
# straggler — the diagnosis engine refines this with cross-layer evidence.
LAYER_DEFAULT_KIND: Dict[Layer, str] = {
    Layer.STEP: "python_latency",
    Layer.PYTHON: "python_latency",
    Layer.OPERATOR: "op_latency",
    Layer.XLA: "xla_latency",
    Layer.COLLECTIVE: "net_latency",
    Layer.DEVICE: "hw_contention",
    # request rows are SLO-thresholded, not GMM-modelled, so this default is
    # only reachable through the legacy rate path; queue pressure is the
    # dominant request-plane failure mode
    Layer.REQUEST: "tenant_flood",
}


class Governor:
    def __init__(self, rate_threshold: float = 0.25, min_events: int = 8):
        self.rate_threshold = rate_threshold
        self.min_events = min_events

    def decide(self, results: Dict[Layer, DetectionResult]) -> List[Action]:
        """Legacy rate-based path: one action per layer whose anomaly rate
        breaches the threshold, via that layer's default fault kind."""
        actions: List[Action] = []
        for layer, res in results.items():
            if len(res.flags) < self.min_events:
                continue
            rate = res.anomaly_rate
            if rate < self.rate_threshold:
                continue
            pol = policy_for(LAYER_DEFAULT_KIND.get(layer, "unknown"))
            actions.append(Action(
                kind=pol.action,
                reason=f"[{pol.tag}] {pol.reason} (rate={rate:.2f})",
                severity=min(1.0, rate / max(self.rate_threshold, 1e-9) / 2),
                steps=[int(s) for s in res.anomalous_steps()[:16]],
            ))
        actions.sort(key=lambda a: -a.severity)
        return actions

    def act(self, diagnosis) -> Action:
        """The action a finalised diagnosis recommends (any object with
        ``fault_kind``, ``blamed_nodes``, ``incident_id``, ``confidence``,
        ``severity`` and ``steps``)."""
        pol = policy_for(diagnosis.fault_kind)
        nodes = ",".join(str(n) for n in diagnosis.blamed_nodes) or "?"
        return Action(
            kind=pol.action,
            reason=(f"[{pol.tag}] {pol.reason} "
                    f"(incident #{diagnosis.incident_id}, "
                    f"confidence={diagnosis.confidence:.2f}, "
                    f"node(s)={nodes})"),
            severity=float(
                min(1.0, diagnosis.severity * diagnosis.confidence)),
            steps=list(diagnosis.steps[:16]),
        )
