"""Fault injection — the pytorchfi / DCGM-error-injection / chaosblade analogue
(paper §V): schedule labelled faults against a monitored run.

Fault kinds, the probe hook they perturb (paper §V fault matrix), and the
unit of ``Fault.magnitude`` for each:

* ``python_latency`` — host-side stalls (GIL/input pipeline): StepProbe.extra_latency
                       (a REAL time.sleep — the python probe observes it live).
                       magnitude: seconds added per step.
* ``op_latency``     — operator/software delays (pytorchfi): StepProbe.extra_op.
                       magnitude: seconds added per step.
* ``xla_latency``    — runtime/kernel-level slowdowns (DCGM kernel timeout):
                       StepProbe.extra_xla (inflates the executable_run events).
                       magnitude: seconds added per step.
* ``hw_contention``  — co-scheduled processes stealing the device (paper §V-C):
                       GpuTelemetryModel.contention.
                       magnitude: fraction of the device stolen, clipped to 0..1.
* ``mem_leak``       — monotone device-memory growth: GpuTelemetryModel
                       .mem_leak_gb ramps while the fault is active.
                       magnitude: GB leaked per active step (leak at step s =
                       magnitude * (s - start_step + 1), reset when inactive).
* ``net_latency``    — chaosblade network delay: CollectiveProbe.comm_scale.
                       magnitude: multiplicative latency scale (>= 1 slows).
* ``packet_loss``    — chaosblade loss: CollectiveProbe.drop_prob.
                       magnitude: per-message drop probability, clipped to 0..0.9.

Ground truth: every step inside an active fault window is labelled anomalous
(overlapping windows OR together), giving the ~5:1 normal:anomalous dataset
of the paper. `Scenario` packages named, deterministic fault schedules (the
evaluation harness's unit of work — see ``docs/evaluation.md``; the harness
is not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Fault:
    # python_latency | op_latency | xla_latency | hw_contention | mem_leak |
    # net_latency | packet_loss
    kind: str
    start_step: int
    end_step: int
    # units by kind (see module docstring): seconds (latency kinds),
    # 0-1 fraction (hw_contention), GB/step (mem_leak), scale (net_latency),
    # probability (packet_loss)
    magnitude: float

    def active(self, step: int) -> bool:
        return self.start_step <= step < self.end_step

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


LATENCY_KINDS = ("python_latency", "op_latency", "xla_latency")
DEVICE_KINDS = ("hw_contention", "mem_leak")
NETWORK_KINDS = ("net_latency", "packet_loss")
# request-plane kinds perturb the serve LOAD GENERATOR (the arrival mix),
# not a probe: the request plane is the layer under test, so the fault is in
# the traffic itself (the serve plane's load generator, not ported yet):
#
# * ``tenant_flood``      — one tenant's arrival rate multiplied.
#                           magnitude: rate multiplier (>= 1 floods).
# * ``heavy_prompt_skew`` — prompt lengths multiplied while active.
#                           magnitude: length multiplier (>= 1 skews).
# * ``slow_client_stall`` — new requests' clients stall token delivery.
#                           magnitude: seconds of stall per delivered token.
SERVE_KINDS = ("tenant_flood", "heavy_prompt_skew", "slow_client_stall")
ALL_KINDS = LATENCY_KINDS + DEVICE_KINDS + NETWORK_KINDS + SERVE_KINDS

# per-kind default magnitudes, in each kind's own unit (module docstring)
DEFAULT_MAGNITUDES = {"op_latency": 0.05, "xla_latency": 0.03,
                      "python_latency": 0.04, "hw_contention": 0.5,
                      "mem_leak": 0.25, "net_latency": 4.0,
                      "packet_loss": 0.3, "tenant_flood": 8.0,
                      "heavy_prompt_skew": 4.0, "slow_client_stall": 0.08}


class FaultInjector:
    """Applies/clears faults on the collector's probes as steps advance."""

    def __init__(self, faults: Sequence[Fault]):
        self.faults = list(faults)

    @staticmethod
    def random_schedule(n_steps: int, kinds: Sequence[str],
                        anomaly_fraction: float = 1 / 6,
                        burst: int = 5, seed: int = 0,
                        magnitudes: Optional[Dict[str, float]] = None
                        ) -> "FaultInjector":
        """Poisson-ish fault bursts covering ~anomaly_fraction of steps."""
        rng = np.random.default_rng(seed)
        mags = dict(DEFAULT_MAGNITUDES)
        mags.update(magnitudes or {})
        n_burst_steps = int(n_steps * anomaly_fraction)
        n_bursts = max(1, n_burst_steps // burst)
        starts = np.sort(rng.choice(
            np.arange(burst, n_steps - burst), n_bursts, replace=False))
        faults = []
        for s in starts:
            kind = kinds[int(rng.integers(len(kinds)))]
            mag = mags[kind] * float(rng.uniform(0.7, 1.5))
            faults.append(Fault(kind, int(s), int(s + burst), mag))
        return FaultInjector(faults)

    def labels(self, n_steps: int) -> np.ndarray:
        """Per-step ground truth: True where ANY fault window is active
        (overlapping windows OR together; windows are clipped to
        ``[0, n_steps)``)."""
        y = np.zeros(n_steps, dtype=bool)
        for f in self.faults:
            y[max(f.start_step, 0): max(f.end_step, 0)] = True
        return y

    def windows(self) -> List[Tuple[int, int]]:
        """Merged ``[start, end)`` step windows, sorted — the fault-level
        ground truth used for time-to-detect and incident matching
        (overlapping/adjacent faults collapse into one window)."""
        spans = sorted((f.start_step, f.end_step) for f in self.faults)
        merged: List[Tuple[int, int]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return merged

    def to_json(self) -> List[Dict[str, object]]:
        return [f.to_json() for f in self.faults]

    def apply(self, step: int, collector) -> List[Fault]:
        """Set probe perturbations for this step; returns active faults.

        Magnitudes get heavy-tailed per-step jitter (lognormal) — real faults
        (scheduler stalls, retransmits, contention) are scattered, not fixed
        offsets; a constant offset would just form its own benign-looking
        cluster under any density model.
        """
        active = [f for f in self.faults if f.active(step)]
        rng = np.random.default_rng(step * 2654435761 % (2 ** 31))

        def mag(f: Fault) -> float:
            return f.magnitude * float(rng.lognormal(0.0, 0.6))

        step_probe = collector["step"]
        coll_probe = collector["collective"]
        dev_probe = collector["device"]
        step_probe.extra_latency = sum(
            mag(f) for f in active if f.kind == "python_latency")
        step_probe.extra_op = sum(
            mag(f) for f in active if f.kind == "op_latency")
        step_probe.extra_xla = sum(
            mag(f) for f in active if f.kind == "xla_latency")
        coll_probe.comm_scale = 1.0
        coll_probe.drop_prob = 0.0
        for f in active:
            if f.kind == "net_latency":
                coll_probe.comm_scale = max(coll_probe.comm_scale, mag(f))
            elif f.kind == "packet_loss":
                coll_probe.drop_prob = max(coll_probe.drop_prob,
                                           min(f.magnitude
                                               * float(rng.uniform(0.5, 1.5)),
                                               0.9))
        cont = max((min(mag(f), 1.0) for f in active
                    if f.kind == "hw_contention"), default=0.0)
        # mem_leak ramps deterministically: magnitude GB per active step, no
        # jitter — a leak is monotone growth, not scatter
        leak = sum(f.magnitude * (step - f.start_step + 1) for f in active
                   if f.kind == "mem_leak")
        for dev in dev_probe.devices:
            dev.contention = cont
            dev.mem_leak_gb = leak
        return active

    def serve_faults(self, step: int) -> Dict[str, float]:
        """Active request-plane perturbations for this step, as the
        ``{kind: magnitude}`` dict the serve load generator consumes
        (`LoadGenerator.arrivals`). Magnitudes are NOT jittered here — the
        arrival process itself is stochastic, and the fault windows are the
        ground truth the SLO evaluation scores against."""
        out: Dict[str, float] = {}
        for f in self.faults:
            if f.kind in SERVE_KINDS and f.active(step):
                out[f.kind] = max(out.get(f.kind, 0.0), f.magnitude)
        return out

    def clear(self, collector) -> None:
        collector["step"].extra_latency = 0.0
        collector["step"].extra_op = 0.0
        collector["step"].extra_xla = 0.0
        collector["collective"].comm_scale = 1.0
        collector["collective"].drop_prob = 0.0
        for dev in collector["device"].devices:
            dev.contention = 0.0
            dev.mem_leak_gb = 0.0


# ---------------------------------------------------------------------------
# Scenario library: named, ground-truth-labelled fault campaigns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named evaluation scenario: a deterministic fault schedule plus the
    workload shape it runs against.

    The schedule is a function of ``n_steps`` only: ``n_bursts`` equal-length
    bursts of the scenario's fault kinds, evenly spaced through the live
    region (everything after ``clean_fraction`` of the run, which detection
    uses as its clean reference window). Magnitudes still get the injector's
    per-step heavy-tailed jitter at apply time, but the *windows* — the
    ground-truth labels — are reproducible from the scenario name alone.
    """

    name: str
    description: str
    kinds: Tuple[str, ...]  # empty = clean control (no faults)
    workload: str = "train"  # train | serve | request
    expected_layers: Tuple[str, ...] = ()  # layer values expected to flag
    clean_fraction: float = 0.4
    n_bursts: int = 3
    burst_fraction: float = 0.06  # burst length as a fraction of the run
    magnitudes: Optional[Dict[str, float]] = None

    def build_faults(self, n_steps: int) -> List[Fault]:
        """The deterministic schedule: kinds cycle across evenly spaced
        bursts (a mixed-fault scenario exercises each kind in turn)."""
        if not self.kinds:
            return []
        mags = dict(DEFAULT_MAGNITUDES)
        mags.update(self.magnitudes or {})
        live_lo = int(n_steps * self.clean_fraction)
        burst = max(2, int(n_steps * self.burst_fraction))
        gap = (n_steps - live_lo) // self.n_bursts
        faults = []
        for i in range(self.n_bursts):
            start = live_lo + i * gap + max(1, (gap - burst) // 2)
            kind = self.kinds[i % len(self.kinds)]
            faults.append(Fault(kind, start, min(start + burst, n_steps),
                                mags[kind]))
        return faults

    def injector(self, n_steps: int) -> FaultInjector:
        return FaultInjector(self.build_faults(n_steps))


_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    """Add (or override) a scenario in the registry, by name."""
    _SCENARIOS[scenario.name] = scenario
    return scenario


def scenario_names() -> List[str]:
    return sorted(_SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"no scenario registered under {name!r}; "
                       f"available: {', '.join(scenario_names())}") from None


# the builtin matrix: one scenario per paper fault family (train path), a
# mixed campaign, a clean control, and a serve-path variant of each kind that
# perturbs the decode loop (network faults need a collective schedule, which
# the single-host serve path does not run)
BUILTIN_SCENARIOS = [
    Scenario("clean_control",
             "no faults — measures the false-alarm floor",
             kinds=()),
    Scenario("latency_spike",
             "operator/software delay bursts (pytorchfi analogue)",
             kinds=("op_latency",), expected_layers=("operator", "step")),
    Scenario("runtime_stall",
             "runtime/kernel-level stalls (DCGM kernel-timeout analogue)",
             kinds=("xla_latency",), expected_layers=("xla", "step")),
    Scenario("straggler_host",
             "host-side stalls: GIL/input pipeline (real sleeps)",
             kinds=("python_latency",), expected_layers=("step",)),
    Scenario("degraded_device",
             "co-scheduled process steals the device (contention)",
             kinds=("hw_contention",), expected_layers=("device",)),
    Scenario("memory_leak",
             "device memory ramps while the fault is active",
             kinds=("mem_leak",), expected_layers=("device",),
             burst_fraction=0.1, n_bursts=2),
    Scenario("comm_slowdown",
             "network delay scales collective latencies (chaosblade delay)",
             kinds=("net_latency",), expected_layers=("collective", "step")),
    Scenario("packet_loss",
             "per-message drop probability inflates retransmits",
             kinds=("packet_loss",), expected_layers=("collective",),
             # the hardest scenario by construction: loss only perturbs the
             # dropped messages, so the per-step majority vote needs roughly
             # half the schedule retransmitting to trip
             magnitudes={"packet_loss": 0.45}),
    Scenario("mixed_fault",
             "operator, network, and device faults in one campaign",
             kinds=("op_latency", "net_latency", "hw_contention"),
             n_bursts=6,
             expected_layers=("operator", "collective", "device", "step")),
    Scenario("serve_latency_spike",
             "operator delay bursts against the decode loop",
             kinds=("op_latency",), workload="serve",
             expected_layers=("operator", "step")),
    Scenario("serve_runtime_stall",
             "kernel stalls against the decode loop",
             kinds=("xla_latency",), workload="serve",
             expected_layers=("xla", "step")),
    Scenario("serve_degraded_device",
             "device contention while serving",
             kinds=("hw_contention",), workload="serve",
             expected_layers=("device",)),
    # request-plane scenarios: the continuous-batching engine under a
    # deterministic multi-tenant load, judged by the SLO monitor (breach
    # incidents, kind="slo_breach") instead of the GMM detectors. Longer
    # bursts than the probe scenarios: queue pressure takes tens of steps
    # to build and drain, and the breach evidence trails the window.
    Scenario("serve_clean_control",
             "request plane under nominal load — the SLO false-alarm floor",
             kinds=(), workload="request"),
    Scenario("serve_tenant_flood",
             "one tenant floods admission; queue waits breach the SLO",
             kinds=("tenant_flood",), workload="request",
             expected_layers=("request",), n_bursts=2, burst_fraction=0.12),
    Scenario("serve_heavy_prompts",
             "oversized prompts monopolise prefill; TTFT breaches the SLO",
             kinds=("heavy_prompt_skew",), workload="request",
             expected_layers=("request",), n_bursts=2, burst_fraction=0.12),
    Scenario("serve_slow_clients",
             "clients stall token delivery; TPOT breaches the SLO",
             kinds=("slow_client_stall",), workload="request",
             expected_layers=("request",), n_bursts=2, burst_fraction=0.12),
]
for _s in BUILTIN_SCENARIOS:
    register_scenario(_s)

# the CI subset: fast, covers clean + a latency and a network fault
SMOKE_SCENARIOS = ("clean_control", "latency_spike", "comm_slowdown")
# the request-plane CI subset: the SLO clean floor + one breach scenario
SERVE_SMOKE_SCENARIOS = ("serve_clean_control", "serve_tenant_flood")
