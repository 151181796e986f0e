"""Run one labelled scenario through the Session API and keep the evidence
(port of `repro/eval/runner.py`).

Each cell of the scenario matrix is one monitored run:

    scenario (chaos schedule) x mode (batch | stream) x EvalConfig (detector)

The ``train`` workload is observed through `Session.observe_step_fn` (the
zero-instrumentation contract — the step code never changes): a synthetic
train step plus a registered all-reduce schedule, so every probe layer
produces events. Cheap enough that the full matrix runs on a laptop CPU; the
detectors only see probe events, so detection quality is
workload-size-independent (the faults are injected at the probe hooks,
exactly as in the paper's testbed).

On a CUDA device the synthetic step is captured once in a CUDA graph and
replayed (`GraphedSynthStep`), as the reference jits it into one executable:
eager, its launches would be paid for on the host, and the step time would
be the host's. On the CPU a cell's step (the synthetic step, the decode
loop, `run_model_cell`'s step) runs eagerly on one intra-op thread
(`one_cpu_thread`), as the reference's CPU executable runs it: spread over
torch's thread pool, each of its parallel regions waits for the slowest
thread, and on a loaded host a descheduled pool thread stretched steps of
~1 ms by tens of ms inside the clean prefix the detectors are fitted on.

The ``serve`` workload is the GPT-2 decode loop observed the same way, and
the ``request`` workload the continuous-batching engine on a virtual clock,
judged by the SLO plane. On the CPU both run the reduced GPT-2 in float32,
as the reference does; on a CUDA device the full-width GPT-2 124M in bf16,
its decode step replayed as a CUDA graph (`repro_torch.serve.GraphedStep`).

The run's first ``clean_fraction`` steps are fault-free by scenario
construction; stream mode warms up there, batch mode gets a matching holdoff
so its final refit trains on the same clean prefix. Metrics are scored only
on the live region after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chaos import Fault, Scenario
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.eval.metrics import (DetectionMetrics, DiagnosisMetrics,
                                      SLOBreachMetrics, debounce,
                                      detection_metrics, diagnosis_metrics,
                                      slo_breach_metrics, step_predictions)
from repro_torch.session import DetectorSpec, MonitorSpec, Session
from repro_torch.session.report import MonitorReport
from repro_torch.stream.incidents import IncidentMatch, match_incidents

EVAL_PROBES = ["xla", "operator", "collective", "device", "step"]

# request-workload cell: SLO targets and load shape, tuned so the nominal
# arrival process never breaches (the serve_clean_control scenario must
# close ZERO breach incidents) while each serve fault kind breaches its
# signature metric well clear of the target
SERVE_SLO = {"ttft_s": 0.4, "tpot_s": 0.08, "queue_wait_s": 0.2,
             "queue_depth": 8, "min_breaches": 6, "gap_s": 0.5,
             "close_after_s": 0.5}
SERVE_LOAD = {"rate": 0.18, "prompt_len": (4, 12), "max_new": (4, 8)}
SERVE_SLOTS = 4
SERVE_DT = 0.02  # virtual seconds per engine step
# breach rows lag the burst by a queue-drain, not just a flush interval
SERVE_GRACE_STEPS = 40

# a GPT-2-class DP all-reduce schedule for the synthetic workload (message
# sizes in the gradient-bucket range), so the collective probe has traffic
_FAKE_HLO = "\n".join(
    f"  %ar{i} = f32[{1 << (12 + i)}]{{0}} all-reduce(%g{i}), "
    "replica_groups={}" for i in range(8))

SYNTH_SHAPE = (192, 192)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """One detector configuration of the matrix (spec fields + scoring)."""

    name: str = "default"
    backend: str = "gmm"       # detector-registry family (the bake-off axis)
    # root-cause attribution is calibrated in GMM log-density nats (the
    # Diagnoser's min_mean_deficit floor); the other families' score scales
    # are not nats, so their deficits sit arbitrarily around the floor and
    # would diagnose (or not) on host timing noise. Family configs run
    # detection-only; blamed-kind quality is a GMM column.
    diagnosis: bool = True
    n_components: int = 3
    contamination: float = 0.02
    min_events: int = 32
    warm_start: bool = True
    sweep_every: int = 60     # batch refit cadence
    flush_every: int = 20     # stream tick cadence ("window" step width)
    horizon_s: float = 300.0  # stream sliding-window span
    device_interval: float = 0.005
    step_sleep: float = 0.002  # host pacing so device telemetry accumulates
    vote: float = 0.5          # per-layer per-step majority-vote fraction
    min_run: int = 3           # debounce: required consecutive flagged steps
    grace_steps: int = 20      # detection-lag allowance for time-to-detect

    def detector_spec(self, holdoff_steps: int, seed: int) -> DetectorSpec:
        return DetectorSpec(
            backend=self.backend,
            n_components=self.n_components,
            contamination=self.contamination,
            min_events=self.min_events, seed=seed,
            sweep_every=self.sweep_every, holdoff_steps=holdoff_steps,
            warm_start=self.warm_start, flush_every=self.flush_every,
            horizon_s=self.horizon_s,
            # synthetic runs compress a "fleet minute" into ~1 wall second,
            # so incident clustering runs at a matching time scale
            incident_gap_s=0.25, incident_close_after_s=0.25, min_flags=5,
            # scoring compares flags against per-step ground truth, so
            # sweeps must publish at the cadence point that snapshotted
            # them — the thread executor's staleness would smear flags
            # across label windows and make cells runner-load dependent
            executor="inline")


@dataclasses.dataclass
class ScenarioRun:
    """One matrix cell: the report plus everything needed to score it."""

    scenario: Scenario
    mode: str
    config: EvalConfig
    n_steps: int
    eval_start: int
    labels: np.ndarray
    windows: List[Tuple[int, int]]
    faults: List[Fault]
    step_ts: np.ndarray
    report: MonitorReport
    wall_s: float

    def predictions(self) -> Dict[str, np.ndarray]:
        return step_predictions(self.report.detections, self.n_steps,
                                vote=self.config.vote)

    def metrics(self) -> DetectionMetrics:
        pred = debounce(self.predictions()["any"], self.config.min_run)
        return detection_metrics(
            pred, self.labels, self.windows,
            eval_start=self.eval_start, grace_steps=self.config.grace_steps,
            step_ts=self.step_ts)

    def incident_match(self, grace_steps: int = 4) -> Optional[IncidentMatch]:
        if self.mode != "stream" or not self.windows:
            return None
        return match_incidents(self.report.incidents, self.windows,
                               grace_steps=grace_steps)

    def slo_metrics(self, grace_steps: int = SERVE_GRACE_STEPS
                    ) -> SLOBreachMetrics:
        """Request-plane scoring: breach incidents vs serve fault windows."""
        return slo_breach_metrics(self.report.incidents, self.windows,
                                  grace_steps=grace_steps)

    def diagnosis_metrics(self, grace_steps: Optional[int] = None
                          ) -> DiagnosisMetrics:
        """Blamed-kind / blamed-node / action-match scoring of the report's
        diagnoses against the injected schedule (single-node runs: every
        fault perturbs node 0; request runs: the flood tenant is tenant 0).
        The step layer's detections double as the collector-clock step
        mapping for step-less (device) diagnoses."""
        from repro_torch.core.events import Layer

        if grace_steps is None:
            grace_steps = (SERVE_GRACE_STEPS
                           if self.scenario.workload == "request" else 4)

        clock = None
        det = self.report.detections.get(Layer.STEP)
        if det is not None and getattr(det, "ts", None) is not None:
            clock = (np.asarray(det.steps), np.asarray(det.ts))
        return diagnosis_metrics(self.report.diagnoses, self.faults,
                                 grace_steps=grace_steps, fault_nodes=(0,),
                                 step_clock=clock)


# -- workloads ----------------------------------------------------------------

def _synth_iter(x: torch.Tensor) -> torch.Tensor:
    """One of `_synth_step`'s four normalised products."""
    return (x @ torch.sin(x)) / torch.clamp_min(x.abs().sum(), 1.0)


@contextlib.contextmanager
def one_cpu_thread(device: torch.device):
    """On the CPU, torch's intra-op parallelism is 1 for the block (the
    process's setting comes back after it); elsewhere nothing changes."""
    threads = torch.get_num_threads()
    if device.type != "cpu" or threads == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _synth_step(x: torch.Tensor) -> torch.Tensor:
    # a few ms of real compute per step on a CPU: long enough that host
    # scheduler jitter (absolute, ~100s of us) is small relative to the
    # baseline duration in log space, short enough that the full matrix
    # stays cheap
    for _ in range(4):
        x = _synth_iter(x)
    return x


class GraphedSynthStep:
    """`_synth_step` captured in one CUDA graph and replayed on CUDA
    tensors; any other tensor (the CPU, or the operator probe's meta copy)
    runs it eagerly.

    The first call on the card runs the step eagerly on the caller's
    stream (lazy library set-up must not happen during capture), then
    captures it on a static input buffer. Every call copies its input into
    that buffer
    (unless it is the graph's own output of the last call, which the copy
    then reads) and replays; the returned tensor is the graph's output
    buffer, overwritten by the next replay."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._in: Optional[torch.Tensor] = None
        self._out: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return _synth_step(x)
        if self.graph is None:
            self._in = x.clone()
            _synth_step(self._in)  # on the caller's stream, as CudaGraphed
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self._out = _synth_step(self._in)
        if x.shape != self._in.shape or x.dtype != self._in.dtype:
            raise ValueError(f"input {tuple(x.shape)} {x.dtype}; the graph "
                             f"was captured at {tuple(self._in.shape)} "
                             f"{self._in.dtype}")
        self._in.copy_(x)
        self.graph.replay()
        return self._out


@functools.lru_cache(maxsize=2)
def _model_parts(device_type: str):
    """The serve and request workloads' model, built once per process and
    device type: the reduced GPT-2 in float32 on the CPU (the reference's),
    the full-width GPT-2 124M in bf16 on a CUDA device; weights from seed
    0."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.models.model import Runtime, init_params

    cfg = get_arch("gpt2")
    if device_type == "cpu":
        cfg, dtype = reduced(cfg), torch.float32
    else:
        dtype = torch.bfloat16
    params = init_params(cfg, seed=0, device=device_type)
    return cfg, Runtime(compute_dtype=dtype), params


def _serve_parts(device: DeviceLike = None):
    """The decode-step workload: (cfg, params, step, make_caches), the step
    ``(params, {"tokens": host (B, 1)}, caches, index) -> (logits,
    caches)`` replayed as a CUDA graph on the card."""
    from repro_torch.models.model import init_decode_caches
    from repro_torch.serve.engine import GraphedStep, make_decode_step

    dev = resolve_device(device)
    cfg, rt, params = _model_parts(dev.type)
    decode = make_decode_step(cfg, rt)
    graphed = GraphedStep(lambda p, caches, tokens, index:
                          decode(p, {"tokens": tokens}, caches, index))

    def step(p, batch, caches, index):
        return graphed(p, caches, batch["tokens"], index)

    return cfg, params, step, functools.partial(init_decode_caches, cfg,
                                                device=dev)


def _request_parts(device: DeviceLike = None):
    """The continuous-batching workload's (cfg, rt, params)."""
    return _model_parts(resolve_device(device).type)


def run_scenario(scenario: Scenario, mode: str,
                 config: Optional[EvalConfig] = None,
                 n_steps: int = 240, seed: int = 0,
                 device: DeviceLike = None) -> ScenarioRun:
    """Execute one scenario under one mode/config; returns the scored run.
    The step and the detectors run on ``device`` (``cuda`` unless the CPU
    is asked for)."""
    cfg = config or EvalConfig()
    if mode not in ("batch", "stream"):
        raise ValueError(f"mode must be batch|stream, got {mode!r}")
    dev = resolve_device(device)
    eval_start = int(n_steps * scenario.clean_fraction)
    injector = scenario.injector(n_steps)
    labels = injector.labels(n_steps)
    session = Session(scenario_spec(scenario, mode, n_steps, cfg, seed),
                      device=dev)
    runner = {"train": _run_train_steps, "serve": _run_serve_steps,
              "request": _run_request_steps}[scenario.workload]
    t0 = time.perf_counter()
    step_ts = runner(session, injector, n_steps, eval_start, cfg, seed)
    wall = time.perf_counter() - t0
    return ScenarioRun(
        scenario=scenario, mode=mode, config=cfg, n_steps=n_steps,
        eval_start=eval_start, labels=labels, windows=injector.windows(),
        faults=list(injector.faults), step_ts=step_ts,
        report=session.result(), wall_s=wall)


def scenario_spec(scenario: Scenario, mode: str, n_steps: int,
                  cfg: EvalConfig, seed: int = 0) -> MonitorSpec:
    """A cell's spec: the eval probes, the device probe's interval, and the
    detector held off over the scenario's clean prefix. A request cell is
    SLO-thresholded, not GMM-modelled: only the request probe attaches and
    the detector spec is irrelevant."""
    if scenario.workload == "request":
        return MonitorSpec(mode=mode, probes=["request"],
                           slo=dict(SERVE_SLO), governor=False, seed=seed)
    eval_start = int(n_steps * scenario.clean_fraction)
    return MonitorSpec(
        mode=mode, probes=list(EVAL_PROBES),
        probe_options={"device": {"interval": cfg.device_interval}},
        detector=cfg.detector_spec(holdoff_steps=n_steps - eval_start,
                                   seed=seed),
        diagnosis=cfg.diagnosis, governor=False, seed=seed)


def run_model_cell(session: Session, scenario: Scenario, n_steps: int,
                   cfg: EvalConfig, step_fn, state, data
                   ) -> Tuple[ScenarioRun, object, List[dict]]:
    """One cell of ``scenario`` around a model's train step ``step_fn(state,
    batch) -> (state, metrics)``, batch ``s`` being ``data.batch(s)`` on
    the session's device: driven as `run_scenario` drives the synthetic
    step (`_FAKE_HLO`, the observed step, `_drive`), under a session built
    from `scenario_spec`. The step's set-up calls (a graph's capture) are
    the caller's, made before. Returns the scored run, the state after it
    and each step's metrics."""
    from repro_torch.models.model import batch_to_device

    dev = session.device
    eval_start = int(n_steps * scenario.clean_fraction)
    injector = scenario.injector(n_steps)
    metrics: List[dict] = []
    t0 = time.perf_counter()
    with one_cpu_thread(dev), session.monitoring():
        session.collector["collective"].register_compiled(_FAKE_HLO)
        fn = session.observe_step_fn(
            step_fn, sample_args=(state, data.batch(0)), mem_gb=0.5)

        def one_step(s):
            nonlocal state
            state, m = fn(state, batch_to_device(data.batch(s), dev))
            metrics.append(m)

        step_ts = _drive(session, injector, n_steps, eval_start, cfg,
                         one_step)
    run = ScenarioRun(
        scenario=scenario, mode=session.spec.mode, config=cfg,
        n_steps=n_steps, eval_start=eval_start,
        labels=injector.labels(n_steps), windows=injector.windows(),
        faults=list(injector.faults), step_ts=step_ts,
        report=session.result(), wall_s=time.perf_counter() - t0)
    return run, state, metrics


def _drive(session: Session, injector, n_steps: int, eval_start: int,
           cfg: EvalConfig, one_step) -> np.ndarray:
    """The shared monitored loop: inject, step, hand cadence to the session.
    Stream warmup fires exactly at the end of the clean prefix."""
    col = session.collector
    step_ts = np.zeros(n_steps)
    t0 = time.perf_counter()
    stream = session.spec.mode == "stream"
    for s in range(n_steps):
        if stream and s == eval_start:
            session.warmup()
        injector.apply(s, col)
        step_ts[s] = time.perf_counter() - t0
        one_step(s)
        if cfg.step_sleep:
            time.sleep(cfg.step_sleep)
        if not stream or s >= eval_start:
            session.on_step(s)
    injector.clear(col)
    time.sleep(3 * cfg.device_interval)  # last device samples land
    return step_ts


def _run_train_steps(session: Session, injector, n_steps: int,
                     eval_start: int, cfg: EvalConfig, seed: int
                     ) -> np.ndarray:
    x0 = torch.ones(SYNTH_SHAPE, device=session.device) * (1.0 + 0.01 * seed)
    step = GraphedSynthStep()
    with one_cpu_thread(x0.device):
        step(x0)  # capture outside the probes (the reference compiles there)
        if x0.device.type == "cuda":
            torch.cuda.synchronize(x0.device)
        with session.monitoring():
            session.collector["collective"].register_compiled(_FAKE_HLO)
            fn = session.observe_step_fn(step, sample_args=(x0,),
                                         mem_gb=0.5)
            state = {"x": x0}

            def one_step(s):
                state["x"] = fn(state["x"])

            return _drive(session, injector, n_steps, eval_start, cfg,
                          one_step)


def _run_serve_steps(session: Session, injector, n_steps: int,
                     eval_start: int, cfg: EvalConfig, seed: int
                     ) -> np.ndarray:
    """The decode loop at batch 2: each step's greedy token fed back."""
    model_cfg, params, step, make_caches = _serve_parts(session.device)
    batch_size = 2
    caches = make_caches(batch_size, n_steps + 1)
    tok0 = np.ones((batch_size, 1), np.int32)
    with one_cpu_thread(session.device):
        # the first calls outside the probes (the reference compiles there;
        # the graph is captured on the third, over these caches: rows they
        # leave behind are rewritten at their position before it turns
        # valid)
        for i in range(3):
            step(params, {"tokens": tok0}, caches, i)
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)
        state = {"tok": tok0, "caches": caches}
        with session.monitoring():
            fn = session.observe_step_fn(
                step, sample_args=(params, {"tokens": tok0}, caches, 0),
                mem_gb=0.5)

            def one_step(s):
                logits, state["caches"] = fn(params, {"tokens": state["tok"]},
                                             state["caches"], s)
                nxt = logits[:, -1, : model_cfg.vocab_size].argmax(-1)
                state["tok"] = nxt.to(torch.int32).cpu().numpy()[:, None]

            return _drive(session, injector, n_steps, eval_start, cfg,
                          one_step)


def _run_request_steps(session: Session, injector, n_steps: int,
                       eval_start: int, cfg: EvalConfig, seed: int
                       ) -> np.ndarray:
    """Continuous-batching engine under deterministic load; serve faults
    perturb the arrival mix via ``injector.serve_faults``. The engine runs
    a `VirtualClock`, so every latency is a pure function of scheduling and
    the cell is reproducible bit-for-bit from ``seed``."""
    from repro_torch.serve import (ContinuousBatchingEngine, LoadGenerator,
                                   VirtualClock)

    model_cfg, rt, params = _request_parts(session.device)
    eng = ContinuousBatchingEngine(
        model_cfg, rt, params, slots=SERVE_SLOTS, max_len=n_steps + 96,
        seed=seed, clock=VirtualClock(SERVE_DT), dtype=torch.float32)
    load = LoadGenerator(rate=SERVE_LOAD["rate"], seed=seed,
                         prompt_len=SERVE_LOAD["prompt_len"],
                         max_new=SERVE_LOAD["max_new"],
                         vocab_size=model_cfg.vocab_size)
    with session.monitoring():
        eng.run(load, n_steps=n_steps,
                faults_for_step=injector.serve_faults,
                on_step=lambda s: session.on_step(s), drain=False)
    return np.arange(n_steps, dtype=np.float64) * SERVE_DT
