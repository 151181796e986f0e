"""eACGM quickstart on PyTorch: monitor a GPT-2 training job with zero code
changes, inject labelled faults, detect them with per-layer GMMs fitted on
the card, and let the governor act. The port's counterpart of
``examples/quickstart.py`` and the main path of the port.

Run:  PYTHONPATH=src python -m repro_torch.quickstart
          [--mode batch|stream|fleet] [--reduced] [--device cpu|cuda]
          [--steps N]

The defaults are full-width GPT-2 (124M: 12 layers, d_model 768, 12 heads,
vocab 50257 padded to 50304) in bf16, batch 8, sequence 128, on ``cuda``.
``--reduced`` is the 2-layer CPU-sized model in float32.

``--mode batch`` (the default, `run`, 120 steps):

1. an ordinary training setup — nothing in it knows about monitoring;
2. the collector attaches at runtime (the CUDA-runtime, operator,
   collective, device and step probes, as the JAX package's quickstart has
   them), wraps the step callable and reads its operator stream off one
   meta-tensor run of the step;
3. the fault injector perturbs the probes (pytorchfi/chaosblade analogues);
4. a FullStackMonitor fits one GMM per layer on the fault-free steps and
   flags every event (Definition 1) — the ``gmm_score`` and ``gmm_best``
   kernels on the card;
5. the Governor proposes actions.

``--mode stream`` (`run_stream`, 240 steps) is the paper's online mode: a
StreamMonitor ships the collector's events over the wire into sliding
windows, fits warm-started GMMs at the end of the clean prefix, detects on a
cadence while the job trains, and groups the flags into incidents, which are
matched against the ``latency_spike`` scenario's fault windows — all four
GMM kernels on the card (``gmm_update``, ``gmm_stats``, ``gmm_best``,
``gmm_score``).

``--mode fleet`` (`run_fleet`) is the port's counterpart of
``examples/fleet_demo.py``: a `Session` built from the reference's
``examples/fleet_spec.json`` values drives 8 nodes in groups of 4 through
the hierarchical fleet plane (node -> group -> fleet). Each node trains its
own GPT-2 (model, AdamW and CUDA graph of its own); node 1 suffers an
operator-latency fault mid-run. Every group fits and scores its own GMMs on
the card, and the fleet tier merges the groups' flags into one incident
stream with per-node attribution.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import TrainConfig, get_arch, reduced
from repro_torch.core import Collector, FaultInjector, FullStackMonitor, Governor
from repro_torch.core.chaos import Fault, get_scenario
from repro_torch.core.events import LAYER_CODE, Layer, select_columns
from repro_torch.core.probes.device_probe import H100_POWER_LIMIT_W
from repro_torch.data import SyntheticLMData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Runtime, batch_to_device
from repro_torch.session import MonitorSpec, Session
from repro_torch.stream import (OnlineGMMDetector, StreamMonitor,
                                match_incidents)
from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                    make_train_step)

DEVICE_INTERVAL = 0.01  # device probe polling, seconds
SETUP_STEPS = 3  # stream mode: steps run before the collector attaches
FLUSH_EVERY = 20  # stream mode: steps between detection ticks
N_COMPONENTS = 3  # GMM components of both detectors (fewer on small layers)
# fleet mode: examples/fleet_demo.py's shape and schedule
FLEET_NODES = 8
FLEET_WARMUP_STEPS = 80
FLEET_LIVE_STEPS = 160
FLEET_FAULT_NODE = 1
FLEET_FAULT = (60, 100)  # live-phase steps of the injected fault
FLEET_OP_LATENCY_S = 0.02


def probe_counts(probe) -> Dict[str, int]:
    """The runtime probe's rows and the calls it dropped inside a detection
    zone."""
    return {"rows": probe.emitted, "dropped_in_zone": probe.dropped_in_zone}


def _workload(reduced_model: bool, dev, steps: int, seed: int = 0):
    """The monitored job: GPT-2 (full width in bf16, batch 8, sequence 128;
    or the reduced model in float32, batch 4, sequence 32), AdamW, its
    state and its (CUDA-graphed on the card) train step; weights and data
    from ``seed``."""
    cfg = get_arch("gpt2")
    if reduced_model:
        cfg = reduced(cfg)
    batch, seq = (4, 32) if reduced_model else (8, 128)
    rt = Runtime(compute_dtype=torch.float32 if reduced_model
                 else torch.bfloat16)
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                         total_steps=steps, warmup_steps=5),
                             cfg)
    data = SyntheticLMData(cfg, seq_len=seq, global_batch=batch, seed=seed)
    state = init_train_state(cfg, opt, seed=seed, device=dev)
    return batch, seq, data, state, make_train_step(cfg, rt, opt)


def run(*, reduced_model: bool = False, device: DeviceLike = None,
        steps: int = 120, peak_w: float = H100_POWER_LIMIT_W,
        log_every: int = 0) -> Dict[str, Any]:
    """Train with the monitor attached, then detect and govern. Returns the
    losses, the per-layer detection results, the STEP layer's hit and false
    rates against the injected windows, the governor's actions and timings,
    and the run's event columns beside each step's fault label."""
    dev = resolve_device(device)
    batch, seq, data, state, step_fn = _workload(reduced_model, dev, steps)

    collector = Collector.standard(with_python=False,
                                   device_interval=DEVICE_INTERVAL,
                                   peak_w=peak_w)
    injector = FaultInjector.random_schedule(
        steps, ["op_latency"], seed=7, anomaly_fraction=1 / 6,
        magnitudes={"op_latency": 0.03})
    losses = []
    with collector.monitoring():
        # the operator probe's one meta-tensor run of the step: set-up, not
        # a training step, so outside the timed loop
        t_register = time.perf_counter()
        fn = collector.observe_step_fn(step_fn,
                                       sample_args=(state, data.batch(0)))
        t_train = time.perf_counter()
        register_s = t_train - t_register
        for s in range(steps):
            injector.apply(s, collector)
            state, metrics = fn(state, batch_to_device(data.batch(s), dev))
            losses.append(metrics["loss"])
            if log_every and s % log_every == 0:
                print(f"step {s:4d} loss {float(metrics['loss']):.4f}",
                      flush=True)
        injector.clear(collector)
    train_s = time.perf_counter() - t_train
    losses = torch.stack(losses).float().cpu().numpy()

    cols = collector.drain_columns()
    labels = injector.labels(steps)
    step_col = cols["step"]
    clean = (step_col >= 0) & (step_col < steps)
    clean[clean] = ~labels[step_col[clean]]
    t_detect = time.perf_counter()
    monitor = FullStackMonitor(n_components=N_COMPONENTS, min_events=32,
                               device=dev)
    monitor.fit(select_columns(cols, clean))
    results = monitor.detect(cols)
    detect_s = time.perf_counter() - t_detect

    true_steps = set(np.nonzero(labels)[0].tolist())
    is_step = cols["layer"] == LAYER_CODE[Layer.STEP]
    step_ms = {}
    for label, sel in (("clean", ~labels), ("faulty", labels)):
        rows = is_step & np.isin(step_col, np.nonzero(sel)[0])
        if rows.any():
            step_ms[label] = np.percentile(1e3 * cols["dur"][rows],
                                           [10, 50, 90]).tolist()
    rates = {}
    for layer, res in results.items():
        flagged = set(res.anomalous_steps().tolist())
        rates[layer.value] = (
            len(flagged & true_steps) / max(len(true_steps), 1),
            len(flagged - true_steps) / max(steps - len(true_steps), 1))
    actions = Governor(rate_threshold=0.05).decide(results)
    shapes = {layer.value: (len(results[layer].scores),
                            *det.gmm.params.means.shape[::-1])
              for layer, det in monitor.detectors.items() if layer in results}
    return {
        "device": str(dev), "steps": steps, "batch": batch, "seq": seq,
        "losses": losses, "steps_per_s": steps / train_s,
        "register_s": register_s,
        "detect_s": detect_s, "n_events": int(cols["ts"].shape[0]),
        "results": results, "rates": rates,
        "step_hit_rate": rates.get(Layer.STEP.value, (0.0, 0.0))[0],
        "step_false_rate": rates.get(Layer.STEP.value, (0.0, 0.0))[1],
        "actions": actions, "layer_shapes": shapes,
        "step_ms_p10_p50_p90": step_ms,
        "rows_per_layer": {layer.value: int((cols["layer"]
                                             == LAYER_CODE[layer]).sum())
                           for layer in Layer},
        "runtime_probe": probe_counts(collector["xla"]),
        "failed_samples": collector["device"].failed_samples,
        # the run's rows and step labels, for detectors fitted afterwards
        "columns": cols, "labels": labels,
    }


def run_stream(*, reduced_model: bool = False, device: DeviceLike = None,
               steps: int = 240, peak_w: float = H100_POWER_LIMIT_W,
               log_every: int = 0) -> Dict[str, Any]:
    """Train with a StreamMonitor attached and detect while training: the
    port's counterpart of the JAX package's stream-mode training loop
    (`repro/eval/runner.py::_drive` over the session's stream cadence).

    The ``latency_spike`` scenario injects three op_latency bursts after its
    clean prefix (40% of the run). The step's first ``SETUP_STEPS`` calls
    (the CUDA-graph capture, cuBLAS's and the allocator's first use:
    hundreds of ms each on the card) run before the collector attaches, as the
    reference compiles its step outside the probes; in the clean prefix
    they would be outliers the models spend a component on. Unlike the
    reference's compile call, these calls also train (a graphed step is
    bound to the state it captured, so it cannot warm on a copy): the run
    takes ``steps + SETUP_STEPS`` optimizer steps and sees batches
    0..``SETUP_STEPS - 1`` twice. The monitor
    fits its models exactly at the end of the clean prefix, ticks every
    ``FLUSH_EVERY`` steps after it, and closes the run with ``finish()``.
    Detector and incident settings are the JAX package's stream evaluation
    settings (``EvalConfig``): K=3, contamination 0.02, min_events 32, a
    300 s horizon, incident gap and close 0.25 s, min_flags 5, seed 0.
    Returns the losses, the ranked incidents, their match against the fault
    windows (grace ``FLUSH_EVERY`` steps), each tick's refit mode per layer,
    the monitor's stats and timings (``setup_ms``: each set-up call's wall
    time)."""
    dev = resolve_device(device)
    batch, seq, data, state, step_fn = _workload(reduced_model, dev, steps)
    scenario = get_scenario("latency_spike")
    injector = scenario.injector(steps)
    eval_start = int(steps * scenario.clean_fraction)

    collector = Collector.standard(with_python=False,
                                   device_interval=DEVICE_INTERVAL,
                                   peak_w=peak_w)
    detector = OnlineGMMDetector(n_components=N_COMPONENTS,
                                 contamination=0.02, min_events=32, seed=0,
                                 device=dev)
    mon = StreamMonitor(horizon_s=300.0, incident_gap_s=0.25,
                        incident_close_after_s=0.25, min_flags=5,
                        detector=detector)
    mon.register_node(0, collector)
    setup_ms = []
    for s in range(SETUP_STEPS):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch_to_device(data.batch(s), dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_ms.append(1e3 * (time.perf_counter() - t0))
    losses, modes = [], []
    with collector.monitoring():
        # the operator probe's one meta-tensor run of the step: set-up, not
        # a training step, so outside the timed loop
        t_register = time.perf_counter()
        fn = collector.observe_step_fn(step_fn,
                                       sample_args=(state, data.batch(0)))
        t_train = time.perf_counter()
        register_s = t_train - t_register
        for s in range(steps):
            if s == eval_start:
                mon.warmup()
            injector.apply(s, collector)
            state, metrics = fn(state, batch_to_device(data.batch(s), dev))
            losses.append(metrics["loss"])
            if s > eval_start and s % FLUSH_EVERY == 0:
                mon.tick()
                modes.append({layer.value: det.refit for layer, det
                              in mon.last_detections.items()})
            if log_every and s % log_every == 0:
                print(f"step {s:4d} loss {float(metrics['loss']):.4f}",
                      flush=True)
        injector.clear(collector)
        time.sleep(3 * DEVICE_INTERVAL)  # the last device samples land
        mon.finish()
        modes.append({layer.value: det.refit
                      for layer, det in mon.last_detections.items()})
    train_s = time.perf_counter() - t_train
    losses = torch.stack(losses).float().cpu().numpy()

    stats = mon.stats()
    agents = stats["agents"].values()
    shipped = sum(a["events_shipped"] for a in agents)
    incidents = mon.incidents
    return {
        "device": str(dev), "steps": steps, "batch": batch, "seq": seq,
        "losses": losses, "steps_per_s": steps / train_s,
        "register_s": register_s,
        "setup_ms": setup_ms, "incidents": incidents,
        "match": match_incidents(incidents, injector.windows(),
                                 grace_steps=FLUSH_EVERY),
        "windows": injector.windows(), "tick_modes": modes,
        "ticks": stats["ticks"],
        "detect_ms_per_tick": stats["detect_ms_per_tick"],
        "refits": {layer: {"warm": d["warm_refits"],
                           "cold": d["cold_refits"]}
                   for layer, d in stats["detector"].items()},
        "events_ingested": stats["aggregator"]["events_ingested"],
        "wire_bytes_per_event": (sum(a["bytes_shipped"] for a in agents)
                                 / max(shipped, 1)),
        "lost_batches": stats["aggregator"]["lost_batches"],
        "window_sizes": stats["aggregator"]["window_sizes"],
        "runtime_probe": probe_counts(collector["xla"]),
        "failed_samples": collector["device"].failed_samples,
    }


def fleet_spec(report_path: str = "results/fleet_report.json",
               topology: Optional[Dict[str, Any]] = None) -> MonitorSpec:
    """The reference's ``examples/fleet_spec.json``: stream mode; probes
    xla, operator, collective, device (every 0.01 s) and step; K=3,
    contamination 0.02, min_events 64, a tick every 16 steps, a 120 s
    horizon, incident gap and close-after 0.5 s, min_flags 6, seed 0, the
    inline executor; no governor; 4 nodes a group under a fan-in of 32. Its
    ``prometheus`` and ``board`` sinks wait for the obs slice of the port,
    so only the ``report`` sink is kept. ``topology`` replaces the topology
    section (e.g. to arm the backpressure governor)."""
    return MonitorSpec.from_dict({
        "mode": "stream",
        "probes": ["xla", "operator", "collective", "device", "step"],
        "probe_options": {"device": {"interval": 0.01}},
        "detector": {"backend": "gmm", "n_components": 3,
                     "contamination": 0.02, "min_events": 64,
                     "flush_every": 16, "horizon_s": 120.0,
                     "incident_gap_s": 0.5, "incident_close_after_s": 0.5,
                     "min_flags": 6, "seed": 0, "executor": "inline"},
        "sinks": [{"kind": "report", "path": report_path}],
        "governor": False,
        "topology": topology or {"group_size": 4, "fan_in": 32},
        "seed": 0})


class _FleetNode:
    """One simulated worker: a session node with its own GPT-2, AdamW state,
    data and (on the card) CUDA-graphed step."""

    def __init__(self, session: Session, node_id: int, reduced_model: bool,
                 dev, steps: int):
        self.node_id = node_id
        self.handle = session.node(node_id)
        (self.batch, self.seq, self.data, self.state,
         self.step_fn) = _workload(reduced_model, dev, steps, seed=node_id)
        self.fn = self.step_fn
        self.losses = []

    def step(self, s: int, dev) -> None:
        self.state, metrics = self.fn(
            self.state, batch_to_device(self.data.batch(s), dev))
        self.losses.append(metrics["loss"])


def run_fleet(*, reduced_model: bool = False, device: DeviceLike = None,
              nodes: int = FLEET_NODES,
              warmup_steps: int = FLEET_WARMUP_STEPS,
              live_steps: int = FLEET_LIVE_STEPS,
              fault_s: float = FLEET_OP_LATENCY_S,
              topology: Optional[Dict[str, Any]] = None,
              report_path: str = "results/fleet_report.json",
              log_every: int = 0) -> Dict[str, Any]:
    """The fleet demo on the port (`examples/fleet_demo.py`): ``nodes``
    workers in groups of 4 (`fleet_spec`), each training its own GPT-2,
    monitored through one `Session` with a hierarchical topology. The
    step's first ``SETUP_STEPS`` calls run on every node before the
    collectors attach (see `run_stream`). ``warmup_steps`` clean steps on
    every node, then ``session.warmup()`` fits every group's baselines; the
    run waits (a tick's worth of clean steps at a time, at most
    ``warmup_steps`` more) until every group has warmed. Then
    ``live_steps`` steps, with ``session.tick()`` every ``flush_every``
    steps and an op_latency fault of ``fault_s`` seconds on node 1 over the
    live steps ``FLEET_FAULT`` (``fault_s=0``: no fault). Returns the
    losses per node, steps/s of the live phase (one step on every node a
    fleet step), the groups and their members, the incidents and those
    that hold node 1 over the fault's steps, the monitor's stats (tier
    seconds, shed and lost accounting), runtime rows and failed device
    samples per node, and the card's peak memory."""
    dev = resolve_device(device)
    spec = fleet_spec(report_path, topology)
    flush_every = spec.detector.flush_every
    steps = SETUP_STEPS + 2 * warmup_steps + live_steps
    session = Session(spec, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fleet = {nid: _FleetNode(session, nid, reduced_model, dev, steps)
             for nid in range(nodes)}
    for node in fleet.values():
        for s in range(SETUP_STEPS):
            node.state, _ = node.step_fn(
                node.state, batch_to_device(node.data.batch(s), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lo, hi = FLEET_FAULT
    injector = FaultInjector([Fault("op_latency", lo, hi, fault_s)]
                             if fault_s else [])
    faulty = fleet.get(FLEET_FAULT_NODE)
    mon = session.detector.monitor
    step = 0

    def fleet_step(live_s: Optional[int] = None) -> None:
        nonlocal step
        for node in fleet.values():
            if node is faulty and live_s is not None:
                injector.apply(live_s, node.handle.collector)
            node.step(step, dev)
        if log_every and step % log_every == 0:
            print(f"step {step:4d} loss "
                  f"{float(fleet[0].losses[-1]):.4f}", flush=True)
        step += 1

    with session.monitoring():
        t_register = time.perf_counter()
        for node in fleet.values():
            node.fn = node.handle.observe_step_fn(
                node.step_fn, sample_args=(node.state, node.data.batch(0)))
        register_s = time.perf_counter() - t_register
        t_warm = time.perf_counter()
        for _ in range(warmup_steps):
            fleet_step()
        warmed = [layer.value for layer in session.warmup()]
        extra = 0
        while (not all(g.warmed for g in mon.groups.values())
               and extra < warmup_steps):
            for _ in range(flush_every):
                fleet_step()
            extra += flush_every
            warmed += [layer.value for layer in session.warmup()]
        warm_s = time.perf_counter() - t_warm
        first_live = step
        t_live = time.perf_counter()
        for s in range(live_steps):
            fleet_step(live_s=s)
            if (s + 1) % flush_every == 0:
                session.tick()
        if faulty is not None:
            injector.clear(faulty.handle.collector)
        live_s = time.perf_counter() - t_live
        time.sleep(3 * DEVICE_INTERVAL)  # the last device samples land
    report = session.result()
    stats = mon.stats()
    # hits answer an injected fault: with none, a clean run's incident that
    # happens to fall on the fault's steps is no hit
    fault_steps = (set(range(first_live + lo, first_live + hi)) if fault_s
                   else set())
    hits = [i for i in report.incidents
            if FLEET_FAULT_NODE in i.suspect_nodes
            and fault_steps & set(i.steps)]
    losses = {nid: torch.stack(node.losses).float().cpu().numpy()
              for nid, node in fleet.items()}
    collectors = {nid: node.handle.collector for nid, node in fleet.items()}
    return {
        "device": str(dev), "nodes": nodes, "batch": fleet[0].batch,
        "seq": fleet[0].seq, "losses": losses,
        "warmup_steps": warmup_steps, "extra_warmup_steps": extra,
        "live_steps": live_steps, "first_live_step": first_live,
        "fault_steps": (first_live + lo, first_live + hi) if fault_s
        else None,
        "register_s": register_s, "warmup_s": warm_s, "live_s": live_s,
        "steps_per_s": live_steps / live_s,
        "node_steps_per_s": nodes * live_steps / live_s,
        "warmed_layers": sorted(set(warmed)),
        "groups": {gid: {"nodes": g.nodes(), "warmed": g.warmed}
                   for gid, g in sorted(mon.groups.items())},
        "incidents": sorted(report.incidents, key=lambda i: -i.severity),
        "hits": hits, "report": report, "stats": stats,
        "runtime_rows": {nid: probe_counts(c["xla"])
                         for nid, c in collectors.items()},
        "failed_samples": {nid: c["device"].failed_samples
                           for nid, c in collectors.items()},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="batch",
                    choices=("batch", "stream", "fleet"))
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer d_model-64 GPT-2 in float32 (CPU-sized)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 120 batch, 240 stream; "
                         "fleet: live steps, default 160)")
    args = ap.parse_args(argv)
    if args.mode == "stream":
        return _main_stream(args)
    if args.mode == "fleet":
        return _main_fleet(args)
    out = run(reduced_model=args.reduced, device=args.device,
              steps=args.steps or 120, log_every=30)
    print(f"\ntrained {out['steps']} steps at {out['steps_per_s']:.2f} "
          f"steps/s on {out['device']}; collected {out['n_events']} events; "
          f"detection took {out['detect_s']:.3f} s")
    for layer, res in out["results"].items():
        hit, false = out["rates"][layer.value]
        print(f"  {layer.value:11s}: {len(res.flags):5d} events, "
              f"anomaly rate {res.anomaly_rate:.2f}, hit rate {hit:.2f}, "
              f"false rate {false:.2f}")
    for action in out["actions"]:
        print(f"[governor] {action.kind}: {action.reason}")
    return 0 if math.isfinite(float(out["losses"][-1])) else 1


def _main_stream(args) -> int:
    out = run_stream(reduced_model=args.reduced, device=args.device,
                     steps=args.steps or 240, log_every=30)
    m = out["match"]
    print(f"\ntrained {out['steps']} steps at {out['steps_per_s']:.2f} "
          f"steps/s on {out['device']}; {out['events_ingested']} events "
          f"over the wire at {out['wire_bytes_per_event']:.1f} B/event; "
          f"{out['ticks']} detection ticks at "
          f"{out['detect_ms_per_tick']:.1f} ms/tick")
    for layer, r in out["refits"].items():
        print(f"  {layer:11s}: {r['warm']} warm / {r['cold']} cold refits")
    for inc in out["incidents"]:
        print(inc.render())
    print(f"fault windows {out['windows']}: recall {m.recall:.2f}, "
          f"precision {m.precision:.2f}")
    return 0 if math.isfinite(float(out["losses"][-1])) else 1


def _main_fleet(args) -> int:
    out = run_fleet(reduced_model=args.reduced, device=args.device,
                    live_steps=args.steps or FLEET_LIVE_STEPS, log_every=40)
    stats = out["stats"]
    print(f"\n{out['nodes']} nodes in {len(out['groups'])} group(s): "
          f"{out['steps_per_s']:.2f} fleet steps/s "
          f"({out['node_steps_per_s']:.1f} node steps/s) on {out['device']}; "
          f"{stats['ticks']} ticks at {stats['detect_ms_per_tick']:.1f} "
          f"ms/tick; {stats['aggregator']['lost_batches']} lost batches")
    for gid, g in out["groups"].items():
        gs = stats["groups"][gid]
        print(f"  group {gid}: nodes {g['nodes']}, warmed {g['warmed']}, "
              f"ingest {gs['ingest_seconds']:.3f} s, detect "
              f"{gs['detect_seconds']:.3f} s")
    for inc in out["incidents"]:
        print(inc.render())
    print(f"{len(out['hits'])} incident(s) hold node {FLEET_FAULT_NODE} over "
          f"the fault's steps {out['fault_steps']}")
    rows = {nid: r["rows"] for nid, r in out["runtime_rows"].items()}
    print(f"runtime rows per node {rows}; failed device samples "
          f"{out['failed_samples']}")
    if out["peak_memory_bytes"] is not None:
        print(f"peak device memory {out['peak_memory_bytes'] / 2**30:.2f} GiB")
    finite = all(np.isfinite(v).all() for v in out["losses"].values())
    return 0 if finite and out["hits"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
