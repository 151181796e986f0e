#!/usr/bin/env python3
"""How often the evaluation's clean control is diagnosed, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/clean_control_rate.py --mode stream \
        [--pass a|b] [--after-session] [--cells 20] [--label NAME] \
        [--condition base|switch|gate|noproc|spin|nohooks|xla_exec|...] \
        [--scenario NAME] [--fixture PATH] [--out DIR] [--stacks]
    PYTHONPATH=src python3 scripts/clean_control_rate.py --runs 12 \
        [--condition ...]

``--pass b`` (the default) builds the clean-control cell of
`chip_smoke.py`'s eval pass B with the functions `eval_pass_b` calls
(`runner.scenario_spec`, `runner.run_model_cell` and `matrix._row`, around
the full-width GPT-2 124M step: bf16, batch 8, sequence 128, CUDA-graphed,
built once by `quickstart._workload` with its set-up calls made before the
first cell). ``--pass a`` builds pass A's: the smoke scenario's clean cell
on the synthetic step, `runner.run_scenario` with the evaluator's default
config, 240 steps and seed 0, as `repro_torch.launch.evaluate --scenarios
smoke` runs it. Either cell runs ``--cells`` times in ``--mode`` (batch or
stream), in this one process. ``--after-session`` first runs one monitored
training session as `chip_smoke.py`'s ``session_path`` runs its batch mode
(`repro_torch.launch.train`, full width, 200 steps, ``--inject-faults``;
its detection sweeps on the thread executor's stream of their own), the
condition a cell met when pass A ran in the smoke's own process. Run one
process per mode and per condition: the package measured is the
``repro_torch`` on ``PYTHONPATH``, so two trees are two conditions.

One JSON line per cell: its false-alarm rate, its diagnoses, the steps
slower than the cell's median by over 0.5 ms (which, and by how much), the
CPU time the hypervisor took meanwhile (/proc/stat's steal), the
garbage collections (those over 1 ms, and how many fell inside a
monitored step), the monitored step's ms
(p50, p90), the steps each layer flagged, the XLA layer's rows a step and
spread per name in the window its model was fitted on (``xla_prefix``:
the MAD of log(1 + dur_us)), and, for every diagnosed incident, its
steps, its flags per layer, ``layer_deficit``, the mean deficit per flag
against the diagnoser's floor (``min_mean_deficit``), the blamed kind's
share, and every flag with its row's name, its deficit and the monitored
step its timestamp lies in (that step's excess over the cell's median, and
whether it is a stall), summed by name (``flags_by_name``); an incident
none of whose flags lies in a stall is ``stall_free``. A summary line
last, with each name's share of the stall-free incidents' flags and
deficit (``stall_free``). With ``--fixture``, the first stall-free
diagnosed incident's flag rows (else the first's: ts, layer, node, step,
deficit, name) and the device and collective evidence the diagnoser read
are written there as JSON, for ``tests/test_torch_diagnosis_parity.py``.

``--runs N`` measures pass A as `chip_smoke.py` runs it instead: the
evaluator (`repro_torch.launch.evaluate --scenarios smoke --modes
batch,stream`, TF32 off) in each of N fresh processes, one after
another, each its own context's first work; one line a run (its exit
code, each mode's clean-control FAR and diagnoses) and a summary.

What the host did in each monitored step (`StepWatch`, in every mode,
``--runs`` children included). A stall is a step whose STEP row (the
duration the detectors see) ran 4 ms past the cell's median. Per step:
the STEP row's ms split into the user's step and the waits on CUDA events,
the graph's device time (the runtime probe's CUDA events), the device
sampler's sweeps and /proc reads overlapping the step, the gaps of a
second process that only reads the clock (`spin`: the machine pausing
every process), the main thread's and the process's CPU clocks and
`resource.getrusage` deltas (switches, faults). Per cell: the live threads
at its first step (Python's names and the OS threads of /proc/self/task)
and each OS thread's CPU ms over the cell; beside the process,
``nvidia-smi`` every 100 ms (the card's SM and memory clocks, power draw,
temperature and clock-event reasons, over the cell and over its stalls:
``host.card``); the cgroup's CPU-quota throttling (``cpu.stat``'s
``nr_throttled`` and throttled microseconds, v2 or v1) and the machine's
CPU pressure (/proc/pressure/cpu ``some total``) over each step, each stall
with its own, and the share of stalls that either of at least 2 ms
overlapped (``stalls_throttled_or_psi_share``, beside the typical steps');
once a process, the CPU quota, the CPUs it may run on, torch's threads and
its OS threads (``process``; ``null`` where a file is missing). A cell's
line sums these up (the stalls beside the typical
step); each step's record goes under ``--out``. The graph's device time
is read from CUDA events this script records around each graph replay.
``--stacks`` also arms a `faulthandler.dump_traceback_later` watchdog
before each step, which writes every thread's Python stack when the step
runs 3 ms past the running median; on the card's Python 3.12.3 it
segfaulted the process within a few cells, so it is off by default.

``--condition`` runs the cell under diagnostics (comma-separated to
combine): ``switch`` sets
`sys.setswitchinterval` to 0.5 ms (the GIL's hand-off interval, 5 ms by
default), ``gate`` holds the device probe's sampler while a monitored step
is in flight, ``xla_exec`` drops the runtime probe's rows so the XLA layer
models only the step probe's ``executable_run``, as the reference's does,
``noproc`` has the sampler read /proc once and reuse it, ``spin`` has the
step probe spin on its event after every step (not only under 2 ms),
``nohooks`` leaves torch's CUDA entry points unhooked (the runtime probe
attached but blind).
None is a repair: each changes what is measured. ``--scenario`` builds
another scenario's cell in place of the clean control (pass B's
``runtime_stall``, to read the kind it is blamed on).

Needs a card; pass B ~7 s a cell after ~30 s of set-up, pass A ~4 s a
cell, a ``--runs`` process ~25 s.
``--device cpu`` is a dry run on the reduced model.
"""
from __future__ import annotations

import argparse
import collections as pycollections
import contextlib
import faulthandler
import gc
import json
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import threading
import time

SLOW_MS = 0.5  # a step this much over the cell's median step is slow
STALL_MS = 4.0  # a step this much over the cell's median step is a stall
CPU_STARVED_US = 2000  # a step throttled or CPU-pressured this long
WATCH_SLACK_S = 0.003  # the watchdog fires past the running median + this
EVIDENCE_LAYERS = ("device", "collective")  # what the diagnoser splits on
CONDITIONS = ("base", "switch", "gate", "xla_exec", "noproc", "spin",
              "nohooks")
RUSAGE = ("ru_utime", "ru_stime", "ru_nvcsw", "ru_nivcsw", "ru_minflt",
          "ru_majflt")
SHORT = {"ru_utime": "user_ms", "ru_stime": "sys_ms", "ru_nvcsw": "vcs",
         "ru_nivcsw": "ivcs", "ru_minflt": "minflt", "ru_majflt": "majflt"}
# the sampler may sample (``gate``): cleared while a monitored step runs
IDLE = threading.Event()
IDLE.set()


def apply_conditions(names: str) -> None:
    """Put this process under each of the comma-separated ``names``."""
    for name in names.split(","):
        apply_condition(name)


def apply_condition(name: str) -> None:
    """Put this process under ``name`` (`CONDITIONS`)."""
    if name == "switch":
        sys.setswitchinterval(0.0005)
    elif name == "gate":
        from repro_torch.core.probes.device_probe import DeviceProbe

        sample_once = DeviceProbe.sample_once

        def gated(self):
            IDLE.wait()
            sample_once(self)

        DeviceProbe.sample_once = gated
    elif name == "xla_exec":
        from repro_torch.core.probes.runtime_probe import CudaRuntimeProbe

        CudaRuntimeProbe.emit_rows = lambda self, *a, **k: None
    elif name == "spin":
        from repro_torch.core.probes import step_probe

        step_probe.SPIN_BELOW_S = float("inf")  # every step spins
    elif name == "nohooks":
        from repro_torch.core.probes import runtime_probe

        runtime_probe._install = lambda: None  # the probe hooks nothing
    elif name == "noproc":
        from repro_torch.core.probes.device_probe import ProcStats

        sample = ProcStats.sample

        def once(self):  # /proc read at the first sweep only
            if not hasattr(self, "_first"):
                self._first = sample(self)
            return self._first

        ProcStats.sample = once


def rusage_delta(a, b) -> dict:
    return {SHORT[k]: (round(1e3 * (getattr(b, k) - getattr(a, k)), 3)
                       if k in ("ru_utime", "ru_stime")
                       else getattr(b, k) - getattr(a, k)) for k in RUSAGE}


def os_threads() -> dict:
    """tid -> (comm, CPU ticks) of this process's OS threads."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        comm = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        out[int(tid)] = (comm, int(fields[11]) + int(fields[12]))
    return out


def thread_label(tid: int, names: dict) -> str:
    if tid == os.getpid():
        return "main"
    return names.get(tid) or "native"


def _cgroup_dirs() -> list:
    """The directories that may hold this process's CPU controller files,
    cgroup v2 first, then v1's ``cpu`` hierarchy (as mounted, and under the
    path /proc/self/cgroup names)."""
    rel = {}
    try:
        with open("/proc/self/cgroup") as f:
            for line in f:
                _, ctrls, path = line.rstrip("\n").split(":", 2)
                for c in (ctrls.split(",") if ctrls else [""]):
                    rel[c] = path.lstrip("/")
    except OSError:
        pass
    root = "/sys/fs/cgroup"
    dirs = [os.path.join(root, rel.get("", "")), root]
    for v1 in ("cpu", "cpu,cpuacct", "cpuacct,cpu"):
        dirs += [os.path.join(root, v1, rel.get("cpu", "")),
                 os.path.join(root, v1)]
    return list(dict.fromkeys(d.rstrip("/") for d in dirs))


def _first_file(name: str):
    for d in _cgroup_dirs():
        path = os.path.join(d, name)
        if os.path.isfile(path):
            return path
    return None


CPU_STAT = _first_file("cpu.stat")


def cpu_throttle():
    """(nr_throttled, throttled microseconds) of this process's cgroup so
    far (v2 ``throttled_usec``, v1 ``throttled_time`` in ns), or None."""
    if CPU_STAT is None:
        return None
    try:
        with open(CPU_STAT) as f:
            kv = dict(line.split() for line in f if line.strip())
    except (OSError, ValueError):
        return None
    if "throttled_usec" in kv:
        return int(kv.get("nr_throttled", 0)), int(kv["throttled_usec"])
    if "throttled_time" in kv:
        return int(kv.get("nr_throttled", 0)), int(kv["throttled_time"]) // 1000
    return None


def cpu_pressure_us():
    """/proc/pressure/cpu's ``some total`` (microseconds), or None."""
    try:
        with open("/proc/pressure/cpu") as f:
            for line in f:
                if line.startswith("some"):
                    return int(line.rsplit("total=", 1)[1])
    except (OSError, ValueError, IndexError):
        pass
    return None


def cpu_quota() -> dict:
    """Once per process: the cgroup's CPU quota (v2 ``cpu.max``, else v1's
    quota and period), the CPUs this process may run on, torch's intra-op
    threads and this process's OS threads; None where unreadable."""
    import torch

    def read(name):
        path = _first_file(name)
        if path is None:
            return None
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None

    v1 = (read("cpu.cfs_quota_us"), read("cpu.cfs_period_us"))
    return {"cpu_max": read("cpu.max"),
            "cfs_quota_period_us": None if v1 == (None, None) else list(v1),
            "cpu_stat": CPU_STAT,
            "affinity_cpus": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "torch_interop_threads": torch.get_num_interop_threads(),
            "os_threads": len(os.listdir("/proc/self/task")),
            "psi": cpu_pressure_us() is not None,
            "throttle": cpu_throttle() is not None}


def cpu_delta(a, b) -> dict:
    """One step's throttling and CPU-pressure deltas (None when unread)."""
    (ta, pa), (tb, pb) = a, b
    return {"nr_throttled": None if ta is None else tb[0] - ta[0],
            "throttled_us": None if ta is None else tb[1] - ta[1],
            "psi_some_us": None if pa is None else pb - pa}


# the device sampler's own clock (`clock_sampler`): each sweep's and each
# /proc read's (start, end) on the perf_counter clock
SWEEPS: list = []
PROC_READS: list = []


def clock_sampler() -> None:
    """Time every sweep of the device probe's sampler (`sample_once`) and
    its /proc reads (`ProcStats.sample`) from here on."""
    from repro_torch.core.probes import device_probe

    def clocked(fn, into):
        def timed(self, *a):
            t0 = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                into.append((t0, time.perf_counter()))
        return timed

    device_probe.DeviceProbe.sample_once = clocked(
        device_probe.DeviceProbe.sample_once, SWEEPS)
    device_probe.ProcStats.sample = clocked(device_probe.ProcStats.sample,
                                            PROC_READS)


# the step in flight as the step probe saw it: its STEP row's duration, and
# the seconds spent in the user's step and in waits on CUDA events
PHASE = {"step": None, "ts": None, "fn": 0.0, "sync": 0.0, "graph": 0.0}


def clock_step_phases() -> None:
    """Record each monitored step's STEP-row duration and, inside it, the
    user step's and the CUDA-event waits' seconds (`PHASE`), from here on
    (before any probe attaches, so the runtime probe's hook wraps this)."""
    import torch

    from repro_torch.core.events import Layer
    from repro_torch.core.probes.step_probe import StepProbe

    emit = StepProbe.emit_rows

    def emit_rows(self, layer, name, ts, dur=0.0, *a, **k):
        if layer == Layer.STEP:
            PHASE["step"] = float(dur)
            PHASE["ts"] = float(ts)
        return emit(self, layer, name, ts, dur, *a, **k)

    StepProbe.emit_rows = emit_rows
    sync = torch.cuda.Event.synchronize

    def timed_sync(self):
        t0 = time.perf_counter()
        try:
            return sync(self)
        finally:
            PHASE["sync"] += time.perf_counter() - t0

    torch.cuda.Event.synchronize = timed_sync
    replay = torch.cuda.CUDAGraph.replay

    def timed_replay(self, *a, **k):  # the graph's device time, by events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return replay(self, *a, **k)
        finally:
            end.record()
            GRAPHS.append((start, end))

    torch.cuda.CUDAGraph.replay = timed_replay


# graph replays of the step in flight whose device time is not read yet
GRAPHS: list = []


def graph_ms() -> float:
    """The device ms of the graphs launched since the last call (each has
    finished: the step probe waited for the step)."""
    ms = sum(a.elapsed_time(b) for a, b in GRAPHS)
    GRAPHS.clear()
    return ms


# flag rows the incident engines admitted, by (ts, layer index, node,
# deficit) -> the row's name (`clock_flag_names`); the last cold fit's
# per-name rows of each layer (name -> (count, median log_dur, MAD))
FLAG_NAMES: dict = {}
PREFIX: dict = {}
_LAST_FS = {"ts": None, "names": None}


def _per_name(names, log_dur) -> dict:
    import numpy as np

    out = {}
    names = np.asarray(names).astype(str)
    for n in np.unique(names):
        v = log_dur[names == n]
        med = float(np.median(v))
        out[str(n)] = (int(v.shape[0]), med,
                       float(np.median(np.abs(v - med))))
    return out


def clock_flag_names() -> None:
    """From here on, remember the name of every flag row an incident
    engine admits (`FLAG_NAMES`) and each layer's per-name rows in the
    window its model was fitted on (`PREFIX`). The detections carry no
    names: a detection built from the feature rows just made takes theirs
    (same ``ts`` array), and the engine's admitted rows are keyed by the
    values it stores (ts, layer, node, deficit)."""
    import numpy as np

    from repro_torch.core import detector as dmod, features
    from repro_torch.core.events import Layer
    from repro_torch.stream import incidents as imod, online

    featurize = online.OnlineGMMDetector._featurize

    def featurize_kept(self, window, state):
        fs = featurize(self, window, state)
        if fs is not None:
            _LAST_FS.update(ts=fs.ts, names=fs.names)
        return fs

    online.OnlineGMMDetector._featurize = featurize_kept
    transform = features.LayerFeaturizer.transform

    def transform_kept(self, data):
        fs = transform(self, data)
        if fs is not None:
            _LAST_FS.update(ts=fs.ts, names=fs.event_names)
        return fs

    features.LayerFeaturizer.transform = transform_kept
    for cls in (online.WindowDetection, dmod.DetectionResult):
        init = cls.__init__

        def init_named(self, *a, _init=init, **k):
            _init(self, *a, **k)
            if _LAST_FS["ts"] is not None and self.ts is _LAST_FS["ts"]:
                self._names = _LAST_FS["names"]

        cls.__init__ = init_named
    cold_fit = online.OnlineGMMDetector._cold_fit

    def cold_fit_kept(self, layer, fs):
        if layer != Layer.DEVICE:  # before the baseline: X[:, 0] = log_dur
            PREFIX[layer.value] = _per_name(fs.names, fs.X[:, 0].copy())
        return cold_fit(self, layer, fs)

    online.OnlineGMMDetector._cold_fit = cold_fit_kept
    fit = features.LayerFeaturizer.fit

    def fit_kept(self, data):
        out = fit(self, data)
        if out is not None and self.layer != Layer.DEVICE:
            fs = features.build_features(data, self.layer)
            PREFIX[self.layer.value] = _per_name(fs.event_names, fs.X[:, 0])
        return out

    features.LayerFeaturizer.fit = fit_kept
    ingest = imod.IncidentEngine.ingest

    def ingest_named(self, detections, now=None):
        for layer, det in detections.items():
            names = getattr(det, "_names", None)
            if names is None or getattr(det, "ts", None) is None:
                continue
            f = np.asarray(det.flags)
            if not f.any():
                continue
            nodes = (det.nodes if det.nodes is not None
                     else np.zeros(len(det.ts), dtype=np.int32))
            deficit = np.clip(det.log_delta - det.scores[f], 0.0,
                              self.deficit_cap)
            li = float(self._layer_idx[layer])
            for t, n, d, name in zip(det.ts[f], nodes[f], deficit,
                                     np.asarray(names)[f]):
                FLAG_NAMES[(float(t), li, float(n), float(d))] = str(name)
        return ingest(self, detections, now)

    imod.IncidentEngine.ingest = ingest_named


def prefix_spread(layer: str = "xla") -> dict:
    """``layer``'s rows a step per name in its model's fitted window (one
    ``executable_run`` a monitored step) and each name's spread there (the
    MAD of log(1 + dur_us)) and median duration."""
    import math

    rows = PREFIX.get(layer, {})
    steps = rows.get("executable_run", (0,))[0] or 1
    return {n: {"rows_per_step": round(c / steps, 3),
                "mad_log_dur": round(mad, 5),
                "median_us": round(math.expm1(med), 2)}
            for n, (c, med, mad) in sorted(rows.items())}


def spin(seconds: float) -> int:
    """``--spin``: a process that only reads the clock, printing every gap
    over 2 ms as ``start end`` (perf_counter, the system's monotonic clock,
    which the process under test shares): when this process was not run."""
    last = time.perf_counter()
    end = last + seconds
    while last < end:
        now = time.perf_counter()
        if now - last > 0.002:
            print(f"{last} {now}", flush=True)
        last = now
    return 0


class Spinner:
    """A `spin` process beside the process under test, for as long as this
    object lives; ``gaps()`` reads what it has printed so far."""

    def __init__(self, out_dir: str, tag: str, seconds: float = 3600.0):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{tag}.spin.txt")
        self._f = open(self.path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--spin",
             str(seconds)], stdout=self._f)

    def gaps(self) -> list:
        with open(self.path) as f:
            return [tuple(map(float, line.split())) for line in f
                    if len(line.split()) == 2]

    def close(self) -> None:
        self.proc.terminate()
        self.proc.wait()
        self._f.close()


SPINNER: list = []  # the live `Spinner`, if any

SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "clocks_event_reasons.active")


class SmiSampler:
    """``nvidia-smi`` beside the process under test, every 100 ms for as
    long as this object lives: the card's SM and memory clocks, power
    draw, temperature and active clock-event (throttle) reasons; ``in_span``
    reads the samples between two perf_counter times. Without nvidia-smi
    (or a field it lacks) it samples what it can, or nothing."""

    def __init__(self, out_dir: str, tag: str):
        import datetime

        self._dt = datetime.datetime
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{tag}.smi.csv")
        self.fields, self.proc = (), None
        for fields in (SMI_FIELDS, SMI_FIELDS[:4]):
            try:
                ok = subprocess.run(
                    ["nvidia-smi", "--query-gpu=" + ",".join(fields),
                     "--format=csv,noheader,nounits"], capture_output=True,
                    timeout=30).returncode == 0
            except (OSError, subprocess.SubprocessError):
                return
            if ok:
                self.fields = fields
                break
        if not self.fields:
            return
        # wall clock -> perf_counter (nvidia-smi stamps local wall time)
        self.offset = time.time() - time.perf_counter()
        self._f = open(self.path, "w")
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp," + ",".join(self.fields),
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=self._f, stderr=subprocess.DEVNULL)

    def samples(self) -> list:
        """(perf_counter time, {field: value}) of every sample so far."""
        if self.proc is None:
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                parts = [p.strip() for p in line.split(",")]
                if len(parts) != len(self.fields) + 1:
                    continue
                try:
                    t = self._dt.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
                except ValueError:
                    continue
                vals = {}
                for k, v in zip(self.fields, parts[1:]):
                    try:
                        vals[k] = (int(v, 16) if k.endswith("active")
                                   else float(v))
                    except ValueError:
                        vals[k] = None
                out.append((t.timestamp() - self.offset, vals))
        return out

    def close(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
            self._f.close()


SMI: list = []  # the live `SmiSampler`, if any


def smi_summary(spans, stalls) -> dict:
    """The card's clocks, power, temperature and clock-event reasons over
    a cell (``spans``: each step's perf_counter (start, end)) and over its
    stalls (indices into ``spans``; each widened by the 100 ms period)."""
    import numpy as np

    if not SMI or not spans:
        return {}
    got = SMI[0].samples()
    t0, t1 = spans[0][0], spans[-1][1]
    cell = [v for t, v in got if t0 <= t <= t1]

    def stats(rows):
        if not rows:
            return {}
        out = {}
        for k in ("clocks.sm", "clocks.mem", "power.draw",
                  "temperature.gpu"):
            xs = [r[k] for r in rows if r.get(k) is not None]
            if xs:
                out[k] = [min(xs), float(np.median(xs)), max(xs)]
        reasons = sorted({r["clocks_event_reasons.active"] for r in rows
                          if r.get("clocks_event_reasons.active")
                          is not None})
        out["reasons"] = [hex(x) for x in reasons]
        out["samples"] = len(rows)
        return out

    near = [v for t, v in got for i in stalls
            if spans[i][0] - 0.1 <= t <= spans[i][1] + 0.1]
    return {"cell": stats(cell), "stalls": stats(near)}


def overlap_ms(spans, a: float, b: float) -> float:
    return 1e3 * sum(max(0.0, min(b, t1) - max(a, t0)) for t0, t1 in spans
                     if t1 > a and t0 < b)


class StepWatch:
    """The instruments around each monitored step of one cell (module
    docstring): ``wrap`` the monitored step, ``summary()`` after the
    cell."""

    def __init__(self, out_dir: str, tag: str, prior_s: float = 0.02,
                 stacks: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.base = os.path.join(out_dir, tag)
        self.stacks_on = stacks
        self.dump = open(self.base + ".stacks.txt", "w") if stacks else None
        self.prior_s = prior_s
        self.spans, self.thread, self.proc, self.cpu = [], [], [], []
        self.cgroup = []  # each step's throttling and CPU-pressure deltas
        # (STEP row ms, user step ms, event-wait ms, graph device ms)
        self.phases = []
        self.step_ts = []  # each STEP row's ts (the collector's clock)
        self.names, self.idents, self.py_threads = {}, {}, []
        self.tasks0 = {}
        self.n_sweeps, self.n_reads = len(SWEEPS), len(PROC_READS)

    def _cell_start(self) -> None:
        """At the first monitored step (the probes attached): the live
        threads, and each OS thread's CPU so far."""
        live = threading.enumerate()
        self.names = {t.native_id: t.name for t in live}
        self.idents = {t.ident: t.name for t in live}
        self.py_threads = sorted(t.name for t in live)
        self.tasks0 = os_threads()

    def wrap(self, monitored):
        def call(*a):
            if not self.spans:
                self._cell_start()
            if self.stacks_on:
                durs = [b - a_ for a_, b in self.spans]
                med = (statistics.median(durs[-60:]) if len(durs) >= 10
                       else self.prior_s)
                self.dump.write(f"== step {len(self.spans)}\n")
                self.dump.flush()
                faulthandler.dump_traceback_later(med + WATCH_SLACK_S,
                                                  file=self.dump)
            IDLE.clear()
            GRAPHS.clear()
            PHASE.update(step=None, ts=None, fn=0.0, sync=0.0, graph=0.0)
            cg0 = (cpu_throttle(), cpu_pressure_us())
            rt0 = resource.getrusage(resource.RUSAGE_THREAD)
            rp0 = resource.getrusage(resource.RUSAGE_SELF)
            c0, p0 = time.thread_time(), time.process_time()
            t0 = time.perf_counter()
            try:
                return monitored(*a)
            finally:
                t1 = time.perf_counter()
                c1, p1 = time.thread_time(), time.process_time()
                rt1 = resource.getrusage(resource.RUSAGE_THREAD)
                rp1 = resource.getrusage(resource.RUSAGE_SELF)
                cg1 = (cpu_throttle(), cpu_pressure_us())
                IDLE.set()
                if self.stacks_on:
                    faulthandler.cancel_dump_traceback_later()
                PHASE["graph"] = graph_ms()
                self.spans.append((t0, t1))
                self.step_ts.append(PHASE["ts"])
                self.phases.append(
                    (1e3 * (PHASE["step"] if PHASE["step"] is not None
                            else t1 - t0), 1e3 * PHASE["fn"],
                     1e3 * PHASE["sync"], PHASE["graph"]))
                self.cpu.append((1e3 * (c1 - c0), 1e3 * (p1 - p0)))
                self.thread.append(rusage_delta(rt0, rt1))
                self.proc.append(rusage_delta(rp0, rp1))
                self.cgroup.append(cpu_delta(cg0, cg1))
        return call

    def stacks(self) -> dict:
        """step -> {thread label: top frames} of every watchdog dump."""
        if not self.stacks_on:
            return {}
        self.dump.close()
        with open(self.base + ".stacks.txt") as f:
            text = f.read()
        idents = dict(self.idents)
        idents.update({t.ident: t.name for t in threading.enumerate()})
        out = {}
        for block in re.split(r"^== step ", text, flags=re.M)[1:]:
            head, _, rest = block.partition("\n")
            if "Thread 0x" not in rest:
                continue
            threads = {}
            for t in re.split(r"^(?:Current thread|Thread) ", rest,
                              flags=re.M)[1:]:
                ident = int(t.split()[0], 16)
                label = ("main" if ident == threading.main_thread().ident
                         else idents.get(ident) or f"0x{ident:x}")
                frames = re.findall(r'File "([^"]+)", line (\d+) in (\S+)',
                                    t)
                threads[label] = [f"{os.path.basename(p)}:{n} {fn}"
                                  for p, n, fn in frames[:3]]
            out[int(head)] = threads
        return out

    def summary(self) -> dict:
        import numpy as np

        tasks1 = os_threads()
        # stalls as the detectors see them: the STEP row's duration
        ms = np.array([p[0] for p in self.phases])
        med = float(np.median(ms)) if len(ms) else 0.0
        slow = [int(i) for i in np.argsort(-ms) if ms[i] > med + SLOW_MS]
        stalls = [i for i in slow if ms[i] > med + STALL_MS]
        typical = [i for i in range(len(ms)) if ms[i] <= med + SLOW_MS]
        sweeps = SWEEPS[self.n_sweeps:]
        reads = PROC_READS[self.n_reads:]
        gaps = SPINNER[0].gaps() if SPINNER else []
        rows = []
        for (a, b), (step, fn, sync, graph), (cpu, pcpu), t, cg in zip(
                self.spans, self.phases, self.cpu, self.thread,
                self.cgroup):
            rows.append({**cg, "ms": step, "call_ms": 1e3 * (b - a),
                         "fn_ms": fn, "sync_ms": sync, "graph_ms": graph,
                         "main_cpu_ms": cpu, "process_cpu_ms": pcpu,
                         "sampler_ms": overlap_ms(sweeps, a, b),
                         "proc_read_ms": overlap_ms(reads, a, b),
                         "spin_gap_ms": overlap_ms(gaps, a, b), **t})
        keys = ("ms", "call_ms", "fn_ms", "sync_ms", "graph_ms",
                "main_cpu_ms",
                "process_cpu_ms", "sampler_ms", "proc_read_ms",
                "spin_gap_ms", "vcs", "ivcs", "minflt")

        def mean(idx):
            return {k: round(float(np.mean([rows[i][k] for i in idx])), 3)
                    for k in keys} if idx else {}

        def spread(spans):
            d = 1e3 * np.array([b - a for a, b in spans])
            return ({"n": len(d), "p50_ms": round(float(np.median(d)), 3),
                     "p90_ms": round(float(np.percentile(d, 90)), 3),
                     "max_ms": round(float(d.max()), 3)} if len(d) else {})

        dumps = self.stacks()
        tick = os.sysconf("SC_CLK_TCK")
        cpu = {}
        for tid, (comm, ticks) in tasks1.items():
            used = ticks - self.tasks0.get(tid, (comm, 0))[1]
            if used:
                label = f"{thread_label(tid, self.names)}/{comm}"
                cpu[label] = cpu.get(label, 0.0) + 1e3 * used / tick
        with open(self.base + ".steps.jsonl", "w") as f:
            for i, r in enumerate(rows):
                f.write(json.dumps(dict(r, step=i)) + "\n")
        return {
            "threads_at_start": {
                "python": self.py_threads,
                "os": dict(pycollections.Counter(
                    f"{thread_label(t, self.names)}/{c}"
                    for t, (c, _) in self.tasks0.items()))},
            "thread_cpu_ms": dict(sorted(cpu.items(),
                                         key=lambda kv: -kv[1])[:8]),
            "sampler_sweep": spread(sweeps), "proc_read": spread(reads),
            "steps": len(rows), "stalls": len(stalls),
            "stall_at": stalls[:12],
            "stall_rows": [dict({k: round(float(rows[i][k]), 3)
                                 for k in keys}, step=i,
                                excess_ms=round(float(ms[i] - med), 3),
                                throttled_us=rows[i]["throttled_us"],
                                nr_throttled=rows[i]["nr_throttled"],
                                psi_some_us=rows[i]["psi_some_us"])
                           for i in stalls[:8]],
            # the stalls CPU-quota throttling or CPU pressure of at least
            # CPU_STARVED_US overlapped, and how often a typical step met it
            "stalls_throttled": sum(starved(rows[i], "throttled_us")
                                    for i in stalls),
            "stalls_psi": sum(starved(rows[i], "psi_some_us")
                              for i in stalls),
            "stalls_throttled_or_psi": sum(
                starved(rows[i], "throttled_us")
                or starved(rows[i], "psi_some_us") for i in stalls),
            "typical_throttled_or_psi": sum(
                starved(rows[i], "throttled_us")
                or starved(rows[i], "psi_some_us") for i in typical),
            "typical_steps": len(typical),
            "throttled_us": sum(r["throttled_us"] or 0 for r in rows),
            "psi_some_us": sum(r["psi_some_us"] or 0 for r in rows),
            "stalls_in_a_proc_read": sum(rows[i]["proc_read_ms"] > 0
                                         for i in stalls),
            "stalls_in_a_spin_gap": sum(rows[i]["spin_gap_ms"] > 0
                                        for i in stalls),
            "steps_in_a_spin_gap": sum(r["spin_gap_ms"] > 0 for r in rows),
            "spin_gaps": len([g for g in gaps if self.spans
                              and self.spans[0][0] <= g[0]
                              <= self.spans[-1][1]]),
            "span_s": (self.spans[-1][1] - self.spans[0][0]
                       if self.spans else 0.0),
            "slow_mean": mean(slow), "typical_mean": mean(typical),
            "steps_in_a_proc_read": sum(r["proc_read_ms"] > 0 for r in rows),
            "watchdog_dumps": len(dumps),
            "card": smi_summary(self.spans, stalls),
            "stall_stacks": {str(i): dumps[i] for i in stalls[:4]
                             if i in dumps},
        }


def watch_session(session, watch: "StepWatch") -> None:
    """Every step ``session.observe_step_fn`` hands back runs under
    ``watch``."""
    observe = session.observe_step_fn

    def watched_observe(fn, **kw):
        def user_step(*a, **k):  # the user's step, inside the STEP window
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                PHASE["fn"] += time.perf_counter() - t0

        return watch.wrap(observe(user_step, **kw))

    session.observe_step_fn = watched_observe


def steal_s() -> float:
    """Seconds the hypervisor took from this machine's CPUs so far (the
    ``steal`` column of /proc/stat, in USER_HZ ticks); NaN if unreadable."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e!r})"


@contextlib.contextmanager
def collections():
    """For the block: every garbage collection, as (generation, start,
    end) on the perf_counter clock."""
    import gc

    got, start = [], [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            got.append((info["generation"], start[0], time.perf_counter()))

    gc.callbacks.append(cb)
    try:
        yield got
    finally:
        gc.callbacks.remove(cb)


def gc_line(got, spans):
    """Collections over 1 ms: how many, the longest, and how many fell
    inside a monitored step (``spans``: each step's (start, end))."""
    import numpy as np

    long_ = [(g, a, b) for g, a, b in got if b - a > 1e-3]
    starts = np.array([a for a, _ in spans])
    ends = np.array([b for _, b in spans])
    inside = sum(bool(((starts <= a) & (a < ends)).any())
                 for _, a, _ in long_)
    return {"collections": len(got), "over_1ms": len(long_),
            "over_1ms_in_step": inside,
            "max_ms": round(1e3 * max((b - a for _, a, b in got),
                                      default=0.0), 3),
            "gen2": sum(g == 2 for g, _, _ in got)}


@contextlib.contextmanager
def recorded():
    """For the block: every incident the engines close, with the flag rows
    it was made of, and every evidence dict the diagnoser was given."""
    from repro_torch.diagnosis import engine as dmod
    from repro_torch.stream import incidents as imod

    got = {"groups": {}, "evidence": {}}
    attribute = imod.IncidentEngine._attribute
    diagnose = dmod.Diagnoser.diagnose

    def attribute_kept(self, g):
        inc = attribute(self, g)
        if inc is not None:
            got["groups"][inc.incident_id] = g.copy()
        return inc

    def diagnose_kept(self, incident, evidence=None):
        got["evidence"][incident.incident_id] = evidence or {}
        return diagnose(self, incident, evidence)

    imod.IncidentEngine._attribute = attribute_kept
    dmod.Diagnoser.diagnose = diagnose_kept
    try:
        yield got
    finally:
        imod.IncidentEngine._attribute = attribute
        dmod.Diagnoser.diagnose = diagnose


def flag_rows(g, watch) -> list:
    """Each flag row of an incident (``g``: ts, layer, node, step, deficit)
    with its row's name (`FLAG_NAMES`), the monitored step its ts lies in
    (the STEP rows' windows; a row between steps takes the step before) and
    that step's excess over the cell's median STEP row in ms, and whether
    that step is a stall (over the median by `STALL_MS`)."""
    import numpy as np

    from repro_torch.core.events import Layer

    layers = tuple(Layer)
    ms = np.asarray([p[0] for p in watch.phases])
    t0 = np.asarray([t if t is not None else np.nan for t in watch.step_ts])
    med = float(np.median(ms)) if len(ms) else 0.0
    out = []
    for ts, li, node, step, d in g:
        # 1 us of slack: the wire carries ts in whole nanoseconds
        i = (int(np.searchsorted(t0, ts + 1e-6, side="right")) - 1
             if len(t0) else -1)
        excess = float(ms[i] - med) if i >= 0 else None
        out.append({"ts": float(ts), "layer": layers[int(li)].value,
                    "name": FLAG_NAMES.get((float(ts), float(li),
                                            float(node), float(d)), "?"),
                    "node": int(node), "step": int(step),
                    "deficit": round(float(d), 4), "in_step": i,
                    "step_excess_ms": (round(excess, 3)
                                       if excess is not None else None),
                    "stall": bool(excess is not None
                                  and excess > STALL_MS)})
    return out


def by_name(flags) -> dict:
    """layer/name -> flags, deficit, and the largest deficit."""
    out = {}
    for f in flags:
        key = f"{f['layer']}/{f['name']}"
        e = out.setdefault(key, {"flags": 0, "deficit": 0.0, "max": 0.0})
        e["flags"] += 1
        e["deficit"] = round(e["deficit"] + f["deficit"], 4)
        e["max"] = max(e["max"], f["deficit"])
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["deficit"]))


def incident_line(inc, diag, g, floor, watch):
    """One diagnosed incident as printed: its flags by layer and by row
    name, each flag with its deficit and whether it lies in a stall."""
    import numpy as np

    from repro_torch.core.events import Layer

    layers = tuple(Layer)
    ids, counts = np.unique(g[:, 1].astype(int), return_counts=True)
    steps = sorted(inc.steps)
    flags = flag_rows(g, watch)
    return {"kind": diag.fault_kind, "share": diag.candidates[diag.fault_kind],
            "confidence": diag.confidence,
            "steps": {"first": steps[0] if steps else None,
                      "last": steps[-1] if steps else None,
                      "count": len(steps)},
            "n_flags": inc.n_flags,
            "flags_per_layer": {layers[i].value: int(c)
                                for i, c in zip(ids, counts)},
            "layer_deficit": {k: round(v, 3)
                              for k, v in inc.layer_deficit.items()},
            "mean_deficit": inc.severity / max(inc.n_flags, 1),
            "min_mean_deficit": floor,
            "stall_free": not any(f["stall"] for f in flags),
            "flags_by_name": by_name(flags), "flags": flags}


def stall_free_shares(cells) -> dict:
    """Over every diagnosed incident holding no stall: each layer/name's
    share of their flags and of their deficit."""
    flags = [f for c in cells for inc in c["diagnosed"] if inc["stall_free"]
             for f in inc["flags"]]
    n = len(flags)
    total = sum(f["deficit"] for f in flags) or 1.0
    return {"incidents": sum(inc["stall_free"] for c in cells
                             for inc in c["diagnosed"]),
            "of_diagnosed": sum(len(c["diagnosed"]) for c in cells),
            "flags": n,
            "by_name": {k: {"flags": v["flags"],
                            "flag_share": round(v["flags"] / max(n, 1), 4),
                            "deficit_share": round(v["deficit"] / total, 4),
                            "max_deficit": v["max"]}
                        for k, v in by_name(flags).items()}}


def fixture(mode, inc, diag, g, evidence, label, line):
    """The incident's flag rows (with each row's name and the step it lies
    in, ``line``'s `flag_rows`) and the evidence the diagnoser read, as
    JSON (numbers rounded to what the float64 rows carry)."""
    import numpy as np

    from repro_torch.core.events import Layer

    layers = tuple(Layer)
    ev = {}
    for layer, cols in evidence.items():
        if layer.value not in EVIDENCE_LAYERS:
            continue
        ev[layer.value] = {
            k: (cols[k].astype(str).tolist() if cols[k].dtype.kind in "UOS"
                else np.asarray(cols[k], dtype=np.float64).tolist())
            for k in ("ts", "dur", "size", "name", "step", "node", "util",
                      "mem_gb", "power_w", "temp_c") if k in cols}
    return {"what": "a clean-control incident diagnosed on the card",
            "mode": mode, "label": label, "card": card(),
            "engine": {"gap_s": 0.25, "close_after_s": 0.25, "min_flags": 5},
            "layers": [l.value for l in layers],
            "rows": {"ts": g[:, 0].tolist(),
                     "layer": [layers[int(i)].value for i in g[:, 1]],
                     "node": g[:, 2].astype(int).tolist(),
                     "step": g[:, 3].astype(int).tolist(),
                     "deficit": g[:, 4].tolist(),
                     "name": [f["name"] for f in line["flags"]],
                     "step_excess_ms": [f["step_excess_ms"]
                                        for f in line["flags"]]},
            "stall_free": line["stall_free"],
            "xla_prefix": prefix_spread("xla"),
            "evidence": ev,
            "incident": {"n_flags": inc.n_flags, "severity": inc.severity,
                         "suspect_layer": inc.suspect_layer.value,
                         "layer_deficit": inc.layer_deficit},
            "diagnosis": {"fault_kind": diag.fault_kind,
                          "confidence": diag.confidence,
                          "candidates": diag.candidates}}


def lasting_shift(report, eval_start: int, n: int) -> bool:
    """Whether STEP and OPERATOR each flagged over half the scored steps
    (``eval_start`` to ``n``): a step time that moved and stayed."""
    scored = n - eval_start
    return all(
        k in report.layers
        and sum(s >= eval_start for s in report.layers[k].anomalous_steps)
        > scored / 2 for k in ("step", "operator"))


def threaded_session(dev) -> dict:
    """One monitored training session as `chip_smoke.py`'s ``session_path``
    runs its batch mode: the launcher's legacy probe options, the thread
    executor's sweeps on a CUDA stream of their own."""
    from repro_torch.launch import train

    spec = {"mode": "batch", "probe_options": train.LEGACY_PROBE_OPTIONS}
    size = (["--steps", "200", "--batch", "8", "--seq", "128"]
            if dev.type == "cuda" else
            ["--reduced", "--steps", "60", "--batch", "4", "--seq", "32"])
    out = train.train(train.parser().parse_args(
        ["--arch", "gpt2", "--device", dev.type, *size, "--inject-faults",
         "--log-every", "0", "--monitor-spec", json.dumps(spec)]))
    return {"steps": len(out["losses"]), "steps_per_s": out["steps_per_s"]}


def pass_a_cell(mode, dev, n, name="clean_control"):
    """Pass A's cell of scenario ``name``: ``one(timed) -> ScenarioRun``,
    ``timed`` called on the cell's session before its first step."""
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import matrix, runner

    scenario = get_scenario(name)
    cfg = matrix.CONFIG_GRID["default"]

    def one(timed):
        inner = runner._run_train_steps

        def watched(session, *a):
            timed(session)
            return inner(session, *a)

        runner._run_train_steps = watched
        try:
            return runner.run_scenario(scenario, mode, cfg, n_steps=n,
                                       seed=0, device=dev)
        finally:
            runner._run_train_steps = inner
    return one


def pass_b_cell(mode, dev, n, cells, name="clean_control"):
    """Pass B's cell of scenario ``name`` around the full-width GPT-2 step,
    built once and shared by every cell: ``one(timed) -> ScenarioRun``."""
    import torch

    from repro_torch import quickstart
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import runner
    from repro_torch.models.model import batch_to_device
    from repro_torch.session import Session

    batch, seq, data, state, step_fn = quickstart._workload(
        dev.type == "cpu", dev, cells * n + quickstart.SETUP_STEPS)
    for s in range(quickstart.SETUP_STEPS):  # graph capture, first use
        state, _ = step_fn(state, batch_to_device(data.batch(s), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cfg = runner.EvalConfig()
    scenario = get_scenario(name)
    held = {"state": state}

    def one(timed):
        session = Session(runner.scenario_spec(scenario, mode, n, cfg,
                                               seed=0), device=dev)
        timed(session)
        run, held["state"], _ = runner.run_model_cell(
            session, scenario, n, cfg, step_fn, held["state"], data)
        return run
    return one


def evaluator_runs(n: int, dev, args) -> int:
    """``--runs``: pass A as the smoke's child runs it, in ``n`` fresh
    processes (this script again, with ``--one-run OUT``), each under
    ``--condition``; a line a run with its clean cells' host summaries."""
    tmp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "clean_control_runs")
    rcs, runs, hosts = [], [], []
    for i in range(n):
        out = os.path.join(tmp, f"run{i}")
        shutil.rmtree(out, ignore_errors=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one-run",
             out, "--device", dev.type, "--condition", args.condition,
             "--out", os.path.join(args.out, f"{args.label}_run{i}"),
             *(["--stacks"] if args.stacks else [])],
            capture_output=True, text=True, timeout=600)
        path = os.path.join(out, "scenario_matrix.json")
        if not os.path.exists(path):
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        with open(path) as f:
            rows = json.load(f)["rows"]
        clean = {r["mode"]: {"far": r["metrics"]["false_alarm_rate"],
                             "diagnoses": r["diagnosis"]["kinds"]}
                 for r in rows if r["scenario"] == "clean_control"}
        host = {}
        with open(os.path.join(out, "host.jsonl")) as f:
            for line in f:
                cell = json.loads(line)
                if cell["scenario"] == "clean_control":
                    host[cell["mode"]] = cell["host"]
        rcs.append(proc.returncode)
        runs.append(clean)
        hosts.extend(host.values())
        print(json.dumps({"run": i, "condition": args.condition,
                          "rc": proc.returncode, "clean_control": clean,
                          "host": host}), flush=True)
    print(json.dumps({"summary": {
        "runs": n, "condition": args.condition,
        "failed_runs": sum(bool(rc) for rc in rcs),
        "diagnosed": {m: sum(bool(r[m]["diagnoses"]) for r in runs)
                      for m in ("batch", "stream")},
        **host_totals(hosts), "card": card()}}), flush=True)
    return 0


def one_run(out: str, dev, watch_dir: str, stacks: bool) -> int:
    """``--one-run OUT``: the evaluator once, as pass A's child runs it,
    every cell's steps under a `StepWatch`; each cell's host summary is a
    line of OUT/host.jsonl."""
    from repro_torch.eval import runner
    from repro_torch.launch import evaluate

    inner = runner._run_train_steps
    os.makedirs(out, exist_ok=True)
    cells = []

    def watched(session, injector, *a):
        # the clean control is the cell without faults
        name = "+".join(sorted({f.kind for f in injector.faults})) \
            or "clean_control"
        mode = session.spec.mode
        watch = StepWatch(watch_dir, f"cell{len(cells)}_{name}_{mode}",
                          stacks=stacks)
        watch_session(session, watch)
        try:
            return inner(session, injector, *a)
        finally:
            cells.append(name)
            with open(os.path.join(out, "host.jsonl"), "a") as f:
                f.write(json.dumps({"scenario": name, "mode": mode,
                                    "host": watch.summary()}) + "\n")

    runner._run_train_steps = watched
    argv = ["--scenarios", "smoke", "--modes", "batch,stream", "--device",
            dev.type, "--out", out]
    if dev.type == "cpu":
        argv += ["--steps", "160"]
    return evaluate.main(argv)


def starved(row: dict, key: str) -> bool:
    return row[key] is not None and row[key] >= CPU_STARVED_US


def host_totals(hosts) -> dict:
    """Over cells' host summaries: stalls a cell; in a stall, the main
    thread's CPU ms, the sampler's and its /proc reads' ms inside it, and
    the share of stalls a /proc read overlapped, beside the share of all
    steps; the /proc reads' p50 and max ms; the commonest top frames in the
    stalls' stacks (main thread, and the others)."""
    import numpy as np

    stalls = [r for h in hosts for r in h["stall_rows"]]
    main_top, other_top = pycollections.Counter(), pycollections.Counter()
    for h in hosts:
        for threads in h["stall_stacks"].values():
            for label, frames in threads.items():
                (main_top if label == "main" else other_top)[
                    f"{label}: {frames[0] if frames else '?'}"] += 1

    def avg(key):
        vals = [r[key] for r in stalls if r.get(key) is not None]
        return round(float(np.mean(vals)), 3) if vals else None

    n_stalls = sum(h["stalls"] for h in hosts)

    def of_stalls(key):
        return f"{sum(h[key] for h in hosts)}/{n_stalls}"

    reads = [h["proc_read"] for h in hosts if h["proc_read"]]
    return {
        "stalls_per_cell": float(np.mean([h["stalls"] for h in hosts]))
        if hosts else 0.0,
        "stall_excess_ms": avg("excess_ms"),
        "stall_main_cpu_ms": avg("main_cpu_ms"),
        "stall_sampler_ms": avg("sampler_ms"),
        "stall_proc_read_ms": avg("proc_read_ms"),
        "stall_main_ivcs_share": float(np.mean(
            [r["ivcs"] > 0 for r in stalls])) if stalls else None,
        "stall_fn_ms": avg("fn_ms"), "stall_sync_ms": avg("sync_ms"),
        "stall_graph_ms": avg("graph_ms"),
        "typical_fn_sync_graph_ms": [round(float(np.mean(
            [h["typical_mean"][k] for h in hosts if h["typical_mean"]])), 3)
            for k in ("fn_ms", "sync_ms", "graph_ms")] if hosts else None,
        "stall_spin_gap_ms": avg("spin_gap_ms"),
        "stalls_in_a_proc_read": of_stalls("stalls_in_a_proc_read"),
        "stalls_in_a_spin_gap": of_stalls("stalls_in_a_spin_gap"),
        "stalls_throttled": of_stalls("stalls_throttled"),
        "stalls_psi": of_stalls("stalls_psi"),
        "stalls_throttled_or_psi": of_stalls("stalls_throttled_or_psi"),
        "stalls_throttled_or_psi_share": round(
            sum(h["stalls_throttled_or_psi"] for h in hosts)
            / n_stalls, 4) if n_stalls else None,
        "typical_throttled_or_psi_share": round(
            sum(h["typical_throttled_or_psi"] for h in hosts)
            / max(sum(h["typical_steps"] for h in hosts), 1), 4),
        "stall_throttled_us": avg("throttled_us"),
        "stall_psi_some_us": avg("psi_some_us"),
        "throttled_us_per_cell": float(np.mean(
            [h["throttled_us"] for h in hosts])) if hosts else None,
        "psi_some_us_per_cell": float(np.mean(
            [h["psi_some_us"] for h in hosts])) if hosts else None,
        "steps_in_a_spin_gap_share": round(float(
            sum(h["steps_in_a_spin_gap"] for h in hosts)
            / max(sum(h.get("steps", 0) for h in hosts), 1)), 4),
        "spin_gaps_per_s": round(float(
            sum(h["spin_gaps"] for h in hosts)
            / max(sum(h["span_s"] for h in hosts), 1e-9)), 3),
        "steps_in_a_proc_read_share": round(float(
            sum(h["steps_in_a_proc_read"] for h in hosts)
            / max(sum(h.get("steps", 0) for h in hosts), 1)), 4),
        "proc_read_p50_ms": round(float(np.median(
            [r["p50_ms"] for r in reads])), 3) if reads else None,
        "proc_read_max_ms": max(r["max_ms"] for r in reads)
        if reads else None,
        "stall_main_top": main_top.most_common(5),
        "stall_other_top": other_top.most_common(8)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("batch", "stream"))
    ap.add_argument("--runs", type=int, default=0,
                    help="pass A as the smoke runs it, in N fresh processes")
    ap.add_argument("--one-run", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pass", dest="pass_", choices=("a", "b"), default="b")
    ap.add_argument("--after-session", action="store_true",
                    help="first run one threaded-executor training session")
    ap.add_argument("--cells", type=int, default=20)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--fixture", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the reduced model, a dry run of the script")
    ap.add_argument("--condition", default="base",
                    help="diagnostics the cells run under, comma-separated "
                         f"(docstring): {', '.join(CONDITIONS)}")
    ap.add_argument("--scenario", default="clean_control",
                    help="the cell's scenario (pass B: runtime_stall)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "clean_control"),
                    help="each step's counters and the watchdog's stacks")
    ap.add_argument("--spin", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--stacks", action="store_true",
                    help="arm the faulthandler watchdog (docstring: it "
                         "crashed processes on the card's Python 3.12.3)")
    args = ap.parse_args(argv)
    bad = set(args.condition.split(",")) - set(CONDITIONS)
    if bad:
        ap.error(f"unknown --condition {sorted(bad)}")
    if args.spin is not None:
        return spin(args.spin)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("clean_control_rate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's passes
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    clock_sampler()
    clock_step_phases()
    clock_flag_names()
    apply_conditions(args.condition)
    if args.runs:
        return evaluator_runs(args.runs, dev, args)
    SPINNER.append(Spinner(args.out, f"{args.label}_{os.getpid()}"))
    if dev.type == "cuda":
        SMI.append(SmiSampler(args.out, f"{args.label}_{os.getpid()}"))
    try:
        if args.one_run:
            return one_run(args.one_run, dev, args.out, args.stacks)
        return cells_main(args, dev, ap)
    finally:
        if SPINNER:
            SPINNER.pop().close()
        if SMI:
            SMI.pop().close()


def cells_main(args, dev, ap) -> int:
    """``--mode``: the cells of pass A or B, one line each, and a summary."""
    import numpy as np

    if args.mode is None:
        ap.error("--mode is required without --runs")

    from repro_torch.diagnosis import Diagnoser
    from repro_torch.eval import matrix

    print(card(), flush=True)
    print(json.dumps({"process": cpu_quota()}), flush=True)
    floor = Diagnoser().min_mean_deficit
    n = 240  # chip_smoke.EVAL_STEPS
    if args.after_session:
        print(json.dumps({"after_session": threaded_session(dev)}),
              flush=True)
    one = (pass_a_cell(args.mode, dev, n, args.scenario)
           if args.pass_ == "a"
           else pass_b_cell(args.mode, dev, n, args.cells, args.scenario))
    cells, fixture_out, prior_s = [], None, 0.02
    tag = f"{args.label}_{args.pass_}_{args.scenario}_{args.mode}_" \
          f"{args.condition}"
    for cell in range(args.cells):
        watch = StepWatch(args.out, f"{tag}_cell{cell}", prior_s,
                          args.stacks)
        steal0 = steal_s()
        with recorded() as got, collections() as gcs:
            run = one(lambda session: watch_session(session, watch))
        report = run.report
        row = matrix._row(run)
        spans = watch.spans
        ms = np.asarray([p[0] for p in watch.phases])  # the STEP rows
        prior_s = float(np.median(ms)) / 1e3
        slow = np.flatnonzero(ms > np.median(ms) + SLOW_MS)
        incs = {i.incident_id: i for i in report.incidents}
        diagnosed = []
        for d in report.diagnoses:
            inc = incs[d.incident_id]
            g = got["groups"][d.incident_id]
            diagnosed.append(incident_line(inc, d, g, floor, watch))
            # the fixture: the first stall-free incident, else the first
            if args.fixture and (fixture_out is None or (
                    not fixture_out["stall_free"]
                    and diagnosed[-1]["stall_free"])):
                fixture_out = fixture(args.mode, inc, d, g,
                                      got["evidence"].get(d.incident_id, {}),
                                      args.label, diagnosed[-1])
        line = {"cell": cell, "label": args.label, "pass": args.pass_,
                "after_session": args.after_session, "mode": args.mode,
                "scenario": args.scenario, "condition": args.condition,
                "switch_interval_s": sys.getswitchinterval(),
                "far": row["metrics"]["false_alarm_rate"],
                "diagnoses": [d.fault_kind for d in report.diagnoses],
                "incidents": len(report.incidents),
                "incident_flags": [i.n_flags for i in report.incidents],
                "incident_mean_deficit": [
                    round(i.severity / max(i.n_flags, 1), 3)
                    for i in report.incidents],
                "slow_steps": len(slow),
                "slow_at": [int(i) for i in slow],
                "slow_excess_ms": [round(float(ms[i] - np.median(ms)), 3)
                                   for i in slow],
                "steal_s": steal_s() - steal0,
                "gc": gc_line(gcs, spans),
                "step_ms_p50_p90": np.percentile(ms, [50, 90]).tolist(),
                "flagged_steps": {k: [int(x) for x in v.anomalous_steps]
                                  for k, v in report.layers.items()
                                  if len(v.anomalous_steps)},
                "lasting_shift": lasting_shift(report, run.eval_start, n),
                "diagnosed": diagnosed, "wall_s": row["wall_s"],
                "xla_prefix": prefix_spread("xla"),
                "host": watch.summary()}
        print(json.dumps(line), flush=True)
        cells.append(line)
        del run, report
        gc.collect()
    if fixture_out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.fixture)),
                    exist_ok=True)
        with open(args.fixture, "w") as f:
            json.dump(fixture_out, f)
    print(json.dumps({"summary": {
        "label": args.label, "pass": args.pass_,
        "after_session": args.after_session, "mode": args.mode,
        "scenario": args.scenario, "condition": args.condition,
        "cells": len(cells),
        "diagnosed_cells": sum(bool(c["diagnoses"]) for c in cells),
        "lasting_shift_cells": sum(c["lasting_shift"] for c in cells),
        "kinds": sorted({k for c in cells for k in c["diagnoses"]}),
        "far_max": max(c["far"] for c in cells),
        "slow_steps_per_cell": float(np.mean([c["slow_steps"]
                                              for c in cells])),
        "gc_over_1ms_in_step_per_cell": float(np.mean(
            [c["gc"]["over_1ms_in_step"] for c in cells])),
        "stall_free": stall_free_shares(cells),
        **host_totals([c["host"] for c in cells]),
        "card": card()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
