"""Device-layer probe: the libnvml analogue.

Two sources, matching the paper's split between process-level and global GPU
monitoring:

* **Host truth** (/proc): per-process RSS, CPU time, thread count —
  genuinely non-intrusive measurements of the running training process, read
  from ``/proc/<pid>/statm``, ``status`` and ``stat``.
* **The card**: ``source="model"`` (the default), a model of an H100
  (`GpuTelemetryModel`) driven by the step probe's duty cycle;
  ``source="nvml"``, a real card's utilisation, memory, power and
  temperature through NVML (`nvml.py`, ctypes), matched to torch's device
  by UUID. Both fill the same row schema. Chaos hooks inject contention
  and leaks into either (`device_sampler.inject` on real readings, as
  DCGM's error injection sets field values).

Two samplers. ``sampler="thread"`` (the model's, the reference's design): a
thread in the job's interpreter sweeps every ``interval``.
``sampler="process"`` (NVML's): the sweeps run in a sampler process
(`device_sampler.py`) that writes fixed-size records to a pipe; the job
only drains finished records into one `append_rows` block at the step
probe's step end, after the step's timed window (`step_done`).
"""
from __future__ import annotations

import mmap
import os
import select
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.probes import device_sampler
from repro_torch.core.probes.base import Probe
from repro_torch.core.probes.device_sampler import (  # noqa: F401
    H100_HBM_GB, H100_PEAK_FLOPS, H100_POWER_LIMIT_W, GpuTelemetryModel,
    ProcStats)
from repro_torch.core.probes.nvml import LIBRARY, NvmlError

HELPER = device_sampler.__file__
HELLO_TIMEOUT_S = 30.0
TELEMETRY = ("util", "mem_gb", "power_w", "temp_c")


class Knobs:
    """One device's chaos hooks (``contention``, ``mem_leak_gb``) when the
    sweeps run in the sampler process: each write reaches its control
    block, which it reads at every sweep."""

    def __init__(self, probe: "DeviceProbe"):
        self._probe = probe
        self._contention = 0.0
        self._mem_leak_gb = 0.0

    @property
    def contention(self) -> float:
        return self._contention

    @contention.setter
    def contention(self, v: float) -> None:
        self._contention = float(v)
        self._probe._write_control()

    @property
    def mem_leak_gb(self) -> float:
        return self._mem_leak_gb

    @mem_leak_gb.setter
    def mem_leak_gb(self, v: float) -> None:
        self._mem_leak_gb = float(v)
        self._probe._write_control()


def cuda_uuids(index: int, n: int) -> List[str]:
    """NVML's names (``GPU-...``) of torch's devices ``index..index+n``."""
    import torch

    return [f"GPU-{torch.cuda.get_device_properties(i).uuid}"
            for i in range(index, index + n)]


class DeviceProbe(Probe):
    name = "device"

    def __init__(self, interval: float = 0.25, n_devices: int = 1,
                 telemetry: Optional[List[GpuTelemetryModel]] = None,
                 source: str = "model", sampler: str = "thread",
                 uuids: Optional[Sequence[str]] = None,
                 nvml_lib: str = LIBRARY,
                 peak_w: float = H100_POWER_LIMIT_W):
        super().__init__()
        if source not in ("model", "nvml") or \
                sampler not in ("thread", "process"):
            raise ValueError(f"device probe: source {source!r}, sampler "
                             f"{sampler!r}")
        if source == "nvml" and sampler != "process":
            raise ValueError("device probe: NVML is read in the sampler "
                             "process (sampler='process')")
        self.interval = interval
        self.source, self.sampler = source, sampler
        self.uuids = list(uuids or [])
        self.nvml_lib, self.peak_w = nvml_lib, peak_w
        if sampler == "thread":
            self.devices: List[Any] = telemetry or [
                GpuTelemetryModel(peak_w=peak_w, seed=i)
                for i in range(n_devices)]
        else:
            n = len(self.uuids) if source == "nvml" else n_devices
            if not n:
                raise ValueError("device probe: NVML needs the cards' UUIDs")
            self.devices = [Knobs(self) for _ in range(n)]
        self._dev_names = np.array([f"gpu{i}"
                                    for i in range(len(self.devices))])
        self._proc = ProcStats()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # sweeps that failed (the sampler keeps running; a run checks this
        # stays 0), and a sampler process that died counts once
        self.failed_samples = 0
        self.last_error: Optional[BaseException] = None
        # fed by the step probe:
        self._duty = 0.0
        self._mem_gb = 0.0
        # the sampler process (sampler="process")
        self._helper: Optional[subprocess.Popen] = None
        self._control: Optional[mmap.mmap] = None
        self._pending = bytearray()
        # a sweep's rows: host.process, then a row a device
        self._sweep_names = np.array(["host.process", *self._dev_names])
        self._record = device_sampler.sample_struct(len(self.devices))
        self._dtype = np.dtype([("status", "<i4"), ("code", "<i4"),
                                ("ts", "<f8"), ("sweep_ms", "<f8"),
                                ("rss", "<f8"), ("cpu", "<f8"),
                                ("threads", "<f8"), ("listed", "<f8"),
                                ("own_gb", "<f8"),
                                ("tele", "<f8", (len(self.devices), 4))])
        # steps as the step probe counts them: (probe time, count from then)
        self._mark_t: List[float] = []
        self._mark_n: List[int] = []
        self.power_limits_w: List[float] = []
        self.start_ms = 0.0
        self.sweep_ms: List[float] = []
        self.drain_s, self.drains = 0.0, 0
        self.reading_range: Dict[str, List[float]] = {}
        self.process_memory = {"answered": None, "pid_found": False,
                               "gb": None}

    # -- the step probe's feed ----------------------------------------------
    @property
    def current_duty(self) -> float:
        return self._duty

    @current_duty.setter
    def current_duty(self, v: float) -> None:
        self._duty = float(v)
        self._write_control()

    @property
    def current_mem_gb(self) -> float:
        return self._mem_gb

    @current_mem_gb.setter
    def current_mem_gb(self, v: float) -> None:
        self._mem_gb = float(v)
        self._write_control()

    def _write_control(self) -> None:
        if self._control is not None:
            device_sampler.control_struct(len(self.devices)).pack_into(
                self._control, 0, self._duty, self._mem_gb,
                *[v for d in self.devices
                  for v in (d.contention, d.mem_leak_gb)])

    # -- lifecycle -------------------------------------------------------------
    def _attach(self) -> None:
        if self.sampler == "process":
            self._start_helper()
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _detach(self) -> None:
        if self._helper is not None:
            self.drain()
            self._stop_helper()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _start_helper(self) -> None:
        """Start the sampler process and wait for its hello: the cards'
        power limits, or why NVML could not start (an error here, never a
        move to the model)."""
        t = time.perf_counter()
        n = len(self.devices)
        size = device_sampler.control_struct(n).size
        fd = os.memfd_create("device-sampler-control")
        try:
            os.ftruncate(fd, size)
            self._control = mmap.mmap(fd, size)
            self._write_control()
            cmd = [sys.executable, "-s", HELPER, "--pid", str(os.getpid()),
                   "--t0", repr(self._t0), "--interval", repr(self.interval),
                   "--source", self.source, "--control-fd", str(fd)]
            cmd += (["--uuids", ",".join(self.uuids), "--lib", self.nvml_lib]
                    if self.source == "nvml" else
                    ["--n-devices", str(n), "--peak-w", repr(self.peak_w)])
            self._helper = subprocess.Popen(
                cmd, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                pass_fds=(fd,))
        except BaseException:
            if self._control is not None:
                self._control.close()
                self._control = None
            raise
        finally:
            os.close(fd)  # the mmap and the sampler hold their own
        hello = device_sampler.hello_struct(n)
        raw = self._read_exactly(hello.size)
        magic, status, code, msg, *limits = hello.unpack(raw) if \
            len(raw) == hello.size else (b"", -1, 0, b"no hello", [])
        if magic != device_sampler.MAGIC or status != device_sampler.OK:
            self._stop_helper()
            text = msg.rstrip(b"\0").decode(errors="replace")
            raise RuntimeError(
                f"device probe: the {self.source} sampler did not start "
                f"(status {status}, code {code}): {text}")
        os.set_blocking(self._helper.stdout.fileno(), False)
        self.power_limits_w = [float(x) for x in limits]
        self._mark_t, self._mark_n = [-float("inf")], [self.current_step()]
        self.start_ms = 1e3 * (time.perf_counter() - t)

    def _read_exactly(self, size: int) -> bytes:
        fd = self._helper.stdout.fileno()
        out = b""
        deadline = time.monotonic() + HELLO_TIMEOUT_S
        while len(out) < size:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                break
            chunk = os.read(fd, size - len(out))
            if not chunk:
                break
            out += chunk
        return out

    def _stop_helper(self) -> None:
        proc, self._helper = self._helper, None
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        if self._control is not None:
            self._control.close()
            self._control = None

    # -- the sampler process's records --------------------------------------------------
    def step_done(self, t: float, count: int) -> None:
        """The step probe's step end: from probe time ``t`` on, ``count``
        steps have run. Drains the sampler's finished records."""
        if self._helper is None:
            return
        self._mark_t.append(t)
        self._mark_n.append(count)
        if len(self._mark_t) > 4096:  # no record for thousands of steps
            del self._mark_t[:2048], self._mark_n[:2048]
        self.drain()

    def drain(self) -> int:
        """Append the sampler's finished sweeps as DEVICE rows, one block,
        each row stamped with the step in flight at its timestamp; count
        the failed ones. Returns the rows appended."""
        if self._helper is None:
            return 0
        t = time.perf_counter()
        fd = self._helper.stdout.fileno()
        gone = False
        try:
            while True:
                chunk = os.read(fd, 1 << 16)
                if not chunk:
                    gone = True
                    break
                self._pending += chunk
                if len(chunk) < 1 << 16:
                    break
        except BlockingIOError:
            pass
        if gone and self._helper.poll() is not None:
            self.failed_samples += 1
            self.last_error = RuntimeError(
                f"device sampler exited with {self._helper.returncode}")
            self._stop_helper()
        size = self._record.size
        whole = len(self._pending) - len(self._pending) % size
        n = 0
        if whole:
            recs = np.frombuffer(bytes(self._pending[:whole]), self._dtype)
            del self._pending[:whole]
            n = self._emit(recs)
        self.drain_s += time.perf_counter() - t
        self.drains += 1
        return n

    def _emit(self, recs: np.ndarray) -> int:
        bad = recs["status"] != device_sampler.OK
        if bad.any():
            self.failed_samples += int(bad.sum())
            code = int(recs["code"][bad][-1])
            self.last_error = (
                NvmlError("device sampler", code)
                if int(recs["status"][bad][-1]) == device_sampler.FAILED_NVML
                else OSError(code, os.strerror(code)))
            recs = recs[~bad]
        m, d = len(recs), len(self.devices)
        if not m:
            return 0
        self.sweep_ms.extend(recs["sweep_ms"].tolist())
        tele = recs["tele"]  # (m, d, 4)
        self._note_range(tele.min(axis=(0, 1)).tolist(),
                         tele.max(axis=(0, 1)).tolist())
        listed, own = recs["listed"][-1], recs["own_gb"][-1]
        self.process_memory = {"answered": bool(listed >= 0),
                               "pid_found": bool(np.isfinite(own)),
                               "gb": float(own) if np.isfinite(own) else None}
        idx = np.searchsorted(self._mark_t, recs["ts"], side="right") - 1
        steps = np.asarray(self._mark_n)[idx]
        # the sampler writes in time order: marks before the last record's
        # own are spent
        del self._mark_t[:idx[-1]], self._mark_n[:idx[-1]]
        w = 1 + d  # each sweep: its host.process row, then a row a device
        rows = np.full((m, w, 4), np.nan)
        rows[:, 1:] = tele
        size = np.empty((m, w))
        size[:, 0], size[:, 1:] = recs["rss"], tele[..., 1] * 2**30
        meta = np.full(m * w, "", dtype=object)
        meta[::w] = [f'{{"cpu_pct":{c},"threads":{int(n)}}}'
                     for c, n in zip(recs["cpu"].tolist(),
                                     recs["threads"].tolist())]
        rows = rows.reshape(m * w, 4)
        return self.emit_rows(Layer.DEVICE, np.tile(self._sweep_names, m),
                              np.repeat(recs["ts"], w), size=size.ravel(),
                              pid=os.getpid(), step=np.repeat(steps, w),
                              meta=meta, util=rows[:, 0], mem_gb=rows[:, 1],
                              power_w=rows[:, 2], temp_c=rows[:, 3])

    def _note_range(self, lo, hi) -> None:
        """Widen each reading's [min, max] over the run by (4,) lo, hi."""
        for key, a, b in zip(TELEMETRY, lo, hi):
            was = self.reading_range.get(key)
            self.reading_range[key] = [a, b] if was is None else \
                [min(was[0], a), max(was[1], b)]

    def stats(self) -> Dict[str, Any]:
        """What a run of this probe read and cost: the source, the cards'
        UUIDs and power limits as NVML reads them, each reading's min and
        max, the job's own memory as the GPU driver lists it, the sampler
        process's start ms, each sweep's ms (the thread's run in the job's
        interpreter, the process's beside it), the job-side drain's µs a
        step, failed samples."""
        sweeps = np.asarray(self.sweep_ms)
        return {
            "source": self.source, "sampler": self.sampler,
            "uuids": self.uuids, "power_limit_w": self.power_limits_w,
            "reading_min_max": self.reading_range,
            "process_memory": self.process_memory,
            "start_ms": self.start_ms, "sweeps": len(sweeps),
            "sweep_ms_p50_p99": (np.percentile(sweeps, [50, 99]).tolist()
                                 if len(sweeps) else None),
            "drain_us_per_step": (1e6 * self.drain_s / self.drains
                                  if self.drains else None),
            "failed_samples": self.failed_samples,
            "last_error": repr(self.last_error) if self.last_error else None}

    # -- the in-process sampler (sampler="thread") -------------------------------
    def sample_once(self) -> None:
        """One telemetry sweep: host-truth row + one row per device, each
        with its telemetry in the dedicated columns (no meta dicts)."""
        ts = self.now()
        pid = os.getpid()
        rss, cpu, nthreads = self._proc.sample()
        self.emit_rows(Layer.DEVICE, "host.process", ts, size=rss,
                       pid=pid,
                       meta=f'{{"cpu_pct":{cpu},"threads":{nthreads}}}')
        samples = [dev.sample(self._duty, self._mem_gb)
                   for dev in self.devices]
        vals = [[m[k] for m in samples] for k in TELEMETRY]
        self._note_range([min(v) for v in vals], [max(v) for v in vals])
        mem = np.array([m["mem_gb"] for m in samples])
        self.emit_rows(Layer.DEVICE, self._dev_names, ts, size=mem * 2**30,
                       pid=pid,
                       util=np.array([m["util"] for m in samples]),
                       mem_gb=mem,
                       power_w=np.array([m["power_w"] for m in samples]),
                       temp_c=np.array([m["temp_c"] for m in samples]))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            t = time.perf_counter()
            try:
                self.sample_once()
            except Exception as e:  # keep sampling; count what was lost
                self.failed_samples += 1
                self.last_error = e
            self.sweep_ms.append(1e3 * (time.perf_counter() - t))
