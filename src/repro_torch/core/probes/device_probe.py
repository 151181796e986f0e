"""Device-layer probe: the libnvml analogue.

Two sources, matching the paper's split between process-level and global GPU
monitoring:

* **Host truth** (/proc): per-process RSS, CPU time, thread count —
  genuinely non-intrusive measurements of the running training process, read
  from ``/proc/self/statm``, ``/proc/self/status`` and `os.times`.
* **Accelerator telemetry model**: a simulator of an H100 driven by the
  step probe's duty cycle and memory figures, producing utilisation / memory
  / power / temperature streams with the same statistical structure nvml
  gives the paper. Chaos hooks inject contention. Real NVML readings are a
  later slice of the port.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.probes.base import Probe

# H100 SXM: dense bf16 tensor-core peak, HBM size, board power limit
# (NVIDIA's data sheet). A card may run under a lower power limit; pass the
# one `nvidia-smi --query-gpu=power.limit` reports as ``peak_w``.
H100_PEAK_FLOPS = 989e12
H100_HBM_GB = 80.0
H100_POWER_LIMIT_W = 700.0


class GpuTelemetryModel:
    """Telemetry simulator for one device: first-order thermal/power model."""

    def __init__(self, peak_flops: float = H100_PEAK_FLOPS,
                 hbm_gb: float = H100_HBM_GB, idle_w: float = 70.0,
                 peak_w: float = H100_POWER_LIMIT_W, ambient_c: float = 30.0,
                 seed: int = 0):
        import random

        self.peak_flops = peak_flops
        self.hbm_gb = hbm_gb
        self.idle_w = idle_w
        self.peak_w = peak_w
        self.temp_c = ambient_c
        self.ambient_c = ambient_c
        self._rng = random.Random(seed)
        # chaos hooks
        self.contention = 0.0  # 0..1 fraction of the device stolen
        self.mem_leak_gb = 0.0

    def sample(self, duty: float, mem_gb: float) -> Dict[str, float]:
        duty = min(1.0, max(0.0, duty + self.contention * self._rng.uniform(0.5, 1.0)))
        mem = min(self.hbm_gb, mem_gb + self.mem_leak_gb
                  + self.contention * self._rng.uniform(1.0, 4.0))
        power = self.idle_w + (self.peak_w - self.idle_w) * duty
        power *= 1 + 0.03 * self._rng.gauss(0, 1)
        # first-order thermal relaxation toward power-determined equilibrium
        target = self.ambient_c + 50.0 * power / self.peak_w
        self.temp_c += 0.2 * (target - self.temp_c) + 0.3 * self._rng.gauss(0, 1)
        return {
            "util": 100.0 * duty * (1 + 0.02 * self._rng.gauss(0, 1)),
            "mem_gb": mem,
            "power_w": power,
            "temp_c": self.temp_c,
        }


class ProcStats:
    """This process's RSS, CPU share and thread count from /proc and
    `os.times` (what psutil's ``Process`` reports, without psutil)."""

    def __init__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._last: Optional[Tuple[float, float]] = None  # (cpu s, wall s)

    def sample(self) -> Tuple[float, float, int]:
        """(rss bytes, cpu percent since the previous sample, threads). The
        first sample's cpu percent is 0.0, as psutil's first call gives."""
        with open("/proc/self/statm") as f:
            rss = float(int(f.read().split()[1]) * self._page)
        threads = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    threads = int(line.split()[1])
                    break
        t = os.times()
        now = (t.user + t.system, time.monotonic())
        cpu = 0.0
        if self._last is not None and now[1] > self._last[1]:
            cpu = 100.0 * (now[0] - self._last[0]) / (now[1] - self._last[1])
        self._last = now
        return rss, cpu, threads


class DeviceProbe(Probe):
    name = "device"

    def __init__(self, interval: float = 0.25, n_devices: int = 1,
                 telemetry: Optional[List[GpuTelemetryModel]] = None):
        super().__init__()
        self.interval = interval
        self.devices = telemetry or [GpuTelemetryModel(seed=i)
                                     for i in range(n_devices)]
        self._dev_names = np.array([f"gpu{i}"
                                    for i in range(len(self.devices))])
        self._proc = ProcStats()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # sweeps of the sampling thread that raised (the loop keeps running;
        # a run checks this stays 0)
        self.failed_samples = 0
        self.last_error: Optional[BaseException] = None
        # fed by the step probe:
        self.current_duty = 0.0
        self.current_mem_gb = 0.0

    def _attach(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _detach(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def sample_once(self) -> None:
        """One telemetry sweep: host-truth row + one row per device, each
        with its telemetry in the dedicated columns (no meta dicts)."""
        ts = self.now()
        pid = os.getpid()
        rss, cpu, nthreads = self._proc.sample()
        self.emit_rows(Layer.DEVICE, "host.process", ts, size=rss,
                       pid=pid,
                       meta=f'{{"cpu_pct":{cpu},"threads":{nthreads}}}')
        samples = [dev.sample(self.current_duty, self.current_mem_gb)
                   for dev in self.devices]
        mem = np.array([m["mem_gb"] for m in samples])
        self.emit_rows(Layer.DEVICE, self._dev_names, ts, size=mem * 2**30,
                       pid=pid,
                       util=np.array([m["util"] for m in samples]),
                       mem_gb=mem,
                       power_w=np.array([m["power_w"] for m in samples]),
                       temp_c=np.array([m["temp_c"] for m in samples]))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception as e:  # keep sampling; count what was lost
                self.failed_samples += 1
                self.last_error = e
