"""The device probe's sampler, as a process of its own.

A sweep of the device layer (the job's /proc figures, then one reading a
device) runs here, outside the job's interpreter, so it takes no time from
the job's threads and never holds the job's GIL. `DeviceProbe` starts this
file by path with `subprocess` (never `fork`: the job holds CUDA contexts
and threads); the file imports the standard library and its sibling
`nvml.py` only, never torch.

    python device_sampler.py --pid PID --t0 T0 --interval S \\
        --source nvml --uuids GPU-...[,GPU-...] [--lib libnvidia-ml.so.1] \\
        [--control-fd FD]
    python device_sampler.py ... --source model --n-devices N [--peak-w W]

It writes to stdout one `hello_struct` record (NVML's power limit a device,
or why it could not start), then one `sample_struct` record a sweep: fixed
size, little-endian, each under PIPE_BUF so a write is whole. Timestamps
are ``perf_counter() - t0``: CLOCK_MONOTONIC, shared with the job, on the
probe's clock. A sweep that fails is a record with a non-zero status,
which the job counts as a failed sample. The job's chaos knobs and the step
probe's duty cycle come in through ``--control-fd``, a shared-memory block
of `control_struct` doubles. The sampler exits when the job does.
"""
from __future__ import annotations

import argparse
import mmap
import os
import random
import struct
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

if __package__:
    from repro_torch.core.probes import nvml
else:  # started by path: the package (and torch with it) stays out
    import nvml

# H100 SXM: dense bf16 tensor-core peak, HBM size, board power limit
# (NVIDIA's data sheet). A card may run under a lower power limit; NVML
# reads the enforced one on the card, and the model takes it as ``peak_w``.
H100_PEAK_FLOPS = 989e12
H100_HBM_GB = 80.0
H100_POWER_LIMIT_W = 700.0
IDLE_W = 70.0

MAGIC = b"DSv1"
OK, FAILED_NVML, FAILED_OS = 0, 1, 2  # a record's status
NAN = float("nan")


def hello_struct(n: int) -> struct.Struct:
    """magic, status, NVML code, message, power limit W a device."""
    return struct.Struct(f"<4sii256s{n}d")


def sample_struct(n: int) -> struct.Struct:
    """status, code, ts, sweep ms, rss bytes, cpu %, threads, processes the
    GPU driver listed (-1: not answered), the job's own GB on device 0 (NaN:
    not listed), then (util, mem_gb, power_w, temp_c) a device."""
    return struct.Struct(f"<ii7d{4 * n}d")


def control_struct(n: int) -> struct.Struct:
    """duty, mem_gb (the step probe's), then (contention, mem_leak_gb) a
    device (the chaos hooks')."""
    return struct.Struct(f"<2d{2 * n}d")


class GpuTelemetryModel:
    """Telemetry simulator for one device: first-order thermal/power model
    (the CPU's device source)."""

    def __init__(self, peak_flops: float = H100_PEAK_FLOPS,
                 hbm_gb: float = H100_HBM_GB, idle_w: float = IDLE_W,
                 peak_w: float = H100_POWER_LIMIT_W, ambient_c: float = 30.0,
                 seed: int = 0):
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


def inject(reading: Dict[str, float], contention: float, leak_gb: float,
           rng: random.Random, limit_w: float) -> Dict[str, float]:
    """The chaos hooks on a real reading, as DCGM's error injection sets
    field values: the model's formulas where they apply to a reading.
    Contention takes a share of the card (util up, memory up by 1-4 GB,
    power up with the duty, to the limit); a leak adds its GB. The card
    itself is not loaded."""
    if not contention and not leak_gb:
        return reading
    out = dict(reading)
    if contention:
        duty = reading["util"] / 100.0
        loaded = min(1.0, max(0.0, duty + contention * rng.uniform(0.5, 1.0)))
        out["util"] = 100.0 * loaded
        out["power_w"] = min(limit_w, reading["power_w"]
                             + (limit_w - IDLE_W) * (loaded - duty))
        leak_gb += contention * rng.uniform(1.0, 4.0)
    out["mem_gb"] = min(reading["hbm_gb"], reading["mem_gb"] + leak_gb)
    return out


class ProcStats:
    """A process's RSS, CPU share and thread count from /proc (what
    psutil's ``Process`` reports, without psutil)."""

    def __init__(self, pid: Optional[int] = None):
        self.pid = "self" if pid is None else str(pid)
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._tick = os.sysconf("SC_CLK_TCK")
        self._last: Optional[Tuple[float, float]] = None  # (cpu s, wall s)

    def sample(self) -> Tuple[float, float, int]:
        """(rss bytes, cpu percent since the previous sample, threads). The
        first sample's cpu percent is 0.0, as psutil's first call gives."""
        base = f"/proc/{self.pid}"
        with open(f"{base}/statm") as f:
            rss = float(int(f.read().split()[1]) * self._page)
        threads = 0
        with open(f"{base}/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    threads = int(line.split()[1])
                    break
        with open(f"{base}/stat") as f:
            stat = f.read()
        fields = stat[stat.rindex(")") + 2:].split()  # utime, stime: 14, 15
        now = ((int(fields[11]) + int(fields[12])) / self._tick,
               time.monotonic())
        cpu = 0.0
        if self._last is not None and now[1] > self._last[1]:
            cpu = 100.0 * (now[0] - self._last[0]) / (now[1] - self._last[1])
        self._last = now
        return rss, cpu, threads


class ModelSource:
    """`GpuTelemetryModel` devices fed the step probe's duty cycle."""

    def __init__(self, n: int, peak_w: float = H100_POWER_LIMIT_W):
        self.devices = [GpuTelemetryModel(peak_w=peak_w, seed=i)
                        for i in range(n)]
        self.power_limits = [peak_w] * n

    def read(self, knobs: Sequence[float]) -> Tuple[List[Tuple], float, float]:
        duty, mem = knobs[0], knobs[1]
        out = []
        for i, dev in enumerate(self.devices):
            dev.contention, dev.mem_leak_gb = knobs[2 + 2 * i:4 + 2 * i]
            r = dev.sample(duty, mem)
            out.append((r["util"], r["mem_gb"], r["power_w"], r["temp_c"]))
        return out, -1.0, NAN

    def close(self) -> None:
        pass


class NvmlSource:
    """The cards named by UUID, read through NVML, the chaos knobs on top
    (`inject`); device 0's process list searched for ``pid``."""

    def __init__(self, uuids: Sequence[str], pid: int,
                 lib_path: str = nvml.LIBRARY, lib=None, seed: int = 0):
        self.nvml = nvml.Nvml(lib=lib, path=lib_path)
        try:
            self.handles = [self.nvml.handle(u) for u in uuids]
            self.power_limits = [self.nvml.power_limit_w(h)
                                 for h in self.handles]
        except nvml.NvmlError:
            self.nvml.shutdown()
            raise
        self.pid = pid
        self._rng = random.Random(seed)

    def read(self, knobs: Sequence[float]) -> Tuple[List[Tuple], float, float]:
        out = []
        for i, h in enumerate(self.handles):
            r = inject(self.nvml.reading(h), knobs[2 + 2 * i],
                       knobs[3 + 2 * i], self._rng, self.power_limits[i])
            out.append((r["util"], r["mem_gb"], r["power_w"], r["temp_c"]))
        answered, own = self.nvml.process_memory(self.handles[0], self.pid)
        listed = 1.0 if answered else -1.0
        return out, listed, (NAN if own is None else own / 2**30)

    def close(self) -> None:
        self.nvml.shutdown()


class Sweeper:
    """One sweep a call: the job's /proc figures and the source's
    readings, packed as a `sample_struct` record; a failed read packs a
    failed record (counted by the job, never hidden)."""

    def __init__(self, proc: ProcStats, source, t0: float,
                 control: Optional[mmap.mmap] = None):
        self.proc, self.source, self.t0 = proc, source, t0
        self.n = len(source.power_limits)
        self.record = sample_struct(self.n)
        self.control = control
        self._knobs = control_struct(self.n)

    def knobs(self) -> Tuple[float, ...]:
        if self.control is None:
            return (0.0,) * (2 + 2 * self.n)
        return self._knobs.unpack_from(self.control)

    def sweep(self) -> bytes:
        start = time.perf_counter()
        status, code, err = OK, 0, None
        try:
            rss, cpu, threads = self.proc.sample()
            devs, listed, own = self.source.read(self.knobs())
        except nvml.NvmlError as e:
            status, code, err = FAILED_NVML, e.code, e
        except OSError as e:
            status, code, err = FAILED_OS, e.errno or 0, e
        if err is not None:
            print(f"device sampler: sweep failed: {err!r}", file=sys.stderr,
                  flush=True)
            rss = cpu = threads = listed = own = NAN
            devs = [(NAN,) * 4] * self.n
        ms = 1e3 * (time.perf_counter() - start)
        return self.record.pack(status, code, start - self.t0, ms, rss, cpu,
                                threads, listed, own,
                                *[v for d in devs for v in d])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--t0", type=float, required=True)
    ap.add_argument("--interval", type=float, default=0.25)
    ap.add_argument("--source", choices=("nvml", "model"), required=True)
    ap.add_argument("--uuids", default="")
    ap.add_argument("--n-devices", type=int, default=1)
    ap.add_argument("--lib", default=nvml.LIBRARY)
    ap.add_argument("--peak-w", type=float, default=H100_POWER_LIMIT_W)
    ap.add_argument("--control-fd", type=int, default=-1)
    args = ap.parse_args(argv)
    uuids = [u for u in args.uuids.split(",") if u]
    n = len(uuids) if args.source == "nvml" else args.n_devices
    hello = hello_struct(n)
    try:
        source = (NvmlSource(uuids, args.pid, args.lib)
                  if args.source == "nvml" else ModelSource(n, args.peak_w))
    except (OSError, nvml.NvmlError) as e:
        os.write(1, hello.pack(MAGIC, FAILED_NVML, getattr(e, "code", 0),
                               repr(e).encode()[:255], *[NAN] * n))
        return 1
    control = (mmap.mmap(args.control_fd, control_struct(n).size)
               if args.control_fd >= 0 else None)
    sweeper = Sweeper(ProcStats(args.pid), source, args.t0, control)
    os.write(1, hello.pack(MAGIC, OK, 0, b"", *source.power_limits))
    parent = os.getppid()
    next_t = time.perf_counter()
    try:
        while os.getppid() == parent:  # the job is gone: so is its sampler
            next_t += args.interval
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:  # fell behind: the next tick from now, no burst
                next_t = time.perf_counter()
            os.write(1, sweeper.sweep())
    except BrokenPipeError:  # the job closed its end
        pass
    finally:
        source.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
