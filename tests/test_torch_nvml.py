"""The device probe's NVML source and its sampler process, on the CPU.

NVML is read through a fake library that fills ``byref`` arguments as
`libnvidia-ml.so.1` would (units, return codes); the sampler process runs
for real with the telemetry model, its rows held to the in-process
sampler's schema and stamped with the step in flight; the chaos hooks move
real-style readings and `FaultInjector.clear` takes them back. The card's
own tests are in tests/test_torch_cuda.py."""
import ctypes
import importlib.util
import math
import mmap
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.chaos import Fault, FaultInjector
from repro_torch.core.events import EventTable, Layer, LAYER_CODE
from repro_torch.core.probes import device_sampler, nvml
from repro_torch.core.probes.collective_probe import CollectiveProbe
from repro_torch.core.probes.device_probe import DeviceProbe
from repro_torch.core.probes.step_probe import StepProbe
from repro_torch.session import registry

ROOT = Path(__file__).resolve().parents[1]
UUID = "GPU-12345678-abcd-ef01-2345-6789abcdef01"
GIB = 2**30


class FakeNvml:
    """A stand-in for ``libnvidia-ml.so.1``: each entry point a function
    that writes its outputs through ``byref`` and returns an
    ``nvmlReturn_t``; ``fail`` maps an entry point to the code it
    returns."""

    def __init__(self, util=57, total=80 * GIB, used=12 * GIB,
                 power_mw=312_500, temp=41, limit_mw=700_000, pid=None,
                 fail=None):
        self.fail = dict(fail or {})
        self.calls = []

        def entry(name, body=lambda *a: None):
            def fn(*args):
                self.calls.append(name)
                code = self.fail.get(name, nvml.NVML_SUCCESS)
                if code == nvml.NVML_SUCCESS:
                    body(*args)
                return code
            setattr(self, name, fn)

        def set_handle(uuid, ref):
            assert uuid == UUID.encode()
            ref._obj.value = 0xBEEF

        def set_util(h, ref):
            ref._obj.gpu, ref._obj.memory = util, 9

        def set_mem(h, ref):
            ref._obj.total, ref._obj.used = total, used
            ref._obj.free = total - used

        def set_uint(value):
            def body(*args):
                args[-1]._obj.value = value
            return body

        def set_procs(h, count, infos):
            if pid is None:
                count._obj.value = 0
                return
            infos[0].pid, infos[0].usedGpuMemory = 999, 3 * GIB
            infos[1].pid, infos[1].usedGpuMemory = pid, 5 * GIB
            count._obj.value = 2

        def set_uuid(h, buf, n):
            buf.value = UUID.encode()

        entry("nvmlInit_v2")
        entry("nvmlShutdown")
        entry("nvmlDeviceGetHandleByUUID", set_handle)
        entry("nvmlDeviceGetUUID", set_uuid)
        entry("nvmlDeviceGetUtilizationRates", set_util)
        entry("nvmlDeviceGetMemoryInfo", set_mem)
        entry("nvmlDeviceGetPowerUsage", set_uint(power_mw))
        entry("nvmlDeviceGetTemperature", set_uint(temp))
        entry("nvmlDeviceGetEnforcedPowerLimit", set_uint(limit_mw))
        entry("nvmlDeviceGetComputeRunningProcesses_v3", set_procs)
        self.nvmlErrorString = lambda code: f"fake error {code}".encode()


def test_reader_units_and_handle():
    lib = FakeNvml()
    reader = nvml.Nvml(lib=lib)
    h = reader.handle(UUID)
    assert h.value == 0xBEEF and reader.uuid(h) == UUID
    r = reader.reading(h)
    assert r == {"util": 57.0, "mem_gb": 12.0, "power_w": 312.5,
                 "temp_c": 41.0, "hbm_gb": 80.0}  # mW -> W, bytes -> GiB
    assert reader.power_limit_w(h) == 700.0
    reader.shutdown()
    reader.shutdown()  # once only
    assert lib.calls[0] == "nvmlInit_v2" and \
        lib.calls.count("nvmlShutdown") == 1


def test_reader_process_memory_finds_this_pid_or_says_not():
    reader = nvml.Nvml(lib=FakeNvml(pid=os.getpid()))
    h = reader.handle(UUID)
    assert reader.process_memory(h, os.getpid()) == (True, 5 * GIB)
    assert reader.process_memory(h, 1) == (True, None)  # listed, not ours
    unsupported = nvml.Nvml(lib=FakeNvml(fail={
        "nvmlDeviceGetComputeRunningProcesses_v3":
            nvml.NVML_ERROR_NOT_SUPPORTED}))
    assert unsupported.process_memory(h, os.getpid()) == (False, None)


@pytest.mark.parametrize("entry", ["nvmlDeviceGetUtilizationRates",
                                   "nvmlDeviceGetMemoryInfo",
                                   "nvmlDeviceGetPowerUsage",
                                   "nvmlDeviceGetTemperature"])
def test_reader_raises_on_a_return_code(entry):
    reader = nvml.Nvml(lib=FakeNvml(fail={entry: 15}))
    with pytest.raises(nvml.NvmlError, match=entry) as e:
        reader.reading(reader.handle(UUID))
    assert e.value.code == 15 and "fake error 15" in str(e.value)


def test_init_failure_raises():
    with pytest.raises(nvml.NvmlError, match="nvmlInit_v2"):
        nvml.Nvml(lib=FakeNvml(fail={"nvmlInit_v2": 9}))
    with pytest.raises(OSError):
        nvml.Nvml(path="libnvidia-ml-not-here.so.1")


class _Pipe:
    """The probe's view of a sampler process: the read end of a pipe that
    this test writes records into."""

    def __init__(self):
        r, self.w = os.pipe()
        os.set_blocking(r, False)
        self.stdout = os.fdopen(r, "rb", buffering=0)
        self.returncode = None

    def poll(self):
        return self.returncode

    def terminate(self):
        self.returncode = -15

    def wait(self, timeout=None):
        return self.returncode


def _nvml_probe_on(pipe, table):
    probe = DeviceProbe(source="nvml", sampler="process", uuids=[UUID])
    probe._sink, probe._attached, probe._t0 = table, True, 0.0
    probe._helper = pipe
    probe._mark_t, probe._mark_n = [-math.inf], [0]
    return probe


def test_failed_nvml_reads_are_counted_not_hidden():
    """A sweep whose NVML read fails reaches the job as a failed record:
    counted in ``failed_samples`` with its code, and no row."""
    lib = FakeNvml()
    sweeper = device_sampler.Sweeper(
        device_sampler.ProcStats(), device_sampler.NvmlSource(
            [UUID], os.getpid(), lib=lib), t0=time.perf_counter())
    table = EventTable(64)
    pipe = _Pipe()
    probe = _nvml_probe_on(pipe, table)
    os.write(pipe.w, sweeper.sweep())
    lib.fail["nvmlDeviceGetPowerUsage"] = 999
    os.write(pipe.w, sweeper.sweep())
    os.write(pipe.w, sweeper.sweep()[:10])  # a record not yet whole
    assert probe.drain() == 2  # one sweep: host.process + gpu0
    assert probe.failed_samples == 1
    assert isinstance(probe.last_error, nvml.NvmlError)
    assert probe.last_error.code == 999
    cols = table.drain_columns()
    assert list(cols["name"]) == ["host.process", "gpu0"]
    assert cols["util"][1] == 57.0 and cols["power_w"][1] == 312.5
    assert cols["mem_gb"][1] == 12.0 and cols["size"][1] == 12.0 * GIB
    assert probe.stats()["power_limit_w"] == []  # no hello here
    assert probe.reading_range["temp_c"] == [41.0, 41.0]
    os.close(pipe.w)


def test_a_sampler_that_dies_is_counted_once():
    table = EventTable(64)
    pipe = _Pipe()
    probe = _nvml_probe_on(pipe, table)
    os.close(pipe.w)
    pipe.returncode = 1
    probe.drain()
    assert probe.failed_samples == 1
    assert "exited with 1" in str(probe.last_error)
    assert probe.drain() == 0 and probe.failed_samples == 1


def test_nvml_on_cuda_never_falls_back_to_the_model(monkeypatch):
    """The ``nvml`` source reads the session's card in a sampler process;
    a library that will not load fails the attach, and the probe stays
    detached. The model stays the default source, and NVML needs a card."""
    monkeypatch.setattr(registry, "cuda_uuids", lambda i, n: [UUID] * n)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    probe = registry.build_probe("device", {"device": "cuda",
                                            "source": "nvml",
                                            "nvml_lib": "libnvml-gone.so.1"})
    assert (probe.source, probe.sampler, probe.uuids) == \
        ("nvml", "process", [UUID])
    assert not any(isinstance(d, device_sampler.GpuTelemetryModel)
                   for d in probe.devices)
    with pytest.raises(RuntimeError, match="nvml sampler did not start"):
        probe.attach(EventTable(64))
    assert not probe.attached and probe._helper is None
    for dev in ("cpu", "cuda"):
        model = registry.build_probe("device", {"device": dev})
        assert (model.source, model.sampler) == ("model", "thread")
    with pytest.raises(ValueError, match="reads a card"):
        registry.build_probe("device", {"device": "cpu", "source": "nvml"})
    with pytest.raises(ValueError, match="model or nvml"):
        registry.build_probe("device", {"source": "dcgm"})


def test_collector_detaches_what_it_attached_when_a_probe_fails(monkeypatch):
    from repro_torch.core.collector import Collector

    monkeypatch.setattr(registry, "cuda_uuids", lambda i, n: [UUID] * n)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    probes = registry.build_probes(
        ["python", "collective", "device", "step"],
        {"device": {"source": "nvml", "nvml_lib": "libnvml-gone.so.1"}},
        device="cuda")
    col = Collector(probes)
    with pytest.raises(RuntimeError, match="did not start"):
        col.attach()
    assert not any(p.attached for p in probes)
    assert sys.getprofile() is None


def _device_code():
    return LAYER_CODE[Layer.DEVICE]


def test_sampler_process_rows_match_the_thread_s_and_carry_the_step():
    """The sampler process (model source) against the in-process sampler:
    the same row names, columns and meta keys; every row stamped with the
    step in flight at its timestamp (the steps the probe had seen end by
    then)."""
    table = EventTable(100_000)
    probe = DeviceProbe(interval=0.01, sampler="process")
    step = StepProbe(device_probe=probe, flops_per_step=5e11)
    probe.current_step = lambda: step.step_count
    t0 = time.perf_counter()
    probe.attach(table, t0=t0)
    step.attach(table, t0=t0)
    assert probe._helper is not None and probe.power_limits_w == [700.0]
    fn = step.wrap(lambda: time.sleep(0.004))
    for _ in range(60):
        fn()
    step.detach()
    probe.detach()
    assert probe._helper is None and probe.failed_samples == 0
    cols = table.drain_columns()
    dev = cols["layer"] == _device_code()
    names = cols["name"][dev]
    assert len(names) >= 8 and len(names) % 2 == 0
    assert list(names[:2]) == ["host.process", "gpu0"]
    assert (names[0::2] == "host.process").all() and \
        (names[1::2] == "gpu0").all()
    # the in-process sampler's one sweep, for the schema
    ref_table = EventTable(16)
    ref = DeviceProbe()
    ref._sink, ref._attached, ref._t0 = ref_table, True, t0
    ref.sample_once()
    want = ref_table.drain_columns()
    for k in ("util", "mem_gb", "power_w", "temp_c"):
        got = cols[k][dev]
        assert np.isnan(got[0::2]).all() and np.isnan(want[k][0])
        assert np.isfinite(got[1::2]).all() and np.isfinite(want[k][1])
    meta = cols["meta"][dev]
    assert set(eval(meta[0].replace("true", "True"))) == \
        set(eval(want["meta"][0])) == {"cpu_pct", "threads"}
    assert (cols["pid"][dev] == os.getpid()).all()
    # stamps: the STEP rows' ends, on the probe's clock
    st = cols["layer"] == LAYER_CODE[Layer.STEP]
    ends = np.sort(cols["ts"][st] + cols["dur"][st])
    ts = cols["ts"][dev]
    want_steps = np.searchsorted(ends, ts, side="right")
    np.testing.assert_array_equal(cols["step"][dev], want_steps)
    assert cols["step"][dev].max() > cols["step"][dev].min()
    stats = probe.stats()
    assert stats["sweeps"] == len(names) // 2
    assert stats["drain_us_per_step"] is not None and stats["start_ms"] > 0


def _real_style(util=40.0, mem=20.0, power=300.0, temp=45.0):
    return {"util": util, "mem_gb": mem, "power_w": power, "temp_c": temp,
            "hbm_gb": 80.0}


def test_injection_moves_real_readings():
    import random

    plain = _real_style()
    assert device_sampler.inject(plain, 0.0, 0.0, random.Random(0),
                                 700.0) is plain
    hit = device_sampler.inject(plain, 0.8, 0.0, random.Random(0), 700.0)
    assert hit["util"] > plain["util"] + 30 and hit["util"] <= 100.0
    assert plain["mem_gb"] + 1.0 <= hit["mem_gb"] - 0.0 and \
        hit["mem_gb"] <= plain["mem_gb"] + 0.8 * 4.0
    assert plain["power_w"] < hit["power_w"] <= 700.0
    assert hit["temp_c"] == plain["temp_c"]  # a reading, not a model
    leak = device_sampler.inject(plain, 0.0, 6.5, random.Random(0), 700.0)
    assert leak["mem_gb"] == plain["mem_gb"] + 6.5
    assert leak["util"] == plain["util"]
    full = device_sampler.inject(_real_style(mem=79.0), 0.0, 6.5,
                                 random.Random(0), 700.0)
    assert full["mem_gb"] == 80.0  # no more than the card holds


def test_chaos_hooks_reach_the_sampler_and_clear(monkeypatch):
    """``hw_contention`` and ``mem_leak`` set on the probe's devices reach
    the sampler's control block and move its NVML readings; ``clear``
    takes them back."""
    probe = DeviceProbe(source="nvml", sampler="process", uuids=[UUID])
    size = device_sampler.control_struct(1).size
    probe._control = mmap.mmap(-1, size)  # the block the helper would map
    collector = {"step": StepProbe(), "collective": CollectiveProbe(),
                 "device": probe}
    source = device_sampler.NvmlSource([UUID], os.getpid(), lib=FakeNvml())
    sweeper = device_sampler.Sweeper(device_sampler.ProcStats(), source,
                                     t0=0.0, control=probe._control)
    rec = device_sampler.sample_struct(1)

    def reading():
        return rec.unpack(sweeper.sweep())[-4:]

    base = reading()
    assert base == (57.0, 12.0, 312.5, 41.0)
    inj = FaultInjector([Fault("hw_contention", 10, 15, 0.6),
                         Fault("mem_leak", 20, 25, 0.5)])
    inj.apply(11, collector)
    assert probe.devices[0].contention > 0
    util, mem, power, temp = reading()
    assert util > base[0] and mem >= base[1] + 1.0 and power > base[2]
    inj.apply(22, collector)  # leak at step 22: 0.5 GB x 3 steps
    assert probe.devices[0].contention == 0.0
    util, mem, _, _ = reading()
    assert util == base[0] and mem == pytest.approx(base[1] + 1.5)
    inj.clear(collector)
    assert reading() == base
    assert sweeper.knobs() == (0.0,) * 4


def test_model_in_the_sampler_takes_the_duty_from_the_control_block():
    probe = DeviceProbe(sampler="process")
    probe._control = mmap.mmap(-1, device_sampler.control_struct(1).size)
    sweeper = device_sampler.Sweeper(device_sampler.ProcStats(),
                                     device_sampler.ModelSource(1), t0=0.0,
                                     control=probe._control)
    probe.current_duty, probe.current_mem_gb = 0.9, 7.0
    probe.devices[0].mem_leak_gb = 2.0
    assert sweeper.knobs() == (0.9, 7.0, 0.0, 2.0)
    util, mem = device_sampler.sample_struct(1).unpack(
        sweeper.sweep())[-4:-2]
    assert util > 80.0 and mem == 9.0


def test_sampler_imports_neither_torch_nor_numpy():
    """The sampler process runs its file by path: no package, no torch."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(Path(device_sampler.__file__))!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'repro_torch', 'jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-s", "-c", code], env=env,
                         cwd=os.path.dirname(device_sampler.__file__),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "--source" in out.stdout


def _script():
    spec = importlib.util.spec_from_file_location(
        "clean_control_rate", ROOT / "scripts" / "clean_control_rate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nosampler_condition_attaches_without_sampling(monkeypatch):
    mod = _script()
    assert {"nosampler", "model"} <= set(mod.CONDITIONS)
    monkeypatch.setattr(DeviceProbe, "_attach", DeviceProbe._attach)
    mod.apply_condition("nosampler")
    probe = DeviceProbe(interval=0.001)
    table = EventTable(64)
    probe.attach(table)
    time.sleep(0.05)
    assert probe.attached and probe._thread is None
    probe.detach()
    assert table.drain_columns()["name"].size == 0
