"""The port's slice end to end on the CPU: monitored training with injected
faults -> per-layer GMM detection -> governance, the byte-identical feature
pipeline, the probes, and the guard that keeps `repro_torch` free of `jax`
and of the JAX package."""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import chaos as jchaos  # noqa: E402
from repro.core import detector as jdet  # noqa: E402
from repro.core import events as jevents  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import governor as jgov  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.config import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.core import (Collector, DetectionResult, FaultInjector,  # noqa: E402
                              FullStackMonitor, Governor, Layer)
from repro_torch.core import events as tevents  # noqa: E402
from repro_torch.core import features as tfeatures  # noqa: E402
from repro_torch.core.probes.device_probe import DeviceProbe, ProcStats  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.model import Runtime  # noqa: E402
from repro_torch.train.step import (init_train_state, make_optimizer_for,  # noqa: E402
                                    make_train_step)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CPU = "cpu"


def test_monitored_training_detects_injected_faults():
    """Port of tests/test_system.py::test_monitored_training_detects_injected_
    faults, same thresholds: anomalous steps must overlap the injected
    windows far above chance, and the governor must act. The step runs on
    one thread: timed steps that wait on a barrier of several threads on a
    loaded host vary by more than the injected latency."""
    cfg = reduced(get_arch("gpt2"))
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=120, warmup_steps=5)
    opt = make_optimizer_for(tcfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=0)
    state = init_train_state(cfg, opt, seed=0, device=CPU)
    step_fn = make_train_step(cfg, Runtime(torch.float32), opt)

    col = Collector.standard(device_interval=0.01)
    inj = FaultInjector.random_schedule(
        120, ["op_latency"], seed=7, anomaly_fraction=1 / 6,
        magnitudes={"op_latency": 0.03})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with col.monitoring():
            fn = col.observe_step_fn(step_fn)
            for s in range(120):
                inj.apply(s, col)
                state, m = fn(state, data.batch(s))
            inj.clear(col)
    finally:
        torch.set_num_threads(threads)
    events = col.drain()
    labels = inj.labels(120)
    clean = [e for e in events if 0 <= e.step < 120 and not labels[e.step]]
    mon = FullStackMonitor(n_components=3, min_events=32, device=CPU).fit(clean)
    results = mon.detect(events)
    assert Layer.STEP in results
    res = results[Layer.STEP]
    flagged = set(res.anomalous_steps().tolist())
    true_steps = set(np.nonzero(labels)[0].tolist())
    hit_rate = len(flagged & true_steps) / len(true_steps)
    false_rate = len(flagged - true_steps) / (120 - len(true_steps))
    assert hit_rate > 0.5, (hit_rate, false_rate)
    assert hit_rate > 2 * false_rate, (hit_rate, false_rate)
    assert Governor(rate_threshold=0.05).decide(results)
    assert col["device"].failed_samples == 0


def test_quickstart_reduced_on_cpu(capsys):
    assert quickstart.main(["--reduced", "--device", "cpu", "--steps",
                            "60"]) == 0
    out = capsys.readouterr().out
    assert "steps/s on cpu" in out and "step" in out


def synthetic_columns(n=3000, seed=0):
    """A multi-layer event table as the probes fill it: latency layers with
    a few names, device telemetry rows, collective messages, static rows."""
    rng = np.random.default_rng(seed)
    table = jevents.EventTable(2 * n)
    names = np.array(["train_step", "executable_run", "all-reduce", "gpu0"])
    for i in range(n):
        layer = [jevents.Layer.STEP, jevents.Layer.XLA,
                 jevents.Layer.COLLECTIVE, jevents.Layer.DEVICE][i % 4]
        tel = {}
        if layer == jevents.Layer.DEVICE:
            tel = dict(util=rng.uniform(0, 100), mem_gb=rng.uniform(1, 80),
                       power_w=rng.uniform(70, 700),
                       temp_c=rng.uniform(30, 80))
        table.append_rows(layer, names[i % 4] if i % 37 else "static/x",
                          float(i) * 1e-3 + rng.uniform(0, 1e-4),
                          dur=rng.lognormal(-4, 0.5),
                          size=float(rng.integers(0, 1 << 20)), step=i // 8,
                          pid=1 + i % 2, **tel)
    return table.drain_columns()


@pytest.mark.parametrize("layer", ["xla", "step", "collective", "device"])
def test_features_byte_identical_to_jax(layer):
    cols = synthetic_columns()
    ft = tfeatures.LayerFeaturizer(tevents.Layer(layer)).fit_transform(cols)
    fj = jfeatures.LayerFeaturizer(jevents.Layer(layer)).fit_transform(cols)
    assert ft.X.dtype == fj.X.dtype and ft.X.shape == fj.X.shape
    assert ft.X.tobytes() == fj.X.tobytes()
    np.testing.assert_array_equal(ft.steps, fj.steps)
    np.testing.assert_array_equal(ft.event_names, fj.event_names)
    assert ft.names == fj.names


def test_wire_schema_identical_to_jax():
    assert [l.value for l in tevents.LAYERS] == [l.value for l in
                                                 jevents.LAYERS]
    assert tevents.NAME_WIDTH == jevents.NAME_WIDTH == 64
    assert tevents.TELEMETRY_KEYS == jevents.TELEMETRY_KEYS
    assert tevents.COLUMN_SCHEMA == jevents.COLUMN_SCHEMA


def test_fault_schedules_and_governance_match_jax():
    kinds = ["op_latency", "hw_contention", "net_latency"]
    ft = FaultInjector.random_schedule(150, kinds, seed=3)
    fj = jchaos.FaultInjector.random_schedule(150, kinds, seed=3)
    assert ft.to_json() == fj.to_json()
    np.testing.assert_array_equal(ft.labels(150), fj.labels(150))
    rng = np.random.default_rng(0)
    flags = rng.random(200) < 0.3
    scores, steps = rng.random(200), np.arange(200)
    res_t = {Layer.STEP: DetectionResult(Layer.STEP, flags, scores, 0.0,
                                         steps)}
    res_j = {jevents.Layer.STEP: jdet.DetectionResult(
        jevents.Layer.STEP, flags, scores, 0.0, steps)}
    got = [(a.kind, a.reason, a.steps) for a in Governor(0.1).decide(res_t)]
    want = [(a.kind, a.reason, a.steps)
            for a in jgov.Governor(0.1).decide(res_j)]
    assert got == want and got


def test_proc_stats_read_this_process():
    stats = ProcStats()
    rss, cpu, threads = stats.sample()
    assert rss > 10 * 2**20 and cpu == 0.0 and threads >= 1
    t0 = time.process_time()
    while time.process_time() - t0 < 0.1:  # burn CPU past the clock tick
        sum(i * i for i in range(10_000))
    _, cpu, _ = stats.sample()
    assert cpu > 0.0


def test_device_probe_counts_failed_samples():
    probe = DeviceProbe(interval=0.005)

    def broken():
        raise OSError("telemetry source gone")

    probe.sample_once = broken
    probe.attach(tevents.EventTable(100))
    deadline = time.monotonic() + 5.0
    while probe.failed_samples < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    probe.detach()
    assert probe.failed_samples >= 3
    assert isinstance(probe.last_error, OSError)


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FullStackMonitor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.run(reduced_model=True, steps=2)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every repro_torch module in a fresh interpreter; neither `jax`
    nor `repro` (or any `repro.*`) may end up loaded."""
    mods = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(mods) > 30


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$|,)"
    r"|from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("from jax import numpy", True),
    ("import repro.core", True), ("from repro.core import gmm", True),
    ("from repro import config", True), ("import repro", True),
    ("import repro_torch.core", False), ("from repro_torch import x", False),
    ("import jaxlib_free_helper", False)])
def test_import_scan_respects_the_repro_torch_prefix(line, bad):
    assert bool(_FORBIDDEN.search(line)) is bad


def test_port_sources_and_chip_smoke_import_no_jax():
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{m.group(0).strip()}" for f in files
            for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
