"""The port's probe suite against the JAX package's (tests/test_probes.py's
checks, on torch): the python probe's hook, the operator probe's aten-op
walk and FLOP counts, the CUDA-runtime probe's hooks and detection-zone
guard, and the suite's non-intrusiveness. Everything runs on the CPU; the
runtime probe's graph-launch path needs a card and is held in
tests/test_torch_cuda.py.

Tolerances: FLOP counts and losses are compared exactly (integers and
bitwise-equal float tensors); nothing here is approximate.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import collector as jcollector  # noqa: E402
from repro.core.probes import operator_probe as jop  # noqa: E402
from repro_torch.config import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.core import Collector, Layer  # noqa: E402
from repro_torch.core.events import EventTable, RingBuffer  # noqa: E402
from repro_torch.core.probes import (CudaRuntimeProbe, OperatorProbe,  # noqa: E402
                                     PythonProbe)
from repro_torch.core.probes import runtime_probe  # noqa: E402
from repro_torch.core.probes.operator_probe import (  # noqa: E402
    extract_operator_records)
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.detect import detection_zone  # noqa: E402
from repro_torch.models.model import Runtime  # noqa: E402
from repro_torch.train.step import (init_train_state, make_optimizer_for,  # noqa: E402
                                    make_train_step)

CPU = "cpu"


def small_training(steps=8):
    """The reduced GPT-2 on the CPU: (state, step_fn, data)."""
    cfg = reduced(get_arch("gpt2"))
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                         total_steps=steps, warmup_steps=1))
    data = SyntheticLMData(cfg, seq_len=16, global_batch=2, seed=0)
    state = init_train_state(cfg, opt, seed=0, device=CPU)
    return state, make_train_step(cfg, Runtime(torch.float32), opt), data


def state_tensors(state):
    return ([p.detach().clone() for p in state.params.values()]
            + [t.clone() for k in ("mu", "nu")
               for t in state.opt_state[k].values()])


# -- python probe --------------------------------------------------------------

def test_python_probe_attach_detach_restores_hook():
    before = sys.getprofile()
    rb = RingBuffer(1000)
    p = PythonProbe(include=("repro_torch",), sample_every=1)
    p.attach(rb)
    assert sys.getprofile() is not None
    from repro_torch.core import gmm  # call something in the port's namespace
    _ = gmm.LOG2PI
    p.detach()
    assert sys.getprofile() is before  # zero residue after detach


def test_python_probe_records_repro_torch_calls():
    rb = RingBuffer(10000)
    p = PythonProbe()
    assert p.include == ("repro_torch", "torch")
    p.attach(rb)
    from repro_torch.core.features import Standardizer
    Standardizer().fit(np.ones((10, 2)))
    p.detach()
    events = rb.drain()
    names = [e.name for e in events]
    assert any("Standardizer" in n or "features" in n for n in names)
    assert all(e.layer == Layer.PYTHON for e in events)


def test_python_probe_samples_one_call_in_n():
    def count(every):
        rb = RingBuffer(100000)
        p = PythonProbe(include=("repro_torch",), sample_every=every)
        p.attach(rb)
        from repro_torch.core.features import Standardizer
        for _ in range(50):
            Standardizer().fit(np.ones((4, 2)))
        p.detach()
        return len(rb.drain())

    full, sampled = count(1), count(5)
    assert 0 < sampled < full and abs(sampled - full / 5) <= 2


# -- operator probe --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 64, 16), (128, 128, 128),
                                   (7, 300, 5)])
def test_matmul_flops_equal_the_reference(shape):
    """A matmul's FLOPs: torch's formula on the aten op == the reference's
    `_eqn_flops` on the jaxpr's dot_general (exact)."""
    M, K, N = shape
    got = [r for r in extract_operator_records(
        lambda a, b: a @ b, torch.ones(M, K), torch.ones(K, N))
        if r["prim"] == "mm"]
    want = [r for r in jop.extract_operator_records(
        lambda a, b: a @ b, jnp.ones((M, K)), jnp.ones((K, N)))
        if r["prim"] == "dot_general"]
    assert len(got) == len(want) == 1
    assert got[0]["flops"] == want[0]["flops"] == 2.0 * M * K * N
    assert got[0]["out_shape"] == want[0]["out_shape"] == (M, N)


def test_batched_matmul_flops_equal_the_reference():
    got = [r for r in extract_operator_records(
        lambda a, b: torch.bmm(a, b), torch.ones(4, 8, 16),
        torch.ones(4, 16, 32)) if r["prim"] == "bmm"]
    want = [r for r in jop.extract_operator_records(
        lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
        jnp.ones((4, 8, 16)), jnp.ones((4, 16, 32)))
        if r["prim"] == "dot_general"]
    assert got[0]["flops"] == want[0]["flops"] == 2.0 * 4 * 8 * 16 * 32


def test_elementwise_flops_follow_the_reference_rule():
    """Transcendentals 8 a element, any other op 1, as `_eqn_flops`."""
    recs = extract_operator_records(lambda x: torch.exp(x) + 1.0,
                                    torch.ones(10, 3))
    by = {r["prim"]: r["flops"] for r in recs}
    want = {r["prim"]: r["flops"] for r in jop.extract_operator_records(
        lambda x: jnp.exp(x) + 1.0, jnp.ones((10, 3)))}
    assert by["exp"] == want["exp"] == 240.0
    assert by["add"] == want["add"] == 30.0


def test_operator_probe_top_n_rows_and_flop_fractions():
    state, step_fn, data = small_training()
    table = EventTable(10000)
    probe = OperatorProbe(top_n=10)
    probe.attach(table)
    probe.register_fn(step_fn, state, data.batch(0))
    static = table.snapshot_columns()
    assert static["name"].shape[0] == 10
    assert all(str(n).startswith("static/") for n in static["name"])
    assert probe._row_fracs.shape == (10,)
    assert 0.0 < probe._row_fracs.sum() <= 1.0
    assert np.all(np.diff(probe._row_fracs) <= 0)  # heaviest first
    assert probe._row_names[0] in ("mm", "addmm", "bmm")
    probe.observe_step(3, 0.5, ts=1.0)
    rows = table.drain_columns()
    live = rows["step"] == 3
    assert live.sum() == 10
    np.testing.assert_allclose(rows["dur"][live], 0.5 * probe._row_fracs)
    probe.detach()


def test_register_fn_leaves_the_training_state_bit_identical():
    state, step_fn, data = small_training()
    before = state_tensors(state)
    step_before = (state.step, state.opt_state["step"])
    OperatorProbe().register_fn(step_fn, state, data.batch(0))
    after = state_tensors(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert (state.step, state.opt_state["step"]) == step_before
    assert all(p.device.type == "cpu" for p in state.params.values())


def test_collector_step_wrap_and_perfetto(tmp_path):
    col = Collector.standard(with_python=False, device_interval=0.01)

    def step(x):
        return x * 2.0

    with col.monitoring():
        fn = col.observe_step_fn(step, sample_args=(torch.ones(8, 8),))
        x = torch.ones(8, 8)
        for _ in range(5):
            x = fn(x)
        time.sleep(0.05)
    events = col.snapshot()
    layers = {e.layer for e in events}
    assert Layer.STEP in layers and Layer.OPERATOR in layers
    steps = [e for e in events if e.layer == Layer.STEP]
    assert len(steps) == 5
    path = col.export_trace(str(tmp_path / "trace.json"))
    data = json.load(open(path))
    assert len(data["traceEvents"]) == len(events)


def test_standard_suite_matches_the_reference():
    got = [p.name for p in Collector.standard().probes]
    want = [p.name for p in jcollector.Collector.standard().probes]
    assert got == want == ["python", "xla", "operator", "collective",
                           "device", "step"]
    assert [p.name for p in Collector.standard(with_python=False).probes] \
        == want[1:]


def test_failed_registration_warns_and_still_wraps():
    col = Collector.standard(with_python=False)

    def step(x):
        raise RuntimeError("not traceable")

    with pytest.warns(RuntimeWarning, match="register_fn failed"):
        fn = col.observe_step_fn(step, sample_args=(torch.ones(2),))
    assert fn.__wrapped__ is step


# -- CUDA-runtime probe -----------------------------------------------------------

@pytest.fixture
def fake_sync(monkeypatch):
    """A stand-in for torch.cuda.synchronize on a host without a card (the
    real one raises there); the probe hooks whatever is installed."""
    calls = []

    def synchronize(device=None):
        calls.append(device)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return synchronize, calls


def test_runtime_probe_emits_while_attached(fake_sync):
    sync, calls = fake_sync
    table = EventTable(100)
    probe = CudaRuntimeProbe()
    probe.attach(table)
    assert torch.cuda.synchronize is not sync
    torch.cuda.synchronize()
    torch.cuda.synchronize()
    probe.detach()
    rows = table.drain_columns()
    assert calls == [None, None]
    assert list(rows["name"]) == ["cudaDeviceSynchronize"] * 2
    assert np.all(rows["layer"] == rows["layer"][0])
    assert Layer(probe.name) == Layer.XLA
    assert np.all(rows["dur"] >= 0) and np.all(
        rows["tid"] == threading.get_ident())


def test_runtime_probe_drops_calls_inside_a_detection_zone(fake_sync):
    table = EventTable(100)
    probe = CudaRuntimeProbe()
    probe.attach(table)
    with detection_zone():
        torch.cuda.synchronize()
        with detection_zone():  # re-entrant
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    probe.detach()
    assert probe.dropped_in_zone == 2
    assert table.drain_columns()["name"].shape[0] == 1


def test_runtime_probe_leaves_nothing_behind(fake_sync):
    sync, calls = fake_sync
    originals = {(id(o), a): vars(o).get(a)
                 for o, a, _ in runtime_probe.hook_targets()}
    table = EventTable(100)
    a, b = CudaRuntimeProbe(), CudaRuntimeProbe()
    a.attach(table)
    b.attach(table)
    torch.cuda.synchronize()
    a.detach()  # not in attach order: the hooks stay for b
    torch.cuda.synchronize()
    b.detach()
    torch.cuda.synchronize()  # after the last detach: no row
    assert a.emitted == 1 and b.emitted == 2
    assert torch.cuda.synchronize is sync
    assert {(id(o), at): vars(o).get(at)
            for o, at, _ in runtime_probe.hook_targets()} == originals
    assert not runtime_probe._ACTIVE and not runtime_probe._SAVED
    assert len(calls) == 3


def test_runtime_probe_on_a_worker_thread_in_a_zone(fake_sync):
    """The async detection plane's shape: a worker inside a zone is
    dropped while the step thread keeps emitting."""
    table = EventTable(100)
    probe = CudaRuntimeProbe()
    probe.attach(table)

    def sweep():
        with detection_zone():
            torch.cuda.synchronize()

    t = threading.Thread(target=sweep)
    t.start()
    t.join()
    torch.cuda.synchronize()
    probe.detach()
    rows = table.drain_columns()
    assert probe.dropped_in_zone == 1
    assert list(rows["tid"]) == [threading.get_ident()]


# -- the suite as a whole ----------------------------------------------------------

def test_monitoring_is_nonintrusive():
    """Losses with the full suite attached (python probe included) equal the
    unmonitored run's, bit for bit, and the wrapped step is the user's."""
    def run(monitored):
        state, step_fn, data = small_training()
        losses = []
        col = Collector.standard(python_sampling=5, device_interval=0.01)
        fn = step_fn
        with col.monitoring() if monitored else _null():
            if monitored:
                fn = col.observe_step_fn(step_fn,
                                         sample_args=(state, data.batch(0)))
                assert fn.__wrapped__ is step_fn
            for s in range(4):
                state, m = fn(state, data.batch(s))
                losses.append(m["loss"])
        return torch.stack(losses), col

    want, _ = run(False)
    got, col = run(True)
    assert torch.equal(got, want)
    emitted = col.overhead_stats()["emitted_per_probe"]
    # the operator probe: 24 static rows, then 24 a step
    assert emitted["python"] > 0 and emitted["operator"] == 24 + 4 * 24


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
