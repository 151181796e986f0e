"""The port's detector families against the JAX package's, on the CPU:
tests/test_detector_conformance.py's contract over every backend the port
registers (which must be the reference's list), then the isolation
ensemble, the MAD floor and the spectral residual held against the
reference run live on the same inputs — their models, the batch flag masks
and the stream flags tick by tick.

Tolerances: the three families are NumPy float64 in both packages, seeded
alike, so their scores agree within rtol 1e-6 (atol 1e-12) and their flag
masks, thresholds and refit modes are equal. The GMM backends run float32
EM through another summation order; the conformance contract holds them to
the reference's own criteria (determinism within the port, calibration
under the FAR ceiling), and tests/test_torch_session.py and
tests/test_torch_stream.py hold their flags against the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core.events import Event as JEvent  # noqa: E402
from repro.core.events import Layer as JLayer  # noqa: E402
from repro.core.events import events_to_columns as j_columns  # noqa: E402
from repro.detect import families as jfamilies  # noqa: E402
from repro.session import registry as jregistry  # noqa: E402
from repro.session.spec import DetectorSpec as JDetectorSpec  # noqa: E402
from repro.stream import wire as jwire  # noqa: E402
from repro_torch.core.events import Event, Layer  # noqa: E402
from repro_torch.core.events import events_to_columns  # noqa: E402
from repro_torch.detect import (DetectionExecutor,  # noqa: E402
                                IsolationEnsemble, ModelStackMonitor,
                                RobustMADModel, SpectralResidualModel,
                                model_factory)
from repro_torch.detect import families  # noqa: E402
from repro_torch.eval.fixtures import FIXTURE_KINDS, fixture_case  # noqa: E402
from repro_torch.eval.matrix import FAR_CEILING  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.session.detectors import Detector  # noqa: E402
from repro_torch.session.registry import (detector_backend,  # noqa: E402
                                          detector_backends)
from repro_torch.session.spec import DetectorSpec  # noqa: E402
from repro_torch.stream import wire  # noqa: E402

CPU = "cpu"
ALL_BACKENDS = detector_backends()
BATCH_NAMES = [n for n, m in ALL_BACKENDS if m == "batch"]
STREAM_NAMES = [n for n, m in ALL_BACKENDS if m == "stream"]
FAMILIES = families.MODEL_FAMILIES
CLEAN_CONTAMINATION = 0.05
IDS = [f"{n}-{m}" for n, m in ALL_BACKENDS]


def _spec(name: str, cls=DetectorSpec, **kw):
    kw.setdefault("seed", 0)
    kw.setdefault("min_events", 64)
    kw.setdefault("horizon_s", 1000.0)
    return cls(backend=name, **kw)


def _trace(rng, n_steps, fault_steps=(), fault_scale=8.0, event=Event,
           layer=Layer):
    """The conformance suite's synthetic chaos trace (operator + step)."""
    evs = []
    base = {"matmul": 2e-3, "softmax": 4e-4, "layernorm": 2e-4}
    for s in range(n_steps):
        t = 0.05 * s
        scale = fault_scale if s in fault_steps else 1.0
        for op, b in base.items():
            evs.append(event(layer=layer.OPERATOR, name=op, ts=t,
                             dur=b * scale * rng.lognormal(0, 0.05),
                             size=1e5, step=s))
        evs.append(event(layer=layer.STEP, name="train_step", ts=t,
                         dur=3e-3 * scale * rng.lognormal(0, 0.05), step=s))
    return evs


def _chunk(evs, lo, hi):
    return [e for e in evs if lo <= e.step < hi]


def _build(name, mode, spec=None):
    return detector_backend(name, mode)(spec or _spec(name), device=CPU)


def _warm_stream(backend, trace, n_warm=100):
    backend.monitor.aggregator.ingest(
        wire.encode_events(_chunk(trace, 0, n_warm), node_id=0, seq=0))
    backend.fit()
    return backend


def _assert_detection_shape(det):
    flags = np.asarray(det.flags)
    scores = np.asarray(det.scores)
    assert flags.dtype == bool and flags.shape == scores.shape
    assert np.isfinite(float(det.log_delta))
    assert 0.0 <= float(det.anomaly_rate) <= 1.0


def test_backends_are_the_references():
    assert ALL_BACKENDS == jregistry.detector_backends()
    assert FAMILIES == jfamilies.MODEL_FAMILIES


# ---------------------------------------------------------------------------
# tests/test_detector_conformance.py over the port's registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode", ALL_BACKENDS, ids=IDS)
def test_protocol_surface(name, mode):
    backend = _build(name, mode)
    assert isinstance(backend, Detector)
    assert backend.fitted is False
    rng = np.random.default_rng(0)
    trace = _trace(rng, 130)
    if mode == "stream":
        _warm_stream(backend, trace)
        assert backend.fitted
        backend.monitor.aggregator.ingest(
            wire.encode_events(_chunk(trace, 100, 130), node_id=0, seq=1))
        out = backend.update()
    else:
        layers = backend.fit(_chunk(trace, 0, 100))
        assert layers and all(isinstance(l, Layer) for l in layers)
        assert backend.fitted
        out = backend.update(_chunk(trace, 100, 130))
    assert out and Layer.OPERATOR in out
    for det in out.values():
        _assert_detection_shape(det)
    assert backend.flags() == out


@pytest.mark.parametrize("name,mode", ALL_BACKENDS, ids=IDS)
def test_fixed_seed_determinism(name, mode):
    rng = np.random.default_rng(1)
    trace = _trace(rng, 160, fault_steps=set(range(130, 145)))
    outs = []
    for _ in range(2):
        backend = _build(name, mode)
        if mode == "stream":
            _warm_stream(backend, trace)
            for i, lo in enumerate(range(100, 160, 20)):
                backend.monitor.aggregator.ingest(wire.encode_events(
                    _chunk(trace, lo, lo + 20), node_id=0, seq=1 + i))
                out = backend.update()
        else:
            backend.fit(_chunk(trace, 0, 100))
            out = backend.update(_chunk(trace, 100, 160))
        outs.append(out)
    first, second = outs
    assert set(first) == set(second) and first
    for layer in first:
        assert first[layer].flags.tobytes() == second[layer].flags.tobytes()
        assert (first[layer].scores.tobytes()
                == second[layer].scores.tobytes())
        assert first[layer].log_delta == second[layer].log_delta


@pytest.mark.parametrize("name", BATCH_NAMES)
def test_batch_empty_inputs(name):
    backend = _build(name, "batch")
    assert backend.fit([]) == []
    assert backend.fitted is False
    assert backend.update([]) == {}
    rng = np.random.default_rng(2)
    backend.fit(_trace(rng, 100))
    assert backend.fitted
    assert backend.update([]) == {}


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_stream_empty_warmup_and_tick(name):
    backend = _build(name, "stream")
    assert backend.fit() == []
    assert backend.fitted is False
    assert backend.update() == {}
    rng = np.random.default_rng(2)
    _warm_stream(backend, _trace(rng, 100))
    assert backend.fitted
    out = backend.update()
    for det in out.values():
        _assert_detection_shape(det)


@pytest.mark.parametrize("name,mode", ALL_BACKENDS, ids=IDS)
def test_single_component_spec(name, mode):
    backend = _build(name, mode, _spec(name, n_components=1))
    rng = np.random.default_rng(3)
    trace = _trace(rng, 130)
    if mode == "stream":
        _warm_stream(backend, trace)
        backend.monitor.aggregator.ingest(
            wire.encode_events(_chunk(trace, 100, 130), node_id=0, seq=1))
        out = backend.update()
    else:
        backend.fit(_chunk(trace, 0, 100))
        out = backend.update(_chunk(trace, 100, 130))
    assert out and backend.fitted


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_async_trio_parity_inline(name):
    rng = np.random.default_rng(4)
    trace = _trace(rng, 200, set(range(140, 160)))
    sync_b = _warm_stream(_build(name, "stream"), trace)
    async_b = _warm_stream(_build(name, "stream"), trace)
    ex = DetectionExecutor(mode="inline")
    async_b.attach_executor(ex)
    for i, lo in enumerate(range(100, 200, 20)):
        buf = wire.encode_events(_chunk(trace, lo, lo + 20), node_id=0,
                                 seq=1 + i)
        sync_b.monitor.aggregator.ingest(buf)
        async_b.monitor.aggregator.ingest(buf)
        want = sync_b.update()
        got = async_b.update_async(step=i)
        assert set(want) == set(got)
        for layer in want:
            assert want[layer].flags.tobytes() == got[layer].flags.tobytes()
            assert (want[layer].scores.tobytes()
                    == got[layer].scores.tobytes())
            assert want[layer].log_delta == got[layer].log_delta
    assert async_b.sweeps_admitted > 0
    assert len(sync_b.finish()) == len(async_b.finish(step=99))
    ex.close()


@pytest.mark.parametrize("name,mode", ALL_BACKENDS, ids=IDS)
def test_clean_flag_rate_under_ceiling(name, mode):
    backend = _build(name, mode,
                     _spec(name, contamination=CLEAN_CONTAMINATION))
    rng = np.random.default_rng(5)
    trace = _trace(rng, 200)
    if mode == "stream":
        _warm_stream(backend, trace)
        for i, lo in enumerate(range(100, 200, 20)):
            backend.monitor.aggregator.ingest(wire.encode_events(
                _chunk(trace, lo, lo + 20), node_id=0, seq=1 + i))
            out = backend.update()
    else:
        backend.fit(_chunk(trace, 0, 100))
        out = backend.update(_chunk(trace, 100, 200))
    assert out
    for layer, det in out.items():
        assert float(det.anomaly_rate) < FAR_CEILING, (
            f"{name}/{mode} clean {layer.value} flag rate "
            f"{det.anomaly_rate:.3f} >= {FAR_CEILING}")


@pytest.mark.parametrize("name,mode", ALL_BACKENDS, ids=IDS)
def test_no_event_objects_on_hot_path(name, mode, monkeypatch):
    rng = np.random.default_rng(6)
    trace = _trace(rng, 130)
    backend = _build(name, mode)
    if mode == "stream":
        bufs = [wire.encode_events(_chunk(trace, 0, 100), node_id=0, seq=0),
                wire.encode_events(_chunk(trace, 100, 130), node_id=0,
                                   seq=1)]
    else:
        from repro_torch.core.events import events_to_columns as t_cols

        train_cols = t_cols(_chunk(trace, 0, 100))
        score_cols = t_cols(_chunk(trace, 100, 130))

    def boom(self, *a, **kw):
        raise AssertionError("Event constructed on the detector hot path")

    monkeypatch.setattr(Event, "__init__", boom)
    if mode == "stream":
        backend.monitor.aggregator.ingest(bufs[0])
        backend.fit()
        backend.monitor.aggregator.ingest(bufs[1])
        out = backend.update()
    else:
        backend.fit(train_cols)
        out = backend.update(score_cols)
    assert out and backend.fitted


@pytest.mark.parametrize("name,mode", [(n, m) for n, m in ALL_BACKENDS
                                       if n in FAMILIES],
                         ids=[i for i in IDS if i.split("-")[0] in FAMILIES])
def test_families_run_no_gmm_kernel(name, mode):
    """The families are NumPy in the reference and stay so: no GMM kernel
    (plain or CUDA) runs behind them."""
    before = dict(ref.CALLS)
    test_protocol_surface(name, mode)
    assert ref.CALLS == before


# ---------------------------------------------------------------------------
# the models against the reference's, live
# ---------------------------------------------------------------------------

def _to_reference(events):
    """The port's events as the reference's, field for field, so each
    package builds its columns with its own ``events_to_columns``."""
    return [JEvent(**{**dataclasses.asdict(e), "layer": JLayer(e.layer.value)})
            for e in events]


def _feature_sets(seed, n=400, d=4):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)) @ rng.standard_normal((d, d))
    shifted = base[: n // 4] * 1.3 + 0.4
    probe = np.concatenate([rng.standard_normal((n // 2, d)) * 1.5,
                            rng.standard_normal((8, d)) * 6.0 + 5.0])
    return base, shifted, probe


def _assert_scores_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_family_scores_equal_the_references(family, seed):
    """Fit, score, fold (partial_fit twice) and score again, both packages
    on the same float64 rows from the same seed; also the stats."""
    base, shifted, probe = _feature_sets(seed)
    kw = dict(seed=seed, n_trees=32, refresh_trees=0.5, var_target=0.9)
    mine = model_factory(family, **kw)()
    theirs = jfamilies.model_factory(family, **kw)()
    mine.fit(base)
    theirs.fit(base)
    _assert_scores_close(mine.decision_scores(probe),
                         theirs.decision_scores(probe))
    for X in (shifted, base[::3]):
        mine.partial_fit(X)
        theirs.partial_fit(X)
        _assert_scores_close(mine.decision_scores(probe),
                             theirs.decision_scores(probe))
    assert mine.stats() == theirs.stats()
    assert mine.decision_scores(probe[:0]).shape == (0,)


def test_model_classes_are_exported_like_the_references():
    assert isinstance(model_factory("isoforest")(), IsolationEnsemble)
    assert isinstance(model_factory("mad")(), RobustMADModel)
    assert isinstance(model_factory("spectral")(), SpectralResidualModel)
    for mod in (families, jfamilies):
        with pytest.raises(KeyError, match="unknown model family"):
            mod.model_factory("nope")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["clean", *FIXTURE_KINDS])
def test_batch_masks_equal_the_references(family, kind):
    """The golden-fixture cases (a clean prefix, then a window with a burst
    per fault kind; the port's, bit-identical to the reference's,
    tests/test_torch_eval.py) through both packages' batch backends, run
    live: equal thresholds, scores within rtol 1e-6, equal flag masks."""
    train, window, truth, layer = fixture_case(kind, seed=0)
    mine = _build(family, "batch", _spec(family, contamination=0.02))
    theirs = jregistry.detector_backend(family, "batch")(
        _spec(family, JDetectorSpec, contamination=0.02))
    want_fit = theirs.fit(j_columns(_to_reference(train)))
    got_fit = mine.fit(events_to_columns(train))
    assert [l.value for l in got_fit] == [l.value for l in want_fit]
    want = theirs.update(j_columns(_to_reference(window)))
    got = mine.update(events_to_columns(window))
    assert {l.value for l in got} == {l.value for l in want}
    for jl, w in want.items():
        g = got[Layer(jl.value)]
        assert g.log_delta == pytest.approx(w.log_delta, rel=1e-6, abs=1e-12)
        _assert_scores_close(g.scores, w.scores)
        np.testing.assert_array_equal(g.flags, w.flags)
        np.testing.assert_array_equal(g.steps, w.steps)
    if truth.any():
        flags = got[Layer(layer.value)].flags
        assert flags[-truth.size:][truth].mean() > 0


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "refit"])
def test_stream_flags_equal_the_references_tick_by_tick(family, incremental):
    """Two nodes, node 1 slowed 8x over steps 140-159, through both
    packages' stream backends (wire -> window -> OnlineModelDetector ->
    incidents): per tick equal refit modes, thresholds and flag masks,
    scores within rtol 1e-6; then equal incidents."""
    rng = np.random.default_rng(7)
    fault = set(range(140, 160))
    traces = {node: _trace(rng, 200, fault if node == 1 else (),
                           event=JEvent, layer=JLayer) for node in (0, 1)}
    kw = dict(contamination=0.02, incremental=incremental,
              incident_gap_s=0.5, incident_close_after_s=0.5, min_flags=5)
    mine = _build(family, "stream", _spec(family, **kw))
    theirs = jregistry.detector_backend(family, "stream")(
        _spec(family, JDetectorSpec, **kw))

    def feed(lo, hi, seq):
        for node, trace in traces.items():
            buf = jwire.encode_events(_chunk(trace, lo, hi), node_id=node,
                                      seq=seq)
            mine.monitor.aggregator.ingest(buf)
            theirs.monitor.aggregator.ingest(buf)

    feed(0, 100, 0)
    assert ([l.value for l in mine.fit()]
            == [l.value for l in theirs.fit()] == ["operator", "step"])
    for tick, lo in enumerate(range(100, 200, 10)):
        feed(lo, lo + 10, 1 + tick)
        got, want = mine.update(), theirs.update()
        assert {l.value for l in got} == {l.value for l in want}
        for jl, w in want.items():
            g = got[Layer(jl.value)]
            where = f"tick {tick} layer {jl.value}"
            assert g.refit == w.refit, where
            assert g.log_delta == pytest.approx(w.log_delta, rel=1e-6,
                                                abs=1e-12), where
            _assert_scores_close(g.scores, w.scores)
            np.testing.assert_array_equal(g.flags, w.flags, err_msg=where)
    mine.finish()
    theirs.finish()
    ti, ji = mine.incidents, theirs.incidents
    assert [(i.suspect_layer.value, i.suspect_nodes, i.steps) for i in ti] \
        == [(i.suspect_layer.value, i.suspect_nodes, i.steps) for i in ji]
    assert ti and 1 in ti[0].suspect_nodes


def test_model_stack_monitor_is_the_batch_loop():
    rng = np.random.default_rng(8)
    trace = _trace(rng, 120)
    mon = ModelStackMonitor(model_factory("mad"), contamination=0.05,
                            min_events=64).fit(_chunk(trace, 0, 100))
    assert set(mon.detectors) == {Layer.OPERATOR, Layer.STEP}
    out = mon.detect(_chunk(trace, 100, 120))
    assert out[Layer.STEP].flags.shape == (20,)
