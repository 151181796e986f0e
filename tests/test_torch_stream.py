"""The port's streaming path against the JAX package's, on the CPU: the wire
bytes, the shape buckets, the sliding windows, and the slice as a whole —
the same multi-node column stream through both packages' aggregator ->
OnlineGMMDetector -> IncidentEngine, tick by tick — and a smoke run of
`repro_torch.quickstart.run_stream`.

The port's detector is started from the reference's fitted state
(`layer_state_from_numpy`, the bootstrap generator's state copied too), so
both draw the same bootstrap rows and refit from the same parameters. Per
tick, the refit mode must match and log_delta agree within 1e-3 nats (float32
EM in another summation order, compounded over a few refits); the flags
must be identical except for rows whose score lies within 1e-3 of the
threshold they were tested against.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core.events import Event as JEvent  # noqa: E402
from repro.core.events import Layer as JLayer  # noqa: E402
from repro.detect import cache as jcache  # noqa: E402
from repro.stream import wire as jwire  # noqa: E402
from repro.stream.incidents import IncidentEngine as JEngine  # noqa: E402
from repro.stream.incidents import match_incidents as jmatch  # noqa: E402
from repro.stream.online import OnlineGMMDetector as JOnline  # noqa: E402
from repro.stream.window import FleetAggregator as JAgg  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.core.chaos import get_scenario  # noqa: E402
from repro_torch.core.events import Event as TEvent  # noqa: E402
from repro_torch.core.events import Layer as TLayer  # noqa: E402
from repro_torch.detect import cache as tcache  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.convert import layer_state_from_numpy  # noqa: E402
from repro_torch.stream import wire as twire  # noqa: E402
from repro_torch.stream.incidents import IncidentEngine as TEngine  # noqa: E402
from repro_torch.stream.incidents import match_incidents as tmatch  # noqa: E402
from repro_torch.stream.online import OnlineGMMDetector as TOnline  # noqa: E402
from repro_torch.stream.window import FleetAggregator as TAgg  # noqa: E402

CPU = "cpu"


# -- wire --------------------------------------------------------------------

def _sample_events(Event, Layer):
    """tests/test_stream.py's sample: operators with 2^40 tids, a device row
    with telemetry plus residual meta, a collective row."""
    evs = [Event(layer=Layer.OPERATOR, name=f"op{i % 3}", ts=0.01 * i,
                 dur=1e-4 * (1 + i % 5), size=100.0 * i, step=i // 4,
                 pid=1234, tid=2 ** 40 + i) for i in range(20)]
    evs.append(Event(layer=Layer.DEVICE, name="gpu0", ts=0.5, step=5,
                     meta={"util": 0.75, "mem_gb": 11.5, "power_w": 280.0,
                           "temp_c": 61.0, "slot": "a3"}))
    evs.append(Event(layer=Layer.COLLECTIVE, name="all-reduce", ts=0.6,
                     dur=2e-3, size=1 << 20, step=6))
    evs.append(Event(layer=Layer.STEP, name="x" * 80, ts=0.7, dur=3e-3,
                     step=7))  # clipped to NAME_WIDTH in both
    return evs


def _assert_columns_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind == "f":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert list(a[k]) == list(b[k]), k


@pytest.mark.parametrize("version", [1, 2, 3])
def test_wire_bytes_are_identical_and_cross_decode(version):
    """The same events encode to the same bytes in both packages, and each
    package decodes the other's capture to the same columns."""
    kw = dict(node_id=3, seq=7, t_base=1.5, dropped=2, shed=1,
              version=version)
    jbuf = jwire.encode_events(_sample_events(JEvent, JLayer), **kw)
    tbuf = twire.encode_events(_sample_events(TEvent, TLayer), **kw)
    assert tbuf == jbuf
    for buf in (jbuf, tbuf):
        jb, tb = jwire.decode(buf), twire.decode(buf)
        assert (tb.node_id, tb.seq, tb.t_base, tb.dropped, tb.shed) == (
            jb.node_id, jb.seq, jb.t_base, jb.dropped, jb.shed)
        _assert_columns_equal(tb.columns, jb.columns)


def test_wire_schema_constants_match():
    assert twire.SUPPORTED_VERSIONS == jwire.SUPPORTED_VERSIONS
    assert twire.VERSION == jwire.VERSION
    assert twire.WIRE_COLUMNS == jwire.WIRE_COLUMNS
    assert twire.TELEMETRY_KEYS == jwire.TELEMETRY_KEYS
    assert {k.value: v for k, v in twire.LAYER_CODE.items()} == {
        k.value: v for k, v in jwire.LAYER_CODE.items()}
    with pytest.raises(twire.WireVersionError):
        twire.decode(jwire.MAGIC + b"\x09\x00" + b"\x00" * 8)


# -- shape buckets -----------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 4097])
def test_buckets_match_the_reference(n):
    X = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    tp, tn = tcache.pad_to_bucket(X)
    jp, jn = jcache.pad_to_bucket(X)
    assert tcache.bucket_rows(n) == jcache.bucket_rows(n)
    assert tn == jn == n
    np.testing.assert_array_equal(tp, jp)


def test_shape_cache_counts_hits_and_misses():
    c = tcache.ShapeBucketCache()
    assert not c.record("score", 256, 4, 3)
    assert c.record("score", 256, 4, 3)
    assert not c.record("em-stats", 256, 4, 3)
    assert c.stats() == {"hits": 1, "misses": 2, "shapes": 2}


# -- the slice as a whole ----------------------------------------------------

def _node_trace(rng, n_steps, fault_steps=(), fault_scale=8.0):
    """tests/test_stream.py's trace: three operators + a step event a step."""
    evs = []
    base = {"matmul": 2e-3, "softmax": 4e-4, "layernorm": 2e-4}
    for s in range(n_steps):
        t = 0.05 * s
        scale = fault_scale if s in fault_steps else 1.0
        for op, b in base.items():
            evs.append(JEvent(layer=JLayer.OPERATOR, name=op, ts=t,
                              dur=b * scale * rng.lognormal(0, 0.05),
                              size=1e5, step=s))
        evs.append(JEvent(layer=JLayer.STEP, name="train_step", ts=t,
                          dur=3e-3 * scale * rng.lognormal(0, 0.05), step=s))
    return evs


def _feed(aggs, buf):
    for agg in aggs:
        agg.ingest(buf)
        agg.evict()


def _compare_tick(jd, td, delta_before, tick):
    assert {l.value for l in jd} == {l.value for l in td}, tick
    modes = {}
    for jl, jw in jd.items():
        tw = td[TLayer(jl.value)]
        where = f"tick {tick} layer {jl.value}"
        assert tw.refit == jw.refit, where
        modes[jl.value] = jw.refit
        assert abs(tw.log_delta - jw.log_delta) < 1e-3, where
        np.testing.assert_array_equal(tw.steps, jw.steps, err_msg=where)
        np.testing.assert_array_equal(tw.nodes, jw.nodes, err_msg=where)
        differ = tw.flags != jw.flags
        near = np.abs(jw.scores - delta_before[jl.value]) < 1e-3
        assert not (differ & ~near).any(), where
    return modes


@pytest.mark.parametrize("horizon_s,chunk", [(1000.0, 20), (5.0, 5)],
                         ids=["growing-window", "steady-window-folds"])
def test_stream_slice_matches_the_reference_tick_by_tick(horizon_s, chunk):
    """Two nodes, node 1 slowed 8x over steps 140-159. With a long horizon
    the window grows every tick (bootstrap warm refits, as on the card);
    with a 5 s horizon it is steady, so the incremental folds run too (the
    gmm_stats pass with nvalid on a padded bucket)."""
    rng = np.random.default_rng(0)
    fault_steps = set(range(140, 160))
    jagg, tagg = JAgg(horizon_s=horizon_s), TAgg(horizon_s=horizon_s)
    for node in (0, 1):
        _feed((jagg, tagg), jwire.encode_events(_node_trace(rng, 100),
                                                node_id=node, seq=0))
    jdet = JOnline(min_events=64, contamination=0.02, seed=0)
    tdet = TOnline(min_events=64, contamination=0.02, seed=0, device=CPU)
    assert {l.value for l in jdet.warmup(jagg)} == {"operator", "step"}
    tdet.states = {TLayer(l.value): layer_state_from_numpy(s, CPU)
                   for l, s in jdet.states.items()}
    tdet._rng.bit_generator.state = jdet._rng.bit_generator.state
    jeng = JEngine(gap_s=0.5, close_after_s=0.5, min_flags=5)
    teng = TEngine(gap_s=0.5, close_after_s=0.5, min_flags=5)
    jeng.set_floor(jagg.t_latest)
    teng.set_floor(tagg.t_latest)
    seen_modes = set()
    before = ref.CALLS["gmm_stats_ref"]
    for tick, lo in enumerate(range(100, 200, chunk)):
        for node in (0, 1):
            faults = fault_steps if node == 1 else ()
            evs = [e for e in _node_trace(rng, lo + chunk, faults)
                   if lo <= e.step < lo + chunk]
            _feed((jagg, tagg), jwire.encode_events(evs, node_id=node,
                                                    seq=1 + tick))
        delta_before = {l.value: s.log_delta for l, s in jdet.states.items()}
        jd, td = jdet.detect(jagg), tdet.detect(tagg)
        seen_modes |= set(_compare_tick(jd, td, delta_before, tick).values())
        jeng.update(jd, now=jagg.t_latest)
        teng.update(td, now=tagg.t_latest)
    jeng.flush()
    teng.flush()
    assert ref.CALLS["gmm_stats_ref"] > before
    assert "warm" in seen_modes
    for jl, js in jdet.states.items():
        ts = tdet.states[TLayer(jl.value)]
        assert (ts.warm_refits, ts.cold_refits) == (js.warm_refits,
                                                    js.cold_refits)
        np.testing.assert_allclose(ts.params.means.numpy(),
                                   np.asarray(js.params.means), rtol=1e-3,
                                   atol=1e-3)
    ji, ti = jeng.ranked(), teng.ranked()
    assert ji, "the reference formed no incident"
    assert len(ti) == len(ji)
    for a, b in zip(ti, ji):
        assert a.suspect_layer.value == b.suspect_layer.value
        assert a.suspect_nodes == b.suspect_nodes
        assert a.steps == b.steps
    assert ti[0].suspect_nodes == [1]
    windows = [(140, 160)]
    assert tmatch(ti, windows).recall == jmatch(ji, windows).recall == 1.0


def test_steady_window_takes_the_fold_branch():
    """The steady-window case really takes the incremental branch: each
    layer's fold is one gmm_stats call and no gmm_update call."""
    rng = np.random.default_rng(1)
    agg = TAgg(horizon_s=5.0)
    _feed((agg,), jwire.encode_events(_node_trace(rng, 100), node_id=0,
                                      seq=0))
    det = TOnline(min_events=64, contamination=0.02, seed=0, device=CPU)
    det.warmup(agg)
    det.detect(agg)  # first tick records the window size
    evs = [e for e in _node_trace(rng, 110) if e.step >= 100]
    _feed((agg,), jwire.encode_events(evs, node_id=0, seq=1))
    calls = dict(ref.CALLS)
    out = det.detect(agg)
    assert {d.refit for d in out.values()} == {"warm"}
    assert ref.CALLS["gmm_update_ref"] == calls["gmm_update_ref"]
    assert ref.CALLS["gmm_stats_ref"] == calls["gmm_stats_ref"] + len(out)


def test_layer_state_carries_every_field():
    rng = np.random.default_rng(2)
    agg = JAgg(horizon_s=1000.0)
    agg.ingest(jwire.encode_events(_node_trace(rng, 100), node_id=0, seq=0))
    jdet = JOnline(min_events=64, seed=0)
    jdet.warmup(agg)
    for js in jdet.states.values():
        ts = layer_state_from_numpy(js, CPU)
        for f in dataclasses.fields(ts):
            a, b = getattr(ts, f.name), getattr(js, f.name)
            if f.name in ("params", "stats"):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name


def test_online_detector_needs_an_explicit_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOnline()


# -- the stream entry point ------------------------------------------------

def test_run_stream_smoke_on_cpu(monkeypatch):
    """The reduced GPT-2 trains 240 steps with the StreamMonitor attached;
    all four plain kernel versions run, the loss is finite, and an incident
    overlaps a fault window. The reduced step's wall time on a shared CPU
    wanders by tens of ms, so the bursts are scaled up 10x to stay
    separable; the card runs the scenario as registered."""
    scenario = dataclasses.replace(get_scenario("latency_spike"),
                                   magnitudes={"op_latency": 0.5})
    monkeypatch.setattr(quickstart, "get_scenario", lambda name: scenario)
    before = dict(ref.CALLS)
    out = quickstart.run_stream(reduced_model=True, device=CPU)
    ran = {k: ref.CALLS[k] - before[k] for k in before}
    assert all(ran.values()), ran
    assert np.isfinite(out["losses"]).all()
    assert out["windows"] == [(113, 127), (161, 175), (209, 223)]
    assert out["match"].windows_detected >= 1, [
        i.render() for i in out["incidents"]]
    assert out["ticks"] == 8  # steps 100, 120, ..., 220, then finish()
    assert out["lost_batches"] == 0 and out["failed_samples"] == 0
    assert set(out["refits"]) >= {"step", "xla"}
