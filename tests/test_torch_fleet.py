"""The port's fleet plane against the JAX package's, on the CPU:
tests/test_fleet.py's cases on the port (governor budget, layer floor,
thinning, the AIMD cycle, the identity under budget, shed accounting on the
wire, late and shuffled delivery, a fault spanning two groups, a clean fleet,
the session with a topology), the governor held exactly against the
reference's, the hierarchical monitor tick by tick against the reference's,
the v3 wire with a ``shed`` header across both packages, and a CPU run of
`repro_torch.quickstart.run_fleet`.

Tolerances: the governor (NumPy) is compared exactly, column for column and
counter for counter; wire bytes and their decodes are compared exactly. The
tick-by-tick parity starts every group's port detector from the reference
group's fitted state (`layer_state_from_numpy`, the bootstrap generator's
state copied too), so per group and per tick the refit mode must match,
log_delta agree within 1e-3 nats, and the flags be identical except for rows
whose score lies within 1e-3 of the threshold they were tested against —
tests/test_torch_stream.py's tolerance for float32 EM summed in another
order. The merged incidents must be equal in nodes, layers and steps.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import events as jevents  # noqa: E402
from repro.fleet import BackpressureGovernor as JGovernor  # noqa: E402
from repro.fleet import HierarchicalMonitor as JMonitor  # noqa: E402
from repro.fleet import TopologySpec as JTopologySpec  # noqa: E402
from repro.session import registry as jregistry  # noqa: E402
from repro.stream import wire as jwire  # noqa: E402
from repro.stream.agent import NodeAgent as JAgent  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.core.events import Event, EventTable, Layer  # noqa: E402
from repro_torch.fleet import (BackpressureGovernor, FleetView,  # noqa: E402
                               HierarchicalMonitor, TopologySpec)
from repro_torch.fleet.plane import merge_detections  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.convert import layer_state_from_numpy  # noqa: E402
from repro_torch.session import DetectorSpec, MonitorSpec, Session  # noqa: E402
from repro_torch.session import registry  # noqa: E402
from repro_torch.stream import wire  # noqa: E402
from repro_torch.stream.agent import NodeAgent  # noqa: E402
from repro_torch.stream.window import FleetAggregator  # noqa: E402

CPU = "cpu"
_CODE = {layer: code for code, layer in enumerate(Layer)}


# ---------------------------------------------------------------------------
# backpressure governor: tests/test_fleet.py's cases, then exact parity
# ---------------------------------------------------------------------------

def _cols(op=0, dev=0, step_rows=0):
    """Columns with `op` operator, `dev` device and `step_rows` step rows."""
    n = op + dev + step_rows
    layer = np.concatenate([
        np.full(op, _CODE[Layer.OPERATOR], np.int8),
        np.full(dev, _CODE[Layer.DEVICE], np.int8),
        np.full(step_rows, _CODE[Layer.STEP], np.int8)])
    return {"layer": layer,
            "name": np.array(["x"] * n),
            "ts": np.arange(n, dtype=np.float64) * 1e-3,
            "dur": np.ones(n), "size": np.zeros(n),
            "pid": np.zeros(n, np.int64), "tid": np.zeros(n, np.int64),
            "step": np.arange(n, dtype=np.int64),
            "util": np.full(n, np.nan), "mem_gb": np.full(n, np.nan),
            "power_w": np.full(n, np.nan), "temp_c": np.full(n, np.nan),
            "meta": np.array([""] * n, object)}


def test_governor_respects_budget_and_layer_floor():
    gov = BackpressureGovernor(100, min_per_layer=8)
    kept, shed = gov.admit(_cols(op=900, dev=10))
    n_kept = int(kept["ts"].shape[0])
    assert n_kept <= 100
    assert n_kept + sum(shed.values()) == 910
    dev_kept = int((kept["layer"] == np.int8(_CODE[Layer.DEVICE])).sum())
    assert dev_kept >= 8
    assert gov.events_admitted == n_kept and gov.events_shed == 910 - n_kept
    assert sum(gov.shed_by_layer.values()) == gov.events_shed


def test_governor_thinning_spans_the_flush_window():
    gov = BackpressureGovernor(50, min_per_layer=1)
    kept, _ = gov.admit(_cols(op=1000))
    ts = kept["ts"]
    assert ts.min() < 0.1e-3 * 1000 and ts.max() > 0.9e-3 * 1000


def test_governor_aimd_cycle():
    gov = BackpressureGovernor(1000, min_per_layer=16, high_water=0.85,
                               decrease=0.5, recover_fraction=0.05)
    gov.feedback(0.95)
    assert gov.budget == 500
    for _ in range(20):
        gov.feedback(0.99)
    assert gov.budget >= 16
    for _ in range(1000):
        gov.feedback(0.1)
    assert gov.budget == 1000


def test_governor_under_budget_is_identity():
    gov = BackpressureGovernor(100)
    cols = _cols(op=40)
    kept, shed = gov.admit(cols)
    assert kept is cols and shed == {}
    assert gov.events_shed == 0


def test_governor_rejects_a_zero_budget_like_the_reference():
    for cls in (BackpressureGovernor, JGovernor):
        with pytest.raises(ValueError, match="max_events_per_flush"):
            cls(0)


@pytest.mark.parametrize("budget,min_per_layer,seed", [
    (100, 8, 0), (50, 1, 1), (1000, 32, 2), (7, 4, 3), (300, 64, 4),
    (2, 32, 5)])
def test_governor_matches_the_reference_exactly(budget, min_per_layer, seed):
    """A random run of flushes and pressure signals through both governors:
    the same admitted columns, shed counts and AIMD state after every call."""
    rng = np.random.default_rng(seed)
    mine = BackpressureGovernor(budget, min_per_layer=min_per_layer)
    theirs = JGovernor(budget, min_per_layer=min_per_layer)
    for _ in range(12):
        cols = _cols(op=int(rng.integers(0, 3 * budget + 2)),
                     dev=int(rng.integers(0, 40)),
                     step_rows=int(rng.integers(0, 20)))
        cols["ts"] = np.sort(rng.uniform(0, 1, cols["ts"].shape[0]))
        perm = rng.permutation(cols["ts"].shape[0])
        cols["layer"] = cols["layer"][perm]
        got, got_shed = mine.admit(cols)
        want, want_shed = theirs.admit(cols)
        assert got_shed == want_shed
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert mine.stats() == theirs.stats()
        pressure = float(rng.uniform(0, 1))
        mine.feedback(pressure)
        theirs.feedback(pressure)
        assert mine.stats() == theirs.stats()


# ---------------------------------------------------------------------------
# shed accounting and the v3 wire with a shed header, across both packages
# ---------------------------------------------------------------------------

class _TableCollector:
    """Minimal collector: NodeAgent only touches drain_columns + buffer."""

    def __init__(self, table_cls=EventTable, capacity=4096):
        self.buffer = table_cls(capacity)

    def drain_columns(self):
        return self.buffer.drain_columns()


def _fill_ops(col, layer_cls, n=500):
    col.buffer.append_rows(
        layer_cls.OPERATOR, name="op", ts=np.arange(n, dtype=np.float64),
        dur=1.0, step=np.arange(n, dtype=np.int64))
    col.buffer.append_rows(
        layer_cls.STEP, name="train_step",
        ts=np.arange(n // 10, dtype=np.float64), dur=2.0,
        step=np.arange(n // 10, dtype=np.int64))


def test_shed_count_rides_the_wire_and_is_accounted():
    col = _TableCollector()
    _fill_ops(col, Layer)
    gov = BackpressureGovernor(100, min_per_layer=8)
    agent = NodeAgent(0, col, governor=gov)
    agg = FleetAggregator(horizon_s=1e9)
    buf = agent.flush()
    batch = wire.decode(buf)
    assert batch.shed == 450
    agg.ingest(buf)
    assert agg.events_shed_at_source == agent.events_shed == 450
    assert col.buffer.pushed == agg.events_ingested + agg.events_shed_at_source


def test_shed_capture_is_byte_identical_in_both_packages():
    """The same rows through each package's agent and governor give the same
    v3 bytes, ``shed`` in the header; each package decodes the other's
    bytes to the same columns, and re-encodes them to the same bytes."""
    bufs = []
    for table_cls, layer_cls, agent_cls, gov_cls in (
            (EventTable, Layer, NodeAgent, BackpressureGovernor),
            (jevents.EventTable, jevents.Layer, JAgent, JGovernor)):
        col = _TableCollector(table_cls)
        _fill_ops(col, layer_cls)
        agent = agent_cls(3, col, governor=gov_cls(100, min_per_layer=8))
        bufs.append(agent.flush())
    mine, theirs = bufs
    assert mine == theirs
    assert wire.VERSION == jwire.VERSION == wire.VERSION_COMPRESSED
    a, b = wire.decode(theirs), jwire.decode(mine)
    assert (a.node_id, a.seq, a.dropped, a.shed) == (b.node_id, b.seq,
                                                     b.dropped, b.shed)
    assert a.shed == 450
    for k, v in b.columns.items():
        np.testing.assert_array_equal(a.columns[k], v, err_msg=k)
    assert wire.encode_columns(a.columns, node_id=a.node_id, seq=a.seq,
                               shed=a.shed) == mine
    assert jwire.encode_columns(b.columns, node_id=b.node_id, seq=b.seq,
                                shed=b.shed) == mine


# ---------------------------------------------------------------------------
# out-of-order delivery
# ---------------------------------------------------------------------------

def _batch(node, seq, t0, n=8):
    return wire.encode_events(
        [Event(layer=Layer.OPERATOR, name="op", ts=t0 + 0.01 * i, dur=1e-4,
               step=seq * n + i) for i in range(n)],
        node_id=node, seq=seq)


def test_late_batch_fills_gap_and_freshness_is_event_time():
    agg = FleetAggregator(horizon_s=1e9)
    agg.ingest(_batch(1, 0, t0=0.0))
    agg.ingest(_batch(1, 3, t0=3.0))
    assert agg.lost_batches == 2
    agg.ingest(_batch(1, 2, t0=2.0))
    agg.ingest(_batch(1, 1, t0=1.0))
    assert agg.lost_batches == 0
    assert agg.node_last_ts[1] == pytest.approx(3.07, abs=1e-6)
    assert agg.t_latest == pytest.approx(3.07, abs=1e-6)
    agg.ingest(_batch(1, 3, t0=3.0))
    assert agg.lost_batches == 0


def test_shuffled_delivery_matches_in_order_accounting():
    rng = np.random.default_rng(7)
    batches = [(node, seq) for node in (0, 1) for seq in range(20)]

    def run(order):
        agg = FleetAggregator(horizon_s=1e9)
        for node, seq in order:
            agg.ingest(_batch(node, seq, t0=float(seq)))
        return agg

    ordered = run(batches)
    shuffled = run(rng.permutation(np.array(
        batches, dtype=[("n", int), ("s", int)])).tolist())
    for agg in (ordered, shuffled):
        assert agg.events_ingested == len(batches) * 8
        assert agg.lost_batches == 0
        assert agg.node_last_ts[0] == agg.node_last_ts[1]
        assert agg.node_last_ts[0] == pytest.approx(19.07, abs=1e-6)


# ---------------------------------------------------------------------------
# the hierarchical monitor: tests/test_fleet.py's runs, then tick by tick
# against the reference
# ---------------------------------------------------------------------------

def _node_rows(rng, step_lo, step_hi, faulty=False, fault_steps=()):
    """tests/test_fleet.py's `_fill_node` rows: three operators and a step
    row a step; `faulty` nodes slowed 8x over `fault_steps`."""
    steps = np.arange(step_lo, step_hi, dtype=np.int64)
    t = 0.02 * steps.astype(np.float64)
    scale = np.ones(steps.size)
    if faulty:
        scale[np.isin(steps, list(fault_steps))] = 8.0
    rows = []
    for k, base in enumerate((1e-3, 2e-3, 5e-4)):
        rows.append(("OPERATOR", dict(
            name=f"op{k}", ts=t + 1e-4 * k,
            dur=base * scale * rng.lognormal(0, 0.05, steps.size),
            size=1e5, step=steps)))
    rows.append(("STEP", dict(
        name="train_step", ts=t,
        dur=3e-3 * scale * rng.lognormal(0, 0.05, steps.size), step=steps)))
    return rows


def _append(col, layer_cls, rows):
    for layer, kw in rows:
        col.buffer.append_rows(getattr(layer_cls, layer), **kw)


_MON_KW = dict(horizon_s=1e9, min_events=64, contamination=0.002,
               incident_gap_s=0.1, incident_close_after_s=0.5, min_flags=8,
               seed=0)


def _tree_fault_run(faulty_nodes):
    """tests/test_fleet.py's `_tree_fault_run` on the port: 8 nodes in 2
    groups of 4; `faulty_nodes` slowed over the same live window."""
    rng = np.random.default_rng(0)
    mon = HierarchicalMonitor(TopologySpec(group_size=4, fan_in=8),
                              device=CPU, **_MON_KW)
    cols = {nid: _TableCollector(capacity=1 << 15) for nid in range(8)}
    for nid, col in cols.items():
        mon.register_node(nid, col)
    assert sorted(mon.groups) == [0, 1]
    for col in cols.values():
        _append(col, Layer, _node_rows(rng, 0, 100))
    assert mon.warmup()
    fault_steps = set(range(140, 160))
    for lo in range(100, 200, 20):
        for nid, col in cols.items():
            _append(col, Layer, _node_rows(rng, lo, lo + 20,
                                           faulty=nid in faulty_nodes,
                                           fault_steps=fault_steps))
        mon.tick()
    mon.finish()
    return mon


def test_fault_spanning_two_groups_yields_one_incident():
    faulty = (1, 5)  # node 1 lives in group 0, node 5 in group 1
    mon = _tree_fault_run(faulty)
    ops = [i for i in mon.incidents if i.suspect_layer == Layer.OPERATOR]
    assert len(ops) == 1
    inc = ops[0]
    assert set(faulty) <= set(inc.suspect_nodes)
    assert set(faulty) <= set(inc.node_flags)
    assert len(set(inc.steps) & set(range(140, 160))) >= 10


def test_clean_fleet_produces_zero_incidents():
    mon = _tree_fault_run(())
    assert mon.incidents == []


def _compare_dets(jd, td, delta_before, where):
    assert {l.value for l in jd} == {l.value for l in td}, where
    for jl, jw in jd.items():
        tw = td[Layer(jl.value)]
        at = f"{where} layer {jl.value}"
        assert tw.refit == jw.refit, at
        assert abs(tw.log_delta - jw.log_delta) < 1e-3, at
        np.testing.assert_array_equal(tw.steps, jw.steps, err_msg=at)
        np.testing.assert_array_equal(tw.nodes, jw.nodes, err_msg=at)
        differ = tw.flags != jw.flags
        near = np.abs(jw.scores - delta_before[jl.value]) < 1e-3
        assert not (differ & ~near).any(), at


def _carry_state(jmon, tmon):
    """Start every port group detector from the reference group's fit."""
    for gid, jg in jmon.groups.items():
        tdet = tmon.groups[gid].detector
        tdet.states = {Layer(l.value): layer_state_from_numpy(s, CPU)
                       for l, s in jg.detector.states.items()}
        tdet._rng.bit_generator.state = jg.detector._rng.bit_generator.state


@pytest.mark.parametrize("topology", [
    {"group_size": 4, "fan_in": 8},
    {"group_size": 2, "fan_in": 8, "max_events_per_flush": 200,
     "min_per_layer": 40}], ids=["two-groups", "four-groups-shedding"])
def test_fleet_matches_the_reference_tick_by_tick(topology):
    """The same rows on 8 nodes through both packages' HierarchicalMonitor
    (agents -> v3 wire -> groups -> fleet merge), via the async trio so each
    group's detections are visible: identical wire bytes, per-group flags
    per tick, merged detections and incidents. The second topology arms
    the backpressure governor, which sheds the warmup flush, so the bytes
    carry ``shed`` headers; its layer floor keeps 40 step rows a node, so
    every group warms both layers at warmup (a late warmup's cold fit
    would draw its init from the port's own generator, which parity cannot
    carry across)."""
    rng = np.random.default_rng(0)
    tmon = HierarchicalMonitor(TopologySpec(**topology), device=CPU,
                               **_MON_KW)
    jmon = JMonitor(JTopologySpec(**topology), **_MON_KW)
    tbufs, jbufs = [], []
    tmon.wire_tap, jmon.wire_tap = tbufs.append, jbufs.append
    tcols, jcols = {}, {}
    for nid in range(8):
        tcols[nid] = _TableCollector(EventTable, capacity=1 << 15)
        jcols[nid] = _TableCollector(jevents.EventTable, capacity=1 << 15)
        tmon.register_node(nid, tcols[nid])
        jmon.register_node(nid, jcols[nid])

    def fill(lo, hi, faulty=(), fault_steps=()):
        for nid in range(8):
            rows = _node_rows(rng, lo, hi, faulty=nid in faulty,
                              fault_steps=fault_steps)
            _append(tcols[nid], Layer, rows)
            _append(jcols[nid], jevents.Layer, rows)

    fill(0, 100)
    want = [l.value for l in jmon.warmup()]
    assert [l.value for l in tmon.warmup()] == want and want
    _carry_state(jmon, tmon)
    fault_steps = set(range(140, 160))
    closed_t, closed_j = [], []
    for tick, lo in enumerate(range(100, 200, 20)):
        fill(lo, lo + 20, faulty=(1, 5), fault_steps=fault_steps)
        before = {gid: {l.value: s.log_delta
                        for l, s in g.detector.states.items()}
                  for gid, g in jmon.groups.items()}
        tout = tmon.detect_snapshot(tmon.snapshot())
        jout = jmon.detect_snapshot(jmon.snapshot())
        assert sorted(tout.per_group) == sorted(jout.per_group)
        for gid in jout.per_group:
            _compare_dets(jout.per_group[gid], tout.per_group[gid],
                          before[gid], f"tick {tick} group {gid}")
        closed_t += tmon.admit(tout)
        closed_j += jmon.admit(jout)
        merged = merge_detections(tout.per_group)
        assert set(merged) == set(tmon.last_detections)
        for layer, det in tmon.last_detections.items():
            jdet = jmon.last_detections[jevents.Layer(layer.value)]
            assert det.refit == jdet.refit
            np.testing.assert_array_equal(det.nodes, jdet.nodes)
    closed_t += tmon.finish()
    closed_j += jmon.finish()
    assert tbufs == jbufs
    if topology.get("max_events_per_flush"):
        assert any(wire.decode(b).shed for b in tbufs)
    ti, ji = tmon.incidents, jmon.incidents
    assert ji, "the reference formed no incident"
    assert [(i.suspect_layer.value, i.suspect_nodes, i.steps,
             sorted(i.layer_deficit)) for i in ti] == [
        (i.suspect_layer.value, i.suspect_nodes, i.steps,
         sorted(i.layer_deficit)) for i in ji]
    assert {1, 5} <= set(ti[0].suspect_nodes)
    ts, js = tmon.stats(), jmon.stats()
    assert set(ts) == set(js) and set(ts["tiers"]) == set(js["tiers"])
    assert ts["topology"] == js["topology"]
    assert ts["events_shed"] == js["events_shed"]
    assert (ts["aggregator"]["events_shed_at_source"]
            == ts["events_shed"] == js["aggregator"]["events_shed_at_source"])
    for key in ("events_ingested", "lost_batches", "window_sizes", "nodes",
                "groups"):
        assert ts["aggregator"][key] == js["aggregator"][key], key
    assert set(ts["groups"][0]) == set(js["groups"][0])
    assert ({k: set(v) for k, v in ts["detector"].items()}
            == {k: set(v) for k, v in js["detector"].items()})
    for k in ("k", "groups", "warm_refits", "cold_refits"):
        assert ({n: d[k] for n, d in ts["detector"].items()}
                == {n: d[k] for n, d in js["detector"].items()}), k


def test_fleet_view_reads_like_the_flat_aggregator():
    mon = _tree_fault_run(())
    view = mon.aggregator
    assert isinstance(view, FleetView)
    assert set(view.nodes_seen) == set(range(8))
    op = view.window(Layer.OPERATOR)
    assert len(op) == sum(len(g.agg.windows[Layer.OPERATOR])
                          for g in mon.groups.values())
    assert op.view()["ts"].shape[0] == len(op)
    assert view.stats()["groups"] == 2
    assert view.t_latest == max(g.agg.t_latest for g in mon.groups.values())


def test_monitor_needs_an_explicit_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HierarchicalMonitor(TopologySpec(group_size=4))


# ---------------------------------------------------------------------------
# the session with a topology
# ---------------------------------------------------------------------------

def test_session_stream_with_topology_end_to_end():
    spec = MonitorSpec(
        mode="stream",
        probes=["operator", "step"],
        detector=DetectorSpec(min_events=32, flush_every=8,
                              incident_gap_s=10.0,
                              incident_close_after_s=0.1, min_flags=4),
        topology={"group_size": 2, "fan_in": 32},
        governor=False)
    session = Session(spec, device=CPU)

    def step(x):
        return (x @ torch.sin(x)) / torch.clamp(x.abs().sum(), min=1.0)

    fns, xs = {}, {}
    for nid in range(4):
        node = session.node(nid)
        xs[nid] = torch.ones(32, 32) * (1 + nid)
        fns[nid] = node.observe_step_fn(step, sample_args=(xs[nid],))
    with session.monitoring():
        for s in range(24):
            for nid in fns:
                xs[nid] = fns[nid](xs[nid])
        session.warmup()
        for s in range(24):
            for nid in fns:
                xs[nid] = fns[nid](xs[nid])
            session.on_step(s)
    backend = session.detector
    mon = backend.monitor
    assert isinstance(mon, HierarchicalMonitor) and backend.hierarchical
    assert sorted(mon.groups) == [0, 1]
    assert all(g.detector.device.type == "cpu" for g in mon.groups.values())
    with pytest.raises(AttributeError, match="group_detectors"):
        backend.window_detector
    report = session.result()
    assert report.mode == "stream"
    stream = report.overhead["stream"]
    assert stream["topology"]["group_size"] == 2
    assert stream["aggregator"]["nodes"] == 4
    losses = report.collection_losses()
    assert set(losses) == {"dropped", "shed", "names_truncated"}
    assert losses["shed"] == 0


def test_topology_must_precede_node_registration():
    backend = registry.detector_backend("gmm", "stream")(DetectorSpec(),
                                                         device=CPU)
    backend.register_node(0, _TableCollector())
    with pytest.raises(RuntimeError, match="before nodes register"):
        backend.configure_topology(TopologySpec(group_size=2))


@pytest.mark.parametrize("family", ["isoforest", "mad", "spectral"])
def test_topology_with_another_family_raises_the_references_error(family):
    spec = {"mode": "stream", "detector": {"backend": family},
            "topology": {"group_size": 2}}
    with pytest.raises(ValueError) as mine:
        Session(MonitorSpec.from_dict(spec), device=CPU)
    from repro.session import MonitorSpec as JSpec
    from repro.session import Session as JSession

    with pytest.raises(ValueError) as theirs:
        JSession(JSpec.from_dict(spec))
    assert str(mine.value) == str(theirs.value)
    assert "requires the 'gmm' detector family" in str(mine.value)


def test_detector_backends_equal_the_references():
    assert registry.detector_backends() == jregistry.detector_backends()


# ---------------------------------------------------------------------------
# the collective schedule through observe_step_fn(lowered=)
# ---------------------------------------------------------------------------

# the reference eval runner's DP all-reduce schedule (repro/eval/runner.py)
_FAKE_HLO = "\n".join(
    f"  %ar{i} = f32[{1 << (12 + i)}]{{0}} all-reduce(%g{i}), "
    "replica_groups={}" for i in range(8))


class _Lowered:
    def __init__(self, text):
        self.text = text

    def as_text(self):
        return self.text


def _collective_rows(pkg_registry, collector_cls, step, x, lowered):
    probes = pkg_registry.build_probes(["collective", "step"],
                                       {"collective": {"seed": 0}})
    col = collector_cls(probes)
    with col.monitoring():
        fn = col.observe_step_fn(step, lowered=lowered)
        for _ in range(5):
            x = fn(x)
    cols = col.drain_columns()
    keep = cols["layer"] == np.int8(_CODE[Layer.COLLECTIVE])
    return {k: v[keep] for k, v in cols.items()}


@pytest.mark.parametrize("as_object", [True, False],
                         ids=["as_text", "hlo-string"])
def test_lowered_schedule_fills_the_collective_layer_like_the_reference(
        as_object):
    from repro.core.collector import Collector as JCollector
    from repro_torch.core.collector import Collector

    lowered = _Lowered(_FAKE_HLO) if as_object else _FAKE_HLO
    mine = _collective_rows(registry, Collector, lambda x: x * 2.0,
                            torch.ones(4), lowered)
    theirs = _collective_rows(jregistry, JCollector, lambda x: x * 2.0,
                              jnp.ones(4), _Lowered(_FAKE_HLO))
    assert mine["ts"].shape[0] == 8 + 5 * 8  # static rows + 8 a step
    for k in ("name", "size", "dur", "step", "meta"):
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_session_nodes_pass_lowered_through():
    spec = MonitorSpec(mode="stream", probes=["collective", "step"],
                       probe_options={"collective": {"seed": 0}},
                       detector=DetectorSpec(executor="inline"))
    session = Session(spec, device=CPU)
    with session.monitoring():
        fn = session.node(1).observe_step_fn(lambda x: x,
                                             lowered=_Lowered(_FAKE_HLO))
        fn(torch.ones(2))
        cols = session.node(1).collector.snapshot_columns()
    coll = cols["layer"] == np.int8(_CODE[Layer.COLLECTIVE])
    assert list(cols["name"][coll]) == (["static/all-reduce"] * 8
                                        + ["all-reduce"] * 8)
    np.testing.assert_array_equal(cols["size"][coll][8:],
                                  4.0 * (1 << np.arange(12, 20)))


def test_a_bad_lowered_artifact_warns_like_the_reference():
    from repro_torch.core.collector import Collector

    class Broken:
        def as_text(self):
            raise RuntimeError("no text")

    probes = registry.build_probes(["collective", "step"])
    col = Collector(probes)
    with col.monitoring():
        with pytest.warns(RuntimeWarning, match="register_compiled failed"):
            col.observe_step_fn(lambda x: x, lowered=Broken())


# ---------------------------------------------------------------------------
# the fleet entry point
# ---------------------------------------------------------------------------

def test_fleet_spec_carries_the_reference_demos_values():
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "fleet_spec.json")
    with open(path) as f:
        want = json.load(f)
    got = quickstart.fleet_spec("x.json").to_dict()
    want["sinks"] = [s for s in want["sinks"] if s["kind"] == "report"]
    want["sinks"][0]["path"] = "x.json"
    for key in ("mode", "probes", "probe_options", "governor", "seed"):
        assert got[key] == want[key], key
    for key, value in want["detector"].items():
        assert got["detector"][key] == value, key
    assert {k: got["topology"][k] for k in want["topology"]} == \
        want["topology"]
    assert [s["kind"] for s in got["sinks"]] == ["report"]


def test_run_fleet_on_cpu(tmp_path):
    """8 reduced GPT-2 nodes in 2 groups of 4 through the session's fleet
    plane: every group warms, no batch is lost, the plain GMM versions run
    per group, and node 1's fault is found. The reduced step's wall time
    on a shared CPU wanders by tens of ms, so the fault is scaled up 10x
    to stay separable (as `test_run_stream_smoke_on_cpu` does); the card
    runs the demo's 0.02 s."""
    before = dict(ref.CALLS)
    out = quickstart.run_fleet(reduced_model=True, device=CPU,
                               fault_s=0.2,
                               report_path=str(tmp_path / "fleet.json"))
    ran = {k: ref.CALLS[k] - before[k] for k in before}
    assert ran["gmm_update_ref"] and ran["gmm_best_ref"], ran
    assert all(np.isfinite(v).all() for v in out["losses"].values())
    assert out["groups"] == {0: {"nodes": [0, 1, 2, 3], "warmed": True},
                             1: {"nodes": [4, 5, 6, 7], "warmed": True}}
    stats = out["stats"]
    assert stats["aggregator"]["lost_batches"] == 0
    assert stats["ticks"] == 160 // 16 + 1  # the ticks, then finish()
    assert out["fault_steps"] == (140, 180)
    assert out["hits"], [i.render() for i in out["incidents"]]
    assert (tmp_path / "fleet.json").exists()


def test_run_fleet_sheds_under_a_small_budget(tmp_path):
    out = quickstart.run_fleet(
        reduced_model=True, device=CPU, nodes=4, warmup_steps=32,
        live_steps=64, fault_s=0.0,
        topology={"group_size": 4, "fan_in": 32,
                  "max_events_per_flush": 256},
        report_path=str(tmp_path / "fleet.json"))
    stats = out["stats"]
    assert len(out["groups"]) == 1
    assert stats["events_shed"] > 0
    assert stats["aggregator"]["events_shed_at_source"] == \
        stats["events_shed"]
    assert stats["aggregator"]["lost_batches"] == 0
    assert out["fault_steps"] is None and out["hits"] == []
