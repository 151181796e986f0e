"""The port's monitor self-telemetry (`repro_torch.obs`) against the JAX
package's (`repro.obs`): tests/test_obs.py on the port, with both packages
given the same operations and inputs. The registry's exposition text is
the reference's character for character, the parser rejects the same
documents with the same messages, the board renders the same HTML, a live
session's `SessionObs` exposes the reference's families, and the launchers'
``--metrics-port`` / ``--board-out`` run on the CPU.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro import obs as jobs  # noqa: E402
from repro.core import Layer as JLayer  # noqa: E402
from repro.obs import board as jboard  # noqa: E402
from repro.session import (DetectorSpec as JDetectorSpec,  # noqa: E402
                           MonitorSpec as JMonitorSpec, Session as JSession,
                           SinkSpec as JSinkSpec)
from repro_torch.core import Layer  # noqa: E402
from repro_torch.obs import (Counter, ExpositionError, Gauge,  # noqa: E402
                             Histogram, METRIC_NAMES, MetricRegistry,
                             parse_exposition)
from repro_torch.obs.board import (BoardModel, DiagnosisCard,  # noqa: E402
                                   IncidentRow, LayerRow, NodeCard,
                                   render_board)
from repro_torch.session import (DetectorSpec, MonitorSpec,  # noqa: E402
                                 Session, SinkSpec)

CPU = "cpu"


# ---------------------------------------------------------------------------
# registry semantics, each against the reference's registry
# ---------------------------------------------------------------------------

def _both_registries(**kw):
    return MetricRegistry(**kw), jobs.MetricRegistry(**kw)


def test_counter_monotonicity():
    for reg in _both_registries():
        c = reg.counter("t_total", "help", labels=("node",))
        c.inc(node="0")
        c.inc(2.5, node="0")
        assert c.value(node="0") == 3.5
        with pytest.raises(ValueError, match="negative increment"):
            c.inc(-1.0, node="0")
        c.set_total(10.0, node="0")
        assert c.value(node="0") == 10.0
        c.set_total(4.0, node="0")  # a source reset never rewinds it
        assert c.value(node="0") == 10.0
    mine, theirs = _both_registries()
    for reg in (mine, theirs):
        reg.counter("t_total", "help", labels=("node",)).set_total(
            3.0, node="1")
    assert mine.render() == theirs.render()


def test_gauge_and_type_conflicts():
    for reg in _both_registries():
        g = reg.gauge("t_gauge", "help")
        g.set(5.0)
        g.set(-2.0)
        assert g.value() == -2.0
        with pytest.raises(ValueError, match="already registered"):
            reg.counter("t_gauge", "help")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("t_gauge", "help", labels=("x",))
        assert reg.gauge("t_gauge", "help") is g
    assert isinstance(MetricRegistry().gauge("g", "h"), Gauge)
    assert isinstance(MetricRegistry().counter("c", "h"), Counter)


def test_histogram_cumulative_buckets():
    out = []
    for reg in _both_registries():
        h = reg.histogram("t_ms", "help", buckets=(1.0, 5.0, 10.0))
        for v in (0.5, 0.7, 3.0, 7.0, 100.0):
            h.observe(v)
        assert h.count() == 5
        samples = {name + labels: v for name, labels, v in h.samples()}
        assert samples['t_ms_bucket{le="1"}'] == 2
        assert samples['t_ms_bucket{le="5"}'] == 3
        assert samples['t_ms_bucket{le="10"}'] == 4
        assert samples['t_ms_bucket{le="+Inf"}'] == 5
        assert samples["t_ms_count"] == 5
        assert samples["t_ms_sum"] == pytest.approx(111.2)
        with pytest.raises(ValueError, match="distinct and sorted"):
            reg.histogram("t_bad", "help", buckets=(1.0, 1.0))
        out.append(reg.render())
    assert out[0] == out[1]
    assert isinstance(MetricRegistry().histogram("h", "h"), Histogram)


def test_label_cardinality_cap_counts_drops():
    out = []
    for reg in _both_registries(max_label_sets=3):
        c = reg.counter("t_total", "help", labels=("op",))
        for i in range(10):
            c.inc(op=f"op{i}")
        assert sum(v for _, _, v in c.samples()) == 3
        dropped = reg.get(type(reg).LABELS_DROPPED)
        assert dropped.value(metric="t_total") == 7
        c.inc(op="op0")
        assert c.value(op="op0") == 2
        out.append(reg.render())
    assert out[0] == out[1]


def test_label_mismatch_raises():
    for reg in _both_registries():
        c = reg.counter("t_total", "help", labels=("node",))
        with pytest.raises(ValueError, match="takes labels"):
            c.inc(layer="step")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("0bad", "help")
        with pytest.raises(ValueError, match="invalid label name"):
            reg.counter("t2_total", "help", labels=("bad-label",))


# ---------------------------------------------------------------------------
# exposition format
# ---------------------------------------------------------------------------

def _fill(reg):
    c = reg.counter("req_total", "requests", labels=("node", "layer"))
    c.inc(3, node="0", layer="step")
    c.inc(1, node="1", layer='we"ird\nname')  # needs label escaping
    reg.gauge("occ", "occupancy").set(0.75)
    h = reg.histogram("lat_ms", "latency", labels=("layer",),
                      buckets=(1.0, 10.0))
    h.observe(0.5, layer="step")
    h.observe(50.0, layer="step")
    return reg.render()


def test_rendered_registry_is_valid_exposition():
    text = _fill(MetricRegistry())
    assert text == _fill(jobs.MetricRegistry())  # the reference's text
    exp = parse_exposition(text)
    assert set(exp.families) == {"req_total", "occ", "lat_ms",
                                 MetricRegistry.LABELS_DROPPED}
    assert exp.families["lat_ms"] == "histogram"
    assert exp.sample("req_total", node="0", layer="step").value == 3
    assert exp.sample("req_total", node="1").labels["layer"] == 'we"ird\nname'
    assert exp.sample("lat_ms_bucket", layer="step", le="+Inf").value == 2
    assert exp.sample("lat_ms_count", layer="step").value == 2
    theirs = jobs.parse_exposition(text)
    assert theirs.families == exp.families
    assert [(s.name, s.labels, s.value) for s in theirs.samples] == \
        [(s.name, s.labels, s.value) for s in exp.samples]


@pytest.mark.parametrize("doc,msg", [
    ("up 1\n", "no preceding # TYPE"),
    ("# TYPE up gauge\nup 1\nup 1\n", "duplicate series"),
    ("# TYPE up gauge\n# TYPE up gauge\nup 1\n", "duplicate TYPE"),
    ("# TYPE up widget\nup 1\n", "unknown type"),
    ("# TYPE c_total counter\nc_total -1\n", "non-monotone"),
    ("# TYPE up gauge\nup x\n", "unparseable value"),
    ("# TYPE a gauge\n# TYPE b gauge\na 1\nb 2\na 3\n", "not contiguous"),
    ('# TYPE h histogram\nh_bucket{le="1"} 1\nh_count 1\n',
     "missing .Inf bucket"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n',
     "not cumulative"),
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 3\nh_count 2\n',
     "_count"),
])
def test_parser_rejects_invalid_documents(doc, msg):
    with pytest.raises(ExpositionError, match=msg) as mine:
        parse_exposition(doc)
    with pytest.raises(jobs.ExpositionError, match=msg) as theirs:
        jobs.parse_exposition(doc)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# status board HTML
# ---------------------------------------------------------------------------

def _board_model(mod, refresh_s=2):
    return mod.BoardModel(
        title="test fleet", mode="stream", generated="2026-01-01 00:00:00",
        uptime_s=42.0, refresh_s=refresh_s,
        nodes=[mod.NodeCard(node_id=0, state="healthy", freshness_s=0.2,
                            events_shipped=1200, bytes_shipped=64000),
               mod.NodeCard(node_id=1, state="stale", freshness_s=31.0,
                            events_shipped=400, ring_dropped=7)],
        layers=[mod.LayerRow(layer="operator", window_rows=512,
                             flag_rate=0.21, log_delta=3.4,
                             spark=(0.0, 0.05, 0.21))],
        incidents=[mod.IncidentRow(incident_id=1, t_start=10.0, t_end=12.5,
                                   suspect_layer="operator",
                                   suspect_nodes=[1], severity=8.5,
                                   n_flags=42, status="closed")],
        diagnoses=[mod.DiagnosisCard(
            incident_id=1, fault_kind="op_latency", confidence=0.93,
            severity=8.5, blamed_nodes=[1],
            causal_chain=["operator", "step"], action_kind="alert",
            action_reason="<script>x</script> latency")],
        totals={"events ingested": 99_000})


class _Mine:
    BoardModel, NodeCard, LayerRow = BoardModel, NodeCard, LayerRow
    IncidentRow, DiagnosisCard = IncidentRow, DiagnosisCard


def test_board_golden_shows_incident_and_diagnosis():
    html_text = render_board(_board_model(_Mine))
    assert html_text == jboard.render_board(_board_model(jboard))
    for marker in ('id="fleet"', 'id="incidents"', 'id="diagnoses"',
                   'data-node="1"', 'data-state="stale"',
                   'data-kind="op_latency"'):
        assert marker in html_text
    assert "operator" in html_text and "op_latency" in html_text
    assert "alert" in html_text
    assert '<meta http-equiv="refresh" content="2">' in html_text
    assert "<svg" in html_text
    assert "<script>" not in html_text
    assert "&lt;script&gt;" in html_text


def test_board_final_render_stops_refreshing():
    html_text = render_board(_board_model(_Mine, refresh_s=0))
    assert html_text == jboard.render_board(_board_model(jboard,
                                                         refresh_s=0))
    assert 'http-equiv="refresh"' not in html_text


def test_board_empty_model_renders():
    kw = dict(title="empty", mode="batch", generated="t", uptime_s=0.0,
              refresh_s=2, nodes=[], layers=[], incidents=[], diagnoses=[],
              totals={})
    html_text = render_board(BoardModel(**kw))
    assert html_text == jboard.render_board(jboard.BoardModel(**kw))
    assert "no incidents" in html_text and "no nodes registered" in html_text


# ---------------------------------------------------------------------------
# live session: endpoint smoke, freshness flip, the board sink
# ---------------------------------------------------------------------------

OPS = np.array(["matmul", "sin", "div", "sum"])


def _emit_steps(buf, steps, layer=Layer, t0=0.0, dt=0.05):
    """Synthetic operator+step activity straight into a node's ring (the
    probe suite is empty — the tests drive the pipeline deterministically)."""
    for s in steps:
        t = t0 + dt * s
        durs = 1e-4 * (1.0 + np.arange(len(OPS)))
        buf.append_rows(layer.OPERATOR, OPS, np.full(len(OPS), t), dur=durs,
                        step=np.full(len(OPS), s))
        buf.append_rows(layer.STEP, "step", t, dur=5e-3, step=s)


def _stream_spec(tmp_path, sink_options=None, pkg=None):
    m, d, s = ((JMonitorSpec, JDetectorSpec, JSinkSpec) if pkg == "jax"
               else (MonitorSpec, DetectorSpec, SinkSpec))
    return m(mode="stream", probes=[],
             detector=d(flush_every=5, min_events=32, min_flags=4),
             sinks=[s(kind="prometheus",
                      path=str(tmp_path / "metrics.prom"),
                      options=dict(sink_options or {})),
                    s(kind="board", path=str(tmp_path / "board.html"))],
             governor=False)


def test_endpoint_serves_valid_exposition_and_health(tmp_path):
    spec = _stream_spec(tmp_path, {"serve": True, "port": 0})
    session = Session(spec, device=CPU)
    with session.monitoring():
        _emit_steps(session.node(0).collector.buffer, range(40))
        session.warmup()
        url = session.sink("prometheus").url
        assert url is not None and session.sink("prometheus").port > 0
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert "version=0.0.4" in r.headers["Content-Type"]
            body = r.read().decode("utf-8")
        exp = parse_exposition(body)
        families = exp.family_names()
        assert len(families) >= 20, families
        assert set(METRIC_NAMES) <= set(families)
        assert exp.sample("eacgm_ring_events_appended_total",
                          node="0").value > 0
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read().decode("utf-8"))
        assert health["status"] == "ok" and health["mode"] == "stream"
        assert health["scrapes"] >= 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nope", timeout=10)
    report = session.result()
    with open(report.sink_outputs["prometheus"]) as f:
        parse_exposition(f.read())
    assert "board" in report.sink_outputs


def test_a_taken_port_fails_the_session(tmp_path):
    """Nothing falls back silently: a prometheus sink that cannot bind its
    port raises when the session is built."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        port = sock.getsockname()[1]
        with pytest.raises(OSError):
            Session(_stream_spec(tmp_path, {"serve": True, "port": port}),
                    device=CPU)


def test_stale_node_flips_when_agent_stops_flushing(tmp_path):
    spec = _stream_spec(tmp_path, {"degraded_after_s": 0.5,
                                   "stale_after_s": 1.0})
    session = Session(spec, device=CPU)
    with session.monitoring():
        b0 = session.node(0).collector.buffer
        b1 = session.node(1).collector.buffer
        _emit_steps(b0, range(40))
        _emit_steps(b1, range(40))
        session.warmup()
        states = {nid: state for nid, state, _ in session.obs.node_states()}
        assert states == {0: "healthy", 1: "healthy"}
        _emit_steps(b0, range(40, 80))
        session.tick()
        states = {nid: (state, fresh)
                  for nid, state, fresh in session.obs.node_states()}
        assert states[0][0] == "healthy"
        assert states[1][0] == "stale" and states[1][1] >= 1.0
        exp = parse_exposition(session.obs.scrape())
        assert exp.sample("eacgm_node_state", node="0").value == 0
        assert exp.sample("eacgm_node_state", node="1").value == 2
        assert exp.sample("eacgm_node_freshness_seconds",
                          node="1").value >= 1.0
        health = session.obs.health()
        assert health["status"] == "degraded"
        assert health["node_states"]["1"] == "stale"


def test_board_sink_tracks_live_session(tmp_path):
    spec = _stream_spec(tmp_path)
    session = Session(spec, device=CPU)
    with session.monitoring():
        _emit_steps(session.node(0).collector.buffer, range(40))
        session.warmup()
        live = (tmp_path / "board.html").read_text()
        assert 'http-equiv="refresh"' in live
        assert 'data-node="0"' in live
    final = (tmp_path / "board.html").read_text()
    assert 'http-equiv="refresh"' not in final
    assert 'id="fleet"' in final


def _families(body):
    exp = parse_exposition(body)
    return {n: exp.families[n] for n in exp.family_names()}


def test_session_obs_families_equal_the_reference_s(tmp_path):
    """The same synthetic rows through a stream session of each package:
    the scrape holds the same families, of the same types, with the same
    ring counts; both catalogues are the same."""
    assert METRIC_NAMES == jobs.METRIC_NAMES
    scrapes = []
    for pkg, layer, make in (("torch", Layer,
                              lambda s: Session(s, device=CPU)),
                             ("jax", JLayer, JSession)):
        out = tmp_path / pkg
        out.mkdir()
        session = make(_stream_spec(out, pkg=pkg))
        with session.monitoring():
            _emit_steps(session.node(0).collector.buffer, range(40), layer)
            session.warmup()
            scrapes.append(session.obs.scrape())
    mine, theirs = (parse_exposition(b) for b in scrapes)
    assert _families(scrapes[0]) == _families(scrapes[1])
    for name in ("eacgm_ring_events_appended_total",
                 "eacgm_ring_capacity", "eacgm_fleet_events_ingested_total",
                 "eacgm_window_occupancy"):
        got = sorted((tuple(sorted(s.labels.items())), s.value)
                     for s in mine.samples if s.name == name)
        want = sorted((tuple(sorted(s.labels.items())), s.value)
                      for s in theirs.samples if s.name == name)
        assert got == want and got, name


def test_shape_cache_family_reads_the_port_s_cache(tmp_path):
    """The compile-cache families mirror `repro_torch.detect.SHAPE_CACHE`,
    which the stream detector writes on every scoring and fold."""
    from repro_torch.detect import SHAPE_CACHE

    session = Session(_stream_spec(tmp_path), device=CPU)
    with session.monitoring():
        _emit_steps(session.node(0).collector.buffer, range(40))
        session.warmup()
        session.tick()
        exp = parse_exposition(session.obs.scrape())
        st = SHAPE_CACHE.stats()
    hits = exp.sample("eacgm_detect_compile_cache_hits_total").value
    misses = exp.sample("eacgm_detect_compile_cache_misses_total").value
    assert misses > 0 and hits + misses > 0
    assert (hits, misses) == (st["hits"], st["misses"])


def test_obs_layer_is_shared_and_needs_a_monitored_session(tmp_path):
    session = Session(_stream_spec(tmp_path), device=CPU)
    assert session.obs is session.obs_layer() is \
        session.sink("board").obs is session.sink("prometheus").obs
    with pytest.raises(RuntimeError, match="no telemetry"):
        Session(MonitorSpec(mode="off"), device=CPU).obs_layer()


# ---------------------------------------------------------------------------
# the launchers' flags on the CPU
# ---------------------------------------------------------------------------

def _scrape_while(fn, url_box, n=3):
    """Run ``fn`` in a thread; scrape ``url_box[0]/metrics`` ``n`` times
    while it runs. Returns (fn's result, bodies)."""
    box, bodies = {}, []
    t = threading.Thread(target=lambda: box.update(out=fn()))
    t.start()
    while t.is_alive() and len(bodies) < n:
        if url_box:
            try:
                with urllib.request.urlopen(url_box[0] + "/metrics",
                                            timeout=5) as r:
                    bodies.append(r.read().decode("utf-8"))
            except OSError:
                pass
        time.sleep(0.05)
    t.join(timeout=300)
    return box.get("out"), bodies


def test_train_launcher_serves_metrics_and_writes_the_board(tmp_path,
                                                           monkeypatch):
    from repro_torch.launch import train
    from repro_torch.obs import sinks as obs_sinks

    urls = []
    bind = obs_sinks.PrometheusSink.bind_session

    def bind_kept(self, session):
        bind(self, session)
        urls.append(self.url)

    monkeypatch.setattr(obs_sinks.PrometheusSink, "bind_session", bind_kept)
    board = tmp_path / "board.html"
    args = train.parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "120", "--batch", "2",
         "--seq", "16", "--log-every", "0", "--monitor-spec",
         '{"mode": "stream", "detector": {"flush_every": 10}}',
         "--metrics-port", "0", "--board-out", str(board)])
    out, bodies = _scrape_while(lambda: train.train(args), urls)
    assert len(out["losses"]) == 120
    assert bodies, "no scrape while the run was live"
    for body in bodies:
        parse_exposition(body)
    final = board.read_text()
    assert 'id="fleet"' in final and 'http-equiv="refresh"' not in final
    report = out["report"]
    assert set(report.sink_outputs) == {"prometheus", "board"}


def test_serve_launcher_accepts_the_obs_flags(tmp_path):
    from repro_torch.launch import serve

    board = tmp_path / "board.html"
    assert serve.main(
        ["--reduced", "--device", "cpu", "--num-requests", "4",
         "--monitor-spec", '{"mode": "batch"}', "--metrics-port", "0",
         "--board-out", str(board)]) == 0
    assert 'http-equiv="refresh"' not in board.read_text()
