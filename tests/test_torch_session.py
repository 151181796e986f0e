"""The port's session slice against the JAX package's: the MonitorSpec and
its JSON, the registries, the Session lifecycle in batch and stream mode
(tests/test_session.py's end-to-end tests on a small torch step), the
diagnosis engine and incident report, the batch backend's flags, the async
executor, the fleet topology, `model_flops`, and the training launcher.
Everything runs on the CPU (``device="cpu"``).

Tolerances, by what is compared: spec JSON, diagnoses, incident reports,
wire bytes, topology shapes and FLOP counts are equal exactly; the batch
backend's flags agree on >= 99% of rows when both carry the same fitted
state, the tolerance of tests/test_torch_gmm.py. Nothing times wall-clock
effects: sessions here use the inline executor or assert only on shapes.
"""
import argparse
import json
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402,F401  (jax on the CPU, as conftest sets)

from repro import roofline as jroofline  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core import events as jevents  # noqa: E402
from repro.diagnosis import engine as jdiag_engine  # noqa: E402
from repro.diagnosis import report as jdiag_report  # noqa: E402
from repro.fleet import topology as jtopology  # noqa: E402
from repro.session import detectors as jdetectors  # noqa: E402
from repro.session import registry as jregistry  # noqa: E402
from repro.session import spec as jspec  # noqa: E402
from repro.stream import incidents as jincidents  # noqa: E402
from repro.stream import wire as jwire  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.config import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import Layer  # noqa: E402
from repro_torch.core import events as tevents  # noqa: E402
from repro_torch.detect import DetectionExecutor  # noqa: E402
from repro_torch.diagnosis import engine as diag_engine  # noqa: E402
from repro_torch.diagnosis import report as diag_report  # noqa: E402
from repro_torch.fleet import topology  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import gmm_params_from_numpy  # noqa: E402
from repro_torch.session import (BatchGMMBackend, DetectorSpec,  # noqa: E402
                                 MonitorSpec, Session, SinkSpec,
                                 read_wire_capture)
from repro_torch.session import registry  # noqa: E402
from repro_torch.session import sinks as sinks_mod  # noqa: E402
from repro_torch.session import spec as tspec  # noqa: E402
from repro_torch.stream import incidents as tincidents  # noqa: E402

CPU = "cpu"


# ---------------------------------------------------------------------------
# MonitorSpec: the same JSON as the reference's
# ---------------------------------------------------------------------------

SPECS = {
    "default": {},
    "batch": {"mode": "batch"},
    "stream_tuned": {
        "mode": "stream", "probes": ["operator", "step"],
        "probe_options": {"device": {"interval": 0.01},
                          "python": {"sample_every": 25}},
        "detector": {"min_events": 32, "flush_every": 8, "executor": "inline",
                     "contamination": 0.05, "incremental": False},
        "sinks": [{"kind": "wire", "path": "x.wire"},
                  {"kind": "report", "options": {"indent": 1}}],
        "governor": False, "seed": 3},
    "topology": {"mode": "stream",
                 "topology": {"group_size": 4, "fan_in": 8}},
    "off_no_diagnosis": {"mode": "off", "diagnosis": False,
                         "capacity": 4096},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_json_equals_the_reference(name):
    d = SPECS[name]
    got = tspec.MonitorSpec.from_dict(json.loads(json.dumps(d)))
    want = jspec.MonitorSpec.from_dict(json.loads(json.dumps(d)))
    assert got.to_json() == want.to_json()
    assert got.to_json(indent=2) == want.to_json(indent=2)
    # and it round-trips through its own JSON
    assert tspec.MonitorSpec.from_json(got.to_json()).to_json() == \
        got.to_json()


def _argparser(mod) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    mod.MonitorSpec.add_cli_args(ap)
    ap.add_argument("--monitor", action="store_true")
    ap.add_argument("--stream-monitor", action="store_true")
    ap.add_argument("--stream-flush-every", type=int, default=25)
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@pytest.mark.parametrize("argv,env", [
    (["--monitor", "--seed", "4"], {}),
    (["--stream-monitor", "--stream-flush-every", "7",
      "--trace-out", "t.json"], {}),
    (["--monitor-spec", '{"mode": "stream", "detector": {"seed": 2}}'], {}),
    ([], {"REPRO_MONITOR_SPEC": '{"mode": "batch"}'}),
    ([], {}),
])
def test_spec_from_args_equals_the_reference(argv, env):
    legacy = {"probe_options": {"python": {"sample_every": 25}},
              "detector": {"min_events": 48}}
    with pytest.warns() if any(a in argv for a in ("--monitor",
                                                   "--stream-monitor")) \
            else _nowarn():
        got = tspec.MonitorSpec.from_args(
            _argparser(tspec).parse_args(argv), env=env,
            legacy_defaults=legacy)
    with pytest.warns() if any(a in argv for a in ("--monitor",
                                                   "--stream-monitor")) \
            else _nowarn():
        want = jspec.MonitorSpec.from_args(
            _argparser(jspec).parse_args(argv), env=env,
            legacy_defaults=legacy)
    assert got.to_json() == want.to_json()


class _nowarn:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("bad", [
    {"mode": "sideways"}, {"frobnicate": 1},
    {"detector": {"executor": "fork"}}, {"detector": {"n_trees_x": 2}},
    {"mode": "batch", "topology": {"group_size": 2}},
    {"mode": "stream", "topology": {"group_size": 64, "fan_in": 8}},
    {"sinks": [{"kind": "wire", "where": "x"}]}])
def test_spec_errors_equal_the_reference(bad):
    with pytest.raises(ValueError) as got:
        tspec.MonitorSpec.from_dict(bad)
    with pytest.raises(ValueError) as want:
        jspec.MonitorSpec.from_dict(bad)
    assert str(got.value) == str(want.value)


def test_spec_with_slos_names_the_serve_slice():
    with pytest.raises(NotImplementedError, match="serve/ slice"):
        MonitorSpec(mode="batch", slo={"ttft_s": 0.4})


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_registry_errors_list_what_is_available():
    with pytest.raises(KeyError) as e:
        registry.build_probe("nope")
    assert ("available: collective, device, operator, python, step, xla"
            in str(e.value))
    with pytest.raises(KeyError) as e:
        registry.detector_backend("nope", "batch")
    assert "available: ('gmm', 'batch'), ('gmm', 'stream')" in str(e.value)
    with pytest.raises(KeyError) as e:
        registry.sink_class("nope")
    assert ("available: incident_report, jsonl, perfetto, report, wire"
            in str(e.value))
    with pytest.raises(KeyError) as e:
        Session(MonitorSpec(mode="batch", probes=["step", "nope"]),
                device=CPU).node(0)
    assert "no probe registered under 'nope'" in str(e.value)


def test_registry_message_format_is_the_reference():
    for mod in (registry, jregistry):
        with pytest.raises(KeyError) as e:
            mod.build_probe("nope")
        assert str(e.value).startswith("\"no probe registered under 'nope'; "
                                       "available: collective, device")


def test_probe_names_are_the_reference_minus_the_serve_plane():
    assert registry.probe_names() == [n for n in jregistry.probe_names()
                                      if n != "request"]


@pytest.mark.parametrize("kind,name,where", [
    ("probe", "request", "serve/"),
    ("detector", "isoforest", "detect/ families"),
    ("detector", "mad", "detect/ families"),
    ("detector", "spectral", "detect/ families")])
def test_later_probes_and_backends_name_their_slice(kind, name, where):
    """What the reference registers and the port does not have yet raises
    an error naming the slice, not a bare lookup miss."""
    assert (name in jregistry.probe_names() if kind == "probe"
            else name in jregistry.detector_names())
    with pytest.raises(NotImplementedError, match=where):
        if kind == "probe":
            registry.build_probe(name)
        else:
            Session(MonitorSpec(mode="batch",
                                detector=DetectorSpec(backend=name)),
                    device=CPU)


@pytest.mark.parametrize("kind", ["prometheus", "board"])
def test_live_sinks_name_the_obs_slice(kind):
    with pytest.raises(NotImplementedError, match="obs/"):
        sinks_mod.build_sink(SinkSpec(kind))


def test_topology_and_telemetry_name_their_slices():
    with pytest.raises(NotImplementedError, match="fleet/ slice"):
        Session(MonitorSpec(mode="stream", topology={"group_size": 2}),
                device=CPU)
    with pytest.raises(NotImplementedError, match="obs/ slice"):
        Session(MonitorSpec(mode="batch"), device=CPU).obs_layer()


# ---------------------------------------------------------------------------
# Session facade (tests/test_session.py's end-to-end tests, on torch)
# ---------------------------------------------------------------------------

def test_session_off_mode_is_identity():
    session = Session(MonitorSpec())

    def fn(x):
        return x

    assert session.observe_step_fn(fn) is fn
    with session.monitoring():
        assert not session.on_step(10)
    report = session.result()
    assert report.mode == "off" and not report.layers


def test_session_batch_end_to_end(tmp_path):
    trace = tmp_path / "trace.json"
    wire_path = tmp_path / "events.wire"
    report_path = tmp_path / "report.json"
    spec = MonitorSpec(
        mode="batch",
        probes=["xla", "operator", "collective", "device", "step"],
        probe_options={"device": {"interval": 0.01}},
        # inline executor: sweeps publish the same step they snapshot, so
        # the mid-run saw_detections assert is deterministic
        detector=DetectorSpec(min_events=16, sweep_every=20,
                              holdoff_steps=5, executor="inline"),
        sinks=[SinkSpec("perfetto", str(trace)),
               SinkSpec("wire", str(wire_path)),
               SinkSpec("report", str(report_path))])
    session = Session(spec, device=CPU)

    def step(x):
        return torch.sin(x) @ torch.cos(x)

    x = torch.ones(16, 16)
    saw_detections = False
    with session.monitoring():
        assert session.warmup() == []  # stream-only: no-op in batch mode
        fn = session.observe_step_fn(step, sample_args=(x,))
        for s in range(45):
            x = fn(x)
            out = session.on_step(s)
            saw_detections |= bool(out.detections)
    assert saw_detections
    report = session.result()
    assert report.mode == "batch"
    assert Layer.STEP.value in report.layers
    assert report.layers[Layer.STEP.value].events == 45
    assert Layer.OPERATOR.value in report.layers
    # sinks delivered
    assert set(report.sink_outputs) == {"perfetto", "wire", "report"}
    data = json.load(open(trace))
    assert len(data["traceEvents"]) > 45
    frames = read_wire_capture(str(wire_path))
    assert sum(len(jwire.decode(b)) for b in frames) == len(
        data["traceEvents"])
    # the capture decodes in the reference's wire, to the same columns
    for buf in frames:
        mine, ref = tevents_decode(buf), jwire.decode(buf)
        assert mine.node_id == ref.node_id and len(mine) == len(ref)
        for k, v in ref.columns.items():
            np.testing.assert_array_equal(mine.columns[k], v, err_msg=k)
        assert jwire.encode_columns(ref.columns, node_id=ref.node_id,
                                    seq=0) == buf
    saved = json.load(open(report_path))
    assert saved["mode"] == "batch" and "step" in saved["layers"]


def tevents_decode(buf):
    from repro_torch.stream import wire

    return wire.decode(buf)


def test_session_stream_multinode(tmp_path):
    spec = MonitorSpec(
        mode="stream",
        probes=["operator", "step"],
        detector=DetectorSpec(min_events=32, flush_every=8,
                              incident_gap_s=10.0,
                              incident_close_after_s=0.1, min_flags=4,
                              executor="inline"),
        sinks=[SinkSpec("jsonl", str(tmp_path / "ev.jsonl")),
               SinkSpec("incident_report", str(tmp_path / "inc.md"))],
        governor=False)
    session = Session(spec, device=CPU)

    def step(x):
        return (x @ torch.sin(x)) / torch.clamp(x.abs().sum(), min=1.0)

    fns = {}
    xs = {}
    for nid in (0, 1):
        node = session.node(nid)
        xs[nid] = torch.ones(32, 32) * (1 + nid)
        fns[nid] = node.observe_step_fn(step, sample_args=(xs[nid],))
    with session.monitoring():
        for s in range(24):
            for nid in (0, 1):
                xs[nid] = fns[nid](xs[nid])
        assert session.warmup()
        for s in range(24):
            for nid in (0, 1):
                xs[nid] = fns[nid](xs[nid])
            session.on_step(s)
    report = session.result()
    assert report.mode == "stream"
    assert Layer.OPERATOR.value in report.layers
    # both node collectors flowed through the wire into the jsonl sink
    lines = [json.loads(l) for l in open(tmp_path / "ev.jsonl")]
    assert {l["pid"] for l in lines} == {0, 1}
    assert report.sink_outputs["jsonl"].endswith("ev.jsonl")
    assert (tmp_path / "inc.md").read_text().startswith("# Incident report")
    # stream overhead block is carried alongside per-node stats
    assert report.overhead["stream"]["aggregator"]["nodes"] == 2
    assert report.overhead["detect_plane"]["mode"] == "inline"


def test_session_runs_the_thread_executor_and_closes_it():
    spec = MonitorSpec(mode="batch", probes=["operator", "step"],
                       detector=DetectorSpec(min_events=8, sweep_every=10,
                                             holdoff_steps=2))
    session = Session(spec, device=CPU)
    assert session._executor.mode == "thread"
    assert session._executor.stream is None  # a CUDA stream on the card

    def step(x):
        return x + 1.0

    with session.monitoring():
        fn = session.observe_step_fn(step, sample_args=(torch.ones(4),))
        x = torch.zeros(4)
        for s in range(31):
            x = fn(x)
            session.on_step(s)
    plane = session.result().overhead["detect_plane"]
    # every sweep ran or was superseded by a newer one (which, depends on
    # the host's timing), and none is left queued
    assert plane["submitted"] == 3 and plane["errors"] == 0
    assert plane["completed"] + plane["coalesced"] == 3
    assert plane["queue_depth"] == 0
    assert not session._executor._worker.is_alive()


# ---------------------------------------------------------------------------
# diagnosis: the same incidents give the same diagnoses
# ---------------------------------------------------------------------------

def _incident(mod, layer_mod, layer_deficit, iid=1, nodes=(1,),
              steps=range(50, 62), n_flags=20, t_start=10.0, t_end=12.0,
              layer_first_ts=None):
    suspect = max(layer_deficit, key=layer_deficit.get)
    return mod.Incident(
        incident_id=iid, t_start=t_start, t_end=t_end,
        suspect_layer=layer_mod(suspect), suspect_nodes=list(nodes),
        severity=float(sum(layer_deficit.values())), n_flags=n_flags,
        steps=list(steps), layer_deficit=dict(layer_deficit),
        node_flags={int(n): n_flags for n in nodes}, status="closed",
        layer_first_ts=dict(layer_first_ts or {}))


def _device_rows(kind, t0=10.0, t1=12.0):
    rng = np.random.default_rng(0)
    ts = np.concatenate([np.linspace(0, t0 - 0.1, 80),
                         np.linspace(t0, t1, 40)])
    util = np.full(ts.shape, 50.0) + rng.normal(0, 1.0, ts.shape)
    mem = np.full(ts.shape, 4.0) + rng.normal(0, 0.05, ts.shape)
    if kind == "mem_leak":
        mem[80:] = 4.0 + 0.1 * np.arange(40)
    else:
        util[80:] += 30.0
        mem[80:] += rng.uniform(1.0, 4.0, 40)
    return {"ts": ts, "dur": np.zeros_like(ts), "size": np.zeros_like(ts),
            "name": np.full(ts.shape, "gpu0"), "step": np.full(ts.shape, -1),
            "node": np.zeros(ts.shape, dtype=np.int32), "util": util,
            "mem_gb": mem, "power_w": np.full(ts.shape, 100.0),
            "temp_c": np.full(ts.shape, 60.0)}


def _collective_rows(kind, steps, t0=10.0):
    rng = np.random.default_rng(1)
    msgs = 8
    sizes = np.tile([4096.0, 65536.0], msgs // 2)
    base = sizes / 50e9 + 1e-5
    rows = [(np.full(msgs, 5.0 + 0.1 * i), base.copy(), sizes,
             np.full(msgs, st)) for i, st in enumerate(range(20, 40))]
    for i, st in enumerate(steps):
        dur = base.copy()
        if kind == "net_latency":
            dur = dur * 4.0
        else:
            hit = rng.random(msgs) < 0.45
            dur[hit] *= 1.0 + rng.integers(1, 4, hit.sum())
        rows.append((np.full(msgs, t0 + i * 0.1), dur, sizes,
                     np.full(msgs, st)))
    cat = [np.concatenate([r[i] for r in rows]) for i in range(4)]
    n = cat[0].shape[0]
    return {"ts": cat[0], "dur": cat[1], "size": cat[2],
            "name": np.full(n, "all-reduce"),
            "step": cat[3].astype(np.int64),
            "node": np.zeros(n, dtype=np.int32),
            "util": np.full(n, np.nan), "mem_gb": np.full(n, np.nan),
            "power_w": np.full(n, np.nan), "temp_c": np.full(n, np.nan)}


STEPS = list(range(50, 62))
DIAG_CASES = {
    "operator": ({"operator": 9415.0, "step": 352.0}, None),
    "xla_equal_step": ({"xla": 3000.0, "step": 3000.0}, None),
    "step_only": ({"step": 5000.0}, None),
    "stall_excess": ({"step": 9000.0, "operator": 1800.0,
                      "xla": 400.0}, None),
    "below_floor": ({"collective": 40.0}, None),
    "mem_leak": ({"device": 5000.0}, ("device", "mem_leak")),
    "contention": ({"device": 5000.0}, ("device", "hw_contention")),
    "net_latency": ({"collective": 20000.0}, ("collective", "net_latency")),
    "packet_loss": ({"collective": 20000.0}, ("collective", "packet_loss")),
    "uncorroborated": ({"device": 5000.0, "step": 100.0}, None),
    "chain": ({"operator": 4000.0, "device": 900.0, "step": 2000.0}, None),
}


def _evidence(layer_mod, which):
    if which is None:
        return None
    layer, kind = which
    rows = (_device_rows(kind) if layer == "device"
            else _collective_rows(kind, STEPS))
    return {layer_mod(layer): rows}


@pytest.mark.parametrize("case", sorted(DIAG_CASES))
def test_diagnoses_equal_the_reference(case):
    deficit, which = DIAG_CASES[case]
    first = {l: 10.0 + 0.1 * i for i, l in enumerate(sorted(deficit))}
    steps = () if which and which[0] == "device" else STEPS
    mine = _incident(tincidents, tevents.Layer, deficit, steps=steps,
                     layer_first_ts=first)
    ref = _incident(jincidents, jevents.Layer, deficit, steps=steps,
                    layer_first_ts=first)
    got = diag_engine.Diagnoser().diagnose(mine,
                                           _evidence(tevents.Layer, which))
    want = jdiag_engine.Diagnoser().diagnose(ref,
                                             _evidence(jevents.Layer, which))
    assert (got is None) == (want is None)
    if want is None:
        return
    assert json.dumps(got.to_json(), default=float, sort_keys=True) == \
        json.dumps(want.to_json(), default=float, sort_keys=True)
    assert got.render() == want.render()


def test_incident_report_equals_the_reference():
    cases = ("operator", "below_floor", "net_latency")

    def build(inc_mod, layer_mod, engine, report):
        incs, diags = [], []
        for i, case in enumerate(cases, start=1):
            deficit, which = DIAG_CASES[case]
            inc = _incident(inc_mod, layer_mod, deficit, iid=i, steps=STEPS)
            incs.append(inc)
            d = engine.Diagnoser().diagnose(inc, _evidence(layer_mod, which))
            if d is not None:
                diags.append(d)
        return (report.render_incident_report(incs, diags, mode="stream"),
                report.report_json(incs, diags),
                engine.diagnoses_to_json(diags))

    got = build(tincidents, tevents.Layer, diag_engine, diag_report)
    want = build(jincidents, jevents.Layer, jdiag_engine, jdiag_report)
    assert got == want


def test_evidence_from_columns_equals_the_reference():
    rng = np.random.default_rng(3)
    n = 60
    codes = rng.integers(0, len(jevents.LAYERS), n).astype(np.int8)
    cols = {"ts": np.sort(rng.random(n)), "dur": rng.random(n),
            "size": rng.random(n), "name": np.array([f"n{i % 3}"
                                                     for i in range(n)]),
            "step": np.arange(n), "pid": rng.integers(0, 2, n),
            "layer": codes, "util": rng.random(n), "mem_gb": rng.random(n),
            "power_w": rng.random(n), "temp_c": rng.random(n)}
    got = diag_engine.evidence_from_columns(cols)
    want = jdiag_engine.evidence_from_columns(cols)
    assert [l.value for l in got] == [l.value for l in want]
    for (lt, ev), (lj, ew) in zip(got.items(), want.items()):
        assert sorted(ev) == sorted(ew)
        for k in ew:
            np.testing.assert_array_equal(ev[k], ew[k], err_msg=k)


# ---------------------------------------------------------------------------
# the batch backend's flags
# ---------------------------------------------------------------------------

def _synth_columns(n_steps=200, seed=0):
    """Operator + step rows with a latency fault in steps 120..160, as
    tests/test_session.py's `_synth_events`, columnar."""
    rng = np.random.default_rng(seed)
    table = jevents.EventTable(8 * n_steps)
    for s in range(n_steps):
        t = 0.02 * s
        slow = 10.0 if 120 <= s < 160 else 1.0
        for j in range(4):
            table.append_rows(jevents.Layer.OPERATOR, f"op{j}",
                              t + 1e-3 * j,
                              dur=float(slow * 1e-4 * (j + 1)
                                        * rng.lognormal(0, 0.05)),
                              size=1e5 * (j + 1), step=s)
        table.append_rows(jevents.Layer.STEP, "train_step", t,
                          dur=float(slow * 5e-3 * rng.lognormal(0, 0.05)),
                          step=s)
    return table.drain_columns()


def test_batch_backend_flags_agree_with_the_reference():
    cols = _synth_columns()
    train = {k: v[cols["step"] < 100] for k, v in cols.items()}
    spec_kw = dict(min_events=16)
    want_b = jdetectors.BatchGMMBackend(jspec.DetectorSpec(**spec_kw))
    got_b = BatchGMMBackend(DetectorSpec(**spec_kw), device=CPU)
    assert sorted(l.value for l in got_b.fit(train)) == \
        sorted(l.value for l in want_b.fit(train))
    # the reference's fitted state in the port's detectors (EM's cold init
    # draws differ: jax.random against numpy)
    for layer, jd in want_b._monitor.detectors.items():
        td = got_b._monitor.detectors[Layer(layer.value)]
        td.gmm.params = gmm_params_from_numpy(
            [np.asarray(p) for p in jd.gmm.params], CPU)
        td.std.mean, td.std.std = jd.std.mean, jd.std.std
        td.log_delta = jd.log_delta
    got, want = got_b.update(cols), want_b.update(cols)
    assert sorted(l.value for l in got) == sorted(l.value for l in want)
    for layer, w in want.items():
        g = got[Layer(layer.value)]
        np.testing.assert_array_equal(g.steps, w.steps)
        assert np.mean(g.flags == w.flags) >= 0.99, layer
    assert got_b.flags() is got


# ---------------------------------------------------------------------------
# the async executor
# ---------------------------------------------------------------------------

def test_inline_executor_runs_at_submit_in_a_detection_zone():
    from repro_torch.detect import in_detection_zone

    ex = DetectionExecutor(mode="inline")
    seq = ex.submit("batch", lambda: in_detection_zone(), step=7)
    (r,) = ex.drain()
    assert (r.key, r.seq, r.step, r.value, r.error) == ("batch", seq, 7,
                                                        True, None)
    assert not in_detection_zone()
    ex.close()


def test_thread_executor_coalesces_and_keeps_errors_as_data():
    ex = DetectionExecutor(mode="thread")
    gate = threading.Event()
    ex.submit("a", gate.wait)  # occupies the worker
    ex.submit("b", lambda: 1)
    ex.submit("b", lambda: 2)  # replaces the queued b
    ex.submit("c", lambda: 1 / 0)
    gate.set()
    assert ex.flush(timeout=30)
    done = {r.key: r for r in ex.drain()}
    assert done["b"].value == 2 and isinstance(done["c"].error,
                                               ZeroDivisionError)
    stats = ex.stats()
    assert (stats["coalesced"], stats["errors"], stats["completed"]) == \
        (1, 1, 3)
    ex.close()
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit("a", lambda: 0)


# ---------------------------------------------------------------------------
# fleet topology and model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,n_nodes", [({}, 100), ({"group_size": 4,
                                                     "fan_in": 8}, 30),
                                        ({"group_size": 1, "fan_in": 1}, 1)])
def test_topology_equals_the_reference(kw, n_nodes):
    got = topology.FleetTopology(topology.TopologySpec(**kw))
    want = jtopology.FleetTopology(jtopology.TopologySpec(**kw))
    assert got.shape(n_nodes) == want.shape(n_nodes)
    assert [got.group_of(i) for i in range(n_nodes)] == \
        [want.group_of(i) for i in range(n_nodes)]
    assert got.spec.to_dict() == want.spec.to_dict()


@pytest.mark.parametrize("kind,seq,batch", [("train", 128, 8),
                                            ("prefill", 1024, 2),
                                            ("decode", 4096, 16)])
def test_model_flops_equal_the_reference(kind, seq, batch):
    got = roofline.model_flops(get_arch("gpt2"),
                               ShapeConfig("x", seq, batch, kind))
    want = jroofline.model_flops(jget_arch("gpt2"),
                                 JShape("x", seq, batch, kind))
    assert got == want > 0


# ---------------------------------------------------------------------------
# the training launcher
# ---------------------------------------------------------------------------

def test_launcher_batch_smoke_on_cpu(capsys):
    """`python -m repro_torch.launch.train --reduced --device cpu --steps 60
    --monitor-spec '{"mode": "batch"}' --inject-faults` runs to a
    MonitorReport (its shape is checked, not its detection quality)."""
    rc = launch_train.main(["--reduced", "--device", "cpu", "--steps", "60",
                            "--batch", "4", "--seq", "32", "--monitor-spec",
                            '{"mode": "batch"}', "--inject-faults",
                            "--log-every", "0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "monitor report (batch mode):" in out
    assert "operator" in out and "final loss" in out and "on cpu" in out


def test_launcher_returns_the_session_and_report():
    args = launch_train.parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "30", "--batch", "2",
         "--seq", "16", "--monitor-spec",
         '{"mode": "stream", "detector": {"flush_every": 10, '
         '"min_events": 16, "executor": "inline"}}', "--log-every", "0"])
    out = launch_train.train(args)
    assert len(out["losses"]) == 30 and np.isfinite(out["losses"]).all()
    report = out["report"]
    assert report.mode == "stream" and out["session"].device.type == "cpu"
    emitted = report.overhead[0]["emitted_per_probe"]
    assert set(emitted) == set(tspec.STANDARD_PROBES)
    assert emitted["operator"] == 24 + 30 * 24 and emitted["step"] == 60


def test_launcher_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "2"])


@pytest.mark.parametrize("flags,module", [
    (["--data-mesh", "2"], "launch/mesh.py"),
    (["--checkpoint-dir", "ckpt"], "train/checkpoint.py"),
    (["--metrics-port", "0"], "obs/"),
    (["--board-out", "b.html"], "obs/"),
    (["--microbatches", "2"], "train/step.py"),
    (["--optimizer", "adafactor"], "optim/")])
def test_launcher_names_the_slice_of_an_unported_flag(flags, module, capsys):
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--reduced", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert module in capsys.readouterr().err
