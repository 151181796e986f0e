"""Where a clean control gets diagnosed: the same flag rows through both
packages' `IncidentEngine` and `Diagnoser` give the same incidents and the
same diagnoses.

Three sources of rows: an incident that the evaluation's clean control
closed and diagnosed on the card (``tests/golden/clean_control_incident_card.json``,
written by ``scripts/clean_control_rate.py --fixture``), a stall-free one
(``tests/golden/clean_control_stall_free_card.json``, the flag rows with
their names from the incident's line that script printed), and a synthetic
hiccup train — a steady 240-step cell whose collective layer flags ~2% of
its rows barely past the threshold (the contamination quantile does so by
construction) while a few host-side slow steps flag the step, runtime and
operator rows of their step with large deficits. The engine runs at the
evaluation's settings (``gap_s`` 0.25, ``close_after_s`` 0.25,
``min_flags`` 5) and the diagnoser at its defaults (``min_mean_deficit``
20 nats).

Also here: how the port's step probe waits for a step on the card (one
blocking CUDA event) and the rows it leaves, against the reference's; the
runtime layer's rows a step against the reference's (its ``executable_run``
and the job's graph launch; neither the monitor's own wait nor a device
time); the runtime probe's rows written only once a monitored step is
timed; and the device probe's rows against the reference's.
"""
import collections
import dataclasses
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core.events import Layer as JLayer  # noqa: E402
from repro.diagnosis import Diagnoser as JDiagnoser  # noqa: E402
from repro.stream.incidents import IncidentEngine as JIncidentEngine  # noqa: E402
from repro_torch.core.events import Layer  # noqa: E402
from repro_torch.core.probes.device_probe import DeviceProbe  # noqa: E402
from repro_torch.core.probes.step_probe import StepProbe  # noqa: E402
from repro_torch.diagnosis import Diagnoser  # noqa: E402
from repro_torch.stream.incidents import IncidentEngine  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CARD_FIXTURE = os.path.join(HERE, "golden", "clean_control_incident_card.json")
ENGINE = {"gap_s": 0.25, "close_after_s": 0.25, "min_flags": 5}
STEP_S = 0.0195  # a graphed GPT-2 step (~17.5 ms) + the 2 ms host pacing


@dataclasses.dataclass
class Flags:
    """What `IncidentEngine.ingest` reads off a detection."""

    ts: np.ndarray
    nodes: np.ndarray
    steps: np.ndarray
    flags: np.ndarray
    scores: np.ndarray
    log_delta: float = 0.0


def _detections(layer_cls, rows, sel):
    """Per-layer `Flags` of the rows ``sel``: deficit d as score -d."""
    out = {}
    for name in np.unique(rows["layer"][sel]):
        on = sel & (rows["layer"] == name)
        out[layer_cls(str(name))] = Flags(
            ts=rows["ts"][on], nodes=rows["node"][on].astype(np.int32),
            steps=rows["step"][on].astype(np.int64),
            flags=np.ones(on.sum(), dtype=bool),
            scores=-rows["deficit"][on])
    return out


def _run(engine_cls, layer_cls, diagnoser_cls, rows, ticks, evidence):
    """Feed ``rows`` tick by tick (rows with ts <= each tick's time), then
    flush; diagnose every closed incident."""
    eng = engine_cls(**ENGINE)
    done = np.zeros(rows["ts"].shape[0], dtype=bool)
    for now in ticks:
        sel = ~done & (rows["ts"] <= now)
        done |= sel
        eng.update(_detections(layer_cls, rows, sel), now=now)
    eng.flush()
    incidents = eng.ranked()
    ev = {layer_cls(k): v for k, v in evidence.items()}
    diags = diagnoser_cls().diagnose_all(incidents, ev)
    return incidents, diags


def _incident_sig(incs):
    return [(i.incident_id, i.suspect_layer.value, i.n_flags,
             round(i.severity, 6), i.steps,
             {k: round(v, 6) for k, v in i.layer_deficit.items()},
             {k: round(v, 9) for k, v in i.layer_first_ts.items()})
            for i in incs]


def _diag_sig(diags):
    return [(d.incident_id, d.fault_kind, round(d.confidence, 9),
             d.candidates, d.steps,
             [(c.layer, round(c.deficit, 6)) for c in d.causal_chain])
            for d in diags]


def both(rows, ticks, evidence=None):
    evidence = evidence or {}
    mine = _run(IncidentEngine, Layer, Diagnoser, rows, ticks, evidence)
    theirs = _run(JIncidentEngine, JLayer, JDiagnoser, rows, ticks, evidence)
    assert _incident_sig(mine[0]) == _incident_sig(theirs[0])
    assert _diag_sig(mine[1]) == _diag_sig(theirs[1])
    return mine


# ---------------------------------------------------------------------------
# a synthetic hiccup train
# ---------------------------------------------------------------------------

def hiccup_train(seed, hiccups, xla_rows=1, n_steps=240, eval_start=96):
    """Flag rows of one clean cell's live region: collective flags at ~2%
    of 8 rows a step with deficits under 1 nat; each (step, excess_ms) in
    ``hiccups`` flags its step's STEP row, its ``xla_rows`` runtime rows
    and its 24 operator rows, with deficits that grow with the excess
    against a steady step (the tighter the baseline, the larger)."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("ts", "layer", "node", "step", "deficit")}

    def add(layer, step, deficits):
        n = len(deficits)
        cols["ts"] += list(step * STEP_S + rng.uniform(0, 1e-3, n))
        cols["layer"] += [layer] * n
        cols["node"] += [0] * n
        cols["step"] += [step] * n
        cols["deficit"] += list(deficits)

    for s in range(eval_start, n_steps):
        k = rng.binomial(8, 0.02)
        if k:
            add("collective", s, rng.uniform(0.0, 0.8, k))
    for s, excess_ms in hiccups:
        scale = 12.0 * excess_ms  # nats per flag for the steady step
        add("step", s, [scale * rng.uniform(0.8, 1.2)])
        add("xla", s, scale * rng.uniform(0.5, 1.2, xla_rows))
        add("operator", s, scale * rng.uniform(0.3, 1.1, 24))
    rows = {k: np.asarray(v) for k, v in cols.items()}
    rows["layer"] = rows["layer"].astype(str)
    ticks = [s * STEP_S + 2e-3 for s in range(eval_start + 20, n_steps + 1, 20)]
    return rows, ticks


@pytest.mark.parametrize("seed,hiccups,xla_rows", [
    (0, [], 1),                                   # quiet: no incident diagnosed
    (1, [(130, 1.0)], 1),                         # one small hiccup
    (2, [(120, 2.5), (180, 4.0)], 1),             # two, the reference's width
    (3, [(120, 2.5), (180, 4.0)], 3),             # the same, 3 runtime rows
    (4, [(101, 6.0), (150, 1.5), (151, 1.5), (220, 3.0)], 1),
    (5, [(101, 6.0), (150, 1.5), (151, 1.5), (220, 3.0)], 3),
])
def test_hiccup_train_gives_the_reference_s_incidents(seed, hiccups,
                                                       xla_rows):
    rows, ticks = hiccup_train(seed, hiccups, xla_rows)
    incidents, diags = both(rows, ticks)
    if not hiccups:
        assert diags == []
    for d in diags:
        assert d.fault_kind in ("op_latency", "xla_latency", "python_latency")


def test_chained_collective_flags_dilute_a_hiccup():
    """The incident a clean cell forms is one chain of barely-flagged
    collective rows; a hiccup's deficit is averaged over the whole chain
    (``min_mean_deficit`` divides the severity by every flag), so the same
    hiccup is diagnosed or not by how many flags share its incident."""
    rows, ticks = hiccup_train(7, [(150, 3.0)], 1)
    incidents, _ = both(rows, ticks)
    inc = max(incidents, key=lambda i: i.severity)
    assert inc.layer_deficit.get("collective", 0.0) < 0.1 * inc.severity
    assert len(inc.steps) > 3


# ---------------------------------------------------------------------------
# the incident diagnosed on the card
# ---------------------------------------------------------------------------

def _card_fixture():
    if not os.path.exists(CARD_FIXTURE):
        pytest.fail(f"{CARD_FIXTURE} is missing: write it with "
                    "scripts/clean_control_rate.py --fixture on the card")
    with open(CARD_FIXTURE) as f:
        return json.load(f)


def test_card_incident_gives_the_reference_s_diagnosis():
    fx = _card_fixture()
    rows = {k: np.asarray(v) for k, v in fx["rows"].items()}
    rows["layer"] = rows["layer"].astype(str)
    evidence = {}
    for layer, cols in fx["evidence"].items():
        ev = {k: np.asarray(v) for k, v in cols.items()}
        ev["name"] = ev["name"].astype(str)
        ev["step"] = ev["step"].astype(np.int64)
        ev["node"] = ev["node"].astype(np.int64)
        evidence[layer] = ev
    assert fx["engine"] == ENGINE
    incidents, diags = both(rows, [float(rows["ts"].max()) + 1.0], evidence)
    (inc,) = incidents
    assert inc.n_flags == fx["incident"]["n_flags"]
    np.testing.assert_allclose(inc.severity, fx["incident"]["severity"],
                               rtol=1e-9)
    (d,) = diags
    assert d.fault_kind == fx["diagnosis"]["fault_kind"]
    np.testing.assert_allclose(d.confidence, fx["diagnosis"]["confidence"],
                               rtol=1e-9)


STALL_FREE_FIXTURE = os.path.join(HERE, "golden",
                                  "clean_control_stall_free_card.json")


def test_stall_free_card_incident_rests_on_rows_the_repaired_layer_drops():
    """The stall-free clean-control incident that pass B's stream cell
    closed and diagnosed on the card under the runtime layer of four rows
    a step: both packages give the card's incident (15 flags) and its
    blame (``xla_latency``, the card's confidence to the fixture's four
    decimals of deficit). Its deficit sits on the step probe's own wait
    (``cudaEventSynchronize``), a row the repaired layer no longer writes
    (nor ``graph_exec``); without those rows neither package diagnoses
    anything."""
    with open(STALL_FREE_FIXTURE) as f:
        fx = json.load(f)
    assert fx["stall_free"] and fx["engine"] == ENGINE
    rows = {k: np.asarray(fx["rows"][k])
            for k in ("ts", "layer", "node", "step", "deficit", "name")}
    rows["layer"] = rows["layer"].astype(str)
    ticks = [float(rows["ts"].max()) + 1.0]
    incidents, diags = both(rows, ticks, fx["evidence"])
    (inc,) = incidents
    assert inc.n_flags == fx["incident"]["n_flags"] == 15
    (d,) = diags
    assert d.fault_kind == fx["diagnosis"]["fault_kind"] == "xla_latency"
    np.testing.assert_allclose(d.confidence, fx["diagnosis"]["confidence"],
                               rtol=1e-6)
    gone = np.isin(rows["name"], ["cudaEventSynchronize", "graph_exec"])
    assert rows["deficit"][gone].sum() > 0.95 * rows["deficit"].sum()
    kept = {k: v[~gone] for k, v in rows.items()}
    incidents, diags = both(kept, ticks, fx["evidence"])
    assert diags == []
    assert all(i.severity / i.n_flags < Diagnoser().min_mean_deficit
               for i in incidents)


# ---------------------------------------------------------------------------
# the step probe waits for the step on a blocking event
# ---------------------------------------------------------------------------

class _Event:
    """A stand-in for `torch.cuda.Event` that logs what the probe asks."""

    made = []

    def __init__(self, blocking=False, **kw):
        self.blocking = blocking
        self.calls = []
        _Event.made.append(self)

    def record(self, stream=None):
        self.calls.append("record")

    def synchronize(self):
        self.calls.append("synchronize")


def test_step_probe_waits_on_one_blocking_event(monkeypatch):
    """On the card each monitored step records one CUDA event and waits on
    it: a blocking one (the thread sleeps until the card signals) for the
    first step and after a step of `SPIN_BELOW_S` or more, a spinning one
    after a shorter step; each made once."""
    import torch

    from repro_torch.core.events import EventTable
    from repro_torch.core.probes.step_probe import SPIN_BELOW_S

    _Event.made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    probe = StepProbe()
    probe.attach(EventTable(64))

    def step(long):
        if long:
            time.sleep(2 * SPIN_BELOW_S)
        return long

    fn = probe.wrap(step)
    # blocking (first), spinning, spinning, blocking (after a long one)
    assert [fn(x) for x in (False, False, True, False)] == \
        [False, False, True, False]
    probe.detach()
    blocking, spinning = _Event.made
    assert blocking.blocking is True and spinning.blocking is False
    assert blocking.calls == ["record", "synchronize"] * 2
    assert spinning.calls == ["record", "synchronize"] * 2


def test_step_probe_rows_are_the_reference_s():
    """The rows a monitored step leaves (the STEP row and the runtime
    layer's ``executable_run``) are the reference's, step for step."""
    from repro.core.events import EventTable as JEventTable
    from repro.core.probes.step_probe import StepProbe as JStepProbe
    from repro_torch.core.events import EventTable

    got = []
    for probe, table in ((StepProbe(), EventTable(64)),
                         (JStepProbe(), JEventTable(64))):
        probe.attach(table)
        fn = probe.wrap(lambda: time.sleep(0.001))
        for _ in range(4):
            fn()
        probe.detach()
        cols = table.drain_columns()
        got.append([(str(n), int(s)) for n, s in zip(cols["name"],
                                                       cols["step"])])
    assert got[0] == got[1] == [(n, s) for s in range(4)
                                for n in ("executable_run", "train_step")]


class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph`: a replay that does nothing."""

    def replay(self):
        pass


def test_runtime_layer_rows_a_step_are_the_reference_s(monkeypatch):
    """A graphed step under the port's step and runtime probes (the CUDA
    entry points stood in for) leaves, a step, the reference's
    ``executable_run`` and the job's one ``cudaGraphLaunch``: the step
    probe's wait for the step passes through the hooked
    ``Event.synchronize`` unrecorded, and no device-time row is written.
    The reference's jitted step, past its compile, leaves
    ``executable_run`` alone (``block_until_ready`` raises no
    ``jax.monitoring`` event)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core.events import EventTable as JEventTable
    from repro.core.events import LAYER_CODE as JLAYER_CODE
    from repro.core.probes.jax_probe import JaxRuntimeProbe
    from repro.core.probes.step_probe import StepProbe as JStepProbe
    from repro_torch.core.events import LAYER_CODE, EventTable
    from repro_torch.core.probes import CudaRuntimeProbe

    n = 12
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((16, 16))
    f(x).block_until_ready()  # compiled before the probes attach
    jt = JEventTable(256)
    jrt, jstep = JaxRuntimeProbe(), JStepProbe()
    jrt.attach(jt)
    jstep.attach(jt)
    jfn = jstep.wrap(lambda: f(x))
    for _ in range(n):
        jfn()
    jstep.detach()
    jrt.detach()
    jcols = jt.drain_columns()
    theirs = {str(k): v for k, v in collections.Counter(
        str(nm) for nm, l in zip(jcols["name"], jcols["layer"])
        if int(l) == JLAYER_CODE[JLayer.XLA]).items()}

    _Event.made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    graph = _Graph()
    table = EventTable(256)
    t0 = time.perf_counter()
    rt, step = CudaRuntimeProbe(), StepProbe()
    rt.attach(table, t0=t0)
    step.attach(table, t0=t0)
    fn = step.wrap(graph.replay)
    for _ in range(n):
        fn()
    step.detach()
    rt.detach()
    cols = table.drain_columns()
    mine = collections.Counter(
        str(nm) for nm, l in zip(cols["name"], cols["layer"])
        if int(l) == LAYER_CODE[Layer.XLA])
    assert {k: v / n for k, v in theirs.items()} == {"executable_run": 1.0}
    assert {k: v / n for k, v in mine.items()} == \
        {"executable_run": 1.0, "cudaGraphLaunch": 1.0}
    # the step probe waited every step, through the hooked entry point
    calls = [c for e in _Event.made for c in e.calls]
    assert calls.count("record") == calls.count("synchronize") == n
    assert "synchronize" in vars(_Event)  # the hooks are gone again


def test_runtime_rows_wait_until_the_step_is_timed(monkeypatch):
    """A runtime call made inside a monitored step is written once the
    step's time is taken — after the step probe's own rows, with its own
    timestamp and duration — and a call outside a step at once."""
    import torch

    from repro_torch.core.events import EventTable
    from repro_torch.core.probes import CudaRuntimeProbe

    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    table = EventTable(64)
    rt, step = CudaRuntimeProbe(), StepProbe()
    t0 = time.perf_counter()
    rt.attach(table, t0=t0)
    step.attach(table, t0=t0)
    seen = []

    def work():
        torch.cuda.synchronize()
        seen.append(table.drain_columns()["name"].tolist())

    fn = step.wrap(work)
    fn()
    torch.cuda.synchronize()
    outside = table.drain_columns()["name"].tolist()
    fn()
    step.detach()
    rt.detach()
    cols = table.drain_columns()
    assert seen == [[], []]  # nothing written while the step ran
    assert outside == ["executable_run", "train_step",
                       "cudaDeviceSynchronize", "cudaDeviceSynchronize"]
    names = cols["name"].tolist()
    assert names == ["executable_run", "train_step", "cudaDeviceSynchronize"]
    (t_step,) = cols["ts"][cols["name"] == "train_step"]
    (d_step,) = cols["dur"][cols["name"] == "train_step"]
    (t_rt,) = cols["ts"][cols["name"] == "cudaDeviceSynchronize"]
    assert t_step <= t_rt <= t_step + d_step


def test_device_rows_are_the_reference_s():
    """One sample: a ``host.process`` row and a row a device, with the
    telemetry columns the reference's probe fills."""
    from repro.core.probes.device_probe import DeviceProbe as JDeviceProbe
    from repro_torch.core.events import EventTable

    pytest.importorskip("psutil")
    from repro.core.events import EventTable as JEventTable

    mine, theirs = DeviceProbe(), JDeviceProbe()
    t1, t2 = EventTable(64), JEventTable(64)
    for probe, table in ((mine, t1), (theirs, t2)):
        # attached without the sampling thread: one sample by hand
        probe._sink, probe._attached = table, True
        probe._t0 = time.perf_counter()
    mine.sample_once()
    theirs.sample_once()
    a, b = t1.drain_columns(), t2.drain_columns()
    assert [n.replace("gpu", "tpu") for n in a["name"]] == list(b["name"])
    for k in ("util", "mem_gb", "power_w", "temp_c"):
        assert np.isnan(a[k][0]) and np.isnan(b[k][0])
        assert np.isfinite(a[k][1]) and np.isfinite(b[k][1])
