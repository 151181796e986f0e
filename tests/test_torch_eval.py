"""The port's evaluation harness against the JAX package's, on the CPU:
`repro_torch.eval.{metrics,matrix,fixtures,runner}` and
`repro_torch.launch.evaluate` fed the same seeded inputs as `repro.eval`.

Tolerances, by what is compared:

* metrics, matrix, fixtures: NumPy and pure Python in both packages, so
  every `to_json()`, row, leaderboard and file is equal exactly and every
  array is `np.array_equal`; the fixture events are bit-identical.
* the golden masks (`compute_golden`) of the NumPy families (isoforest,
  mad, spectral) are equal; the GMM family's cold fit draws its init from
  NumPy, not `jax.random`, and reaches the same likelihood with other
  flagged rows, so its masks are held to tests/test_detector_conformance.py's
  own criteria for a mask (burst rows >= 90% flagged; the clean case of the
  committed seed 0 under the FAR ceiling) and their flagged share to within
  5% of rows of the reference's, not to 2% row agreement, which a different
  init does not keep (ROADMAP §3).
* the synthetic step: float32 products summed in another order, within
  rtol 1e-5 / atol 1e-6. Four normalised products take the runner's input
  to ~1e-12, so there the atol decides.
* end-to-end runs measure wall time, so their flags are not compared bit
  for bit: the reference's own thresholds are
  (tests/test_eval.py::test_run_scenario_end_to_end_batch), and the
  COLLECTIVE rows, which the schedule fixes, are counted exactly.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402  (jax on the CPU, as conftest sets)

from repro.core import chaos as jchaos  # noqa: E402
from repro.core.events import Layer as JLayer  # noqa: E402
from repro.core.probes import collective_probe as jcollective  # noqa: E402
from repro.eval import fixtures as jfixtures  # noqa: E402
from repro.eval import matrix as jmatrix  # noqa: E402
from repro.eval import metrics as jmetrics  # noqa: E402
from repro.eval import runner as jrunner  # noqa: E402
from repro.stream.incidents import Incident as JIncident  # noqa: E402
from repro_torch.core import chaos  # noqa: E402
from repro_torch.core.events import Layer  # noqa: E402
from repro_torch.core.probes import collective_probe  # noqa: E402
from repro_torch.eval import fixtures, matrix, metrics, runner  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import evaluate  # noqa: E402
from repro_torch.stream.incidents import Incident  # noqa: E402

CPU = "cpu"
LAYERS = ["xla", "operator", "collective", "device", "step"]
TRAIN = [n for n in chaos.scenario_names()
         if chaos.get_scenario(n).workload == "train"]
SERVE_PLANE = [n for n in chaos.scenario_names() if n not in TRAIN]


class _Det:
    """Minimal stand-in for DetectionResult / WindowDetection."""

    def __init__(self, steps, flags, ts=None):
        self.steps = np.asarray(steps)
        self.flags = np.asarray(flags, dtype=bool)
        self.ts = None if ts is None else np.asarray(ts, dtype=float)


def _random_dets(rng, n_steps, with_ts=True):
    """Per-layer detections over ``n_steps``: a few events a step, some
    with unknown (-1) or out-of-range steps; flags denser in two bursts."""
    out = {}
    burst = np.zeros(n_steps + 5, dtype=bool)
    lo = int(rng.integers(0, n_steps // 2))
    burst[lo:lo + 8] = True
    for name in rng.choice(LAYERS, size=int(rng.integers(1, 6)),
                           replace=False):
        n = int(rng.integers(0, 6 * n_steps))
        steps = rng.integers(-1, n_steps + 5, n)
        p = np.where(burst[np.clip(steps, 0, n_steps + 4)], 0.8, 0.08)
        flags = rng.random(n) < p
        ts = np.sort(rng.random(n)) * 10 if with_ts else None
        out[str(name)] = _Det(steps, flags, ts)
    return out


def _both(dets):
    return ({JLayer(k): v for k, v in dets.items()},
            {Layer(k): v for k, v in dets.items()})


def _assert_pred_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# metrics: equal to the reference's on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("vote", [0.25, 0.5, 1.0])
def test_step_predictions_equal_the_reference(seed, vote):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 120))
    jd, td = _both(_random_dets(rng, n))
    _assert_pred_equal(metrics.step_predictions(td, n, vote=vote),
                       jmetrics.step_predictions(jd, n, vote=vote))


def test_step_predictions_hand_built_equal_the_reference():
    """tests/test_eval.py's majority-vote case."""
    a = _Det(steps=[1, 1, 1, 1, 2, 2, 2, 2], flags=[1, 1, 1, 0, 1, 0, 0, 0])
    b = _Det(steps=[1, 2, 3], flags=[0, 0, 1])
    c = _Det(steps=[-1, -1], flags=[1, 1])
    for dets in ({"operator": a, "step": b}, {"xla": c}):
        jd, td = _both(dets)
        got = metrics.step_predictions(td, 5)
        _assert_pred_equal(got, jmetrics.step_predictions(jd, 5))
    assert got["any"].tolist() == [False] * 5


@pytest.mark.parametrize("seed", range(8))
def test_debounce_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    pred = rng.random(int(rng.integers(1, 200))) < rng.uniform(0.1, 0.8)
    for min_run in range(0, 6):
        np.testing.assert_array_equal(metrics.debounce(pred, min_run),
                                      jmetrics.debounce(pred, min_run))
    for hand in ([0, 1, 0, 1, 1, 0, 1, 1, 1, 1], [0, 0, 1, 1], [0, 0, 0]):
        hand = np.asarray(hand, dtype=bool)
        for min_run in (1, 2, 3):
            np.testing.assert_array_equal(metrics.debounce(hand, min_run),
                                          jmetrics.debounce(hand, min_run))


@pytest.mark.parametrize("seed", range(4))
def test_first_flag_ts_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    jd, td = _both(_random_dets(rng, 40, with_ts=bool(seed % 2)))
    assert metrics.first_flag_ts(td) == jmetrics.first_flag_ts(jd)
    quiet = {"xla": _Det([0], [0], ts=[0.1])}
    assert metrics.first_flag_ts(_both(quiet)[1]) is None


def _random_labels(rng, n):
    labels = np.zeros(n, dtype=bool)
    windows = []
    for _ in range(int(rng.integers(0, 4))):
        lo = int(rng.integers(0, n))
        hi = min(n + int(rng.integers(0, 3)), lo + int(rng.integers(2, 12)))
        labels[lo:hi] = True
        windows.append((lo, hi))
    return labels, windows


@pytest.mark.parametrize("seed", range(10))
def test_detection_metrics_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 200))
    labels, windows = _random_labels(rng, n)
    pred = rng.random(n) < 0.2
    pred |= labels & (rng.random(n) < 0.7)
    kw = dict(eval_start=int(rng.integers(0, n // 2)),
              grace_steps=int(rng.integers(0, 10)),
              step_ts=(np.cumsum(rng.random(n)) if seed % 3 else None))
    got = metrics.detection_metrics(pred, labels, windows, **kw)
    want = jmetrics.detection_metrics(pred, labels, windows, **kw)
    assert got.to_json() == want.to_json()
    assert got.fault_recall == want.fault_recall


def test_detection_metrics_hand_built_equal_the_reference():
    """tests/test_eval.py's hand-built, grace and clean cases."""
    labels = np.zeros(20, dtype=bool)
    labels[8:12] = labels[15:18] = True
    pred = np.zeros(20, dtype=bool)
    pred[9:12] = pred[4] = True
    cases = [(pred, labels, [(8, 12), (15, 18)],
              dict(eval_start=2, grace_steps=2, step_ts=np.arange(20) * 0.5))]
    labels2 = np.zeros(30, dtype=bool)
    labels2[8:12] = labels2[14:18] = True
    cases.append((labels2 & (np.arange(30) >= 14), labels2,
                  [(8, 12), (14, 18)], dict(grace_steps=10)))
    cases.append((np.zeros(10, bool), np.zeros(10, bool), [],
                  dict(eval_start=0)))
    for p, y, w, kw in cases:
        got = metrics.detection_metrics(p, y, w, **kw)
        assert got.to_json() == jmetrics.detection_metrics(p, y, w,
                                                           **kw).to_json()
    assert got.fault_recall == 1.0 and got.ttd_steps is None


def _incidents(cls, layer, rng, n):
    out = []
    for i in range(n):
        lo = int(rng.integers(0, 200))
        out.append(cls(
            incident_id=i + 1, t_start=0.0, t_end=1.0, suspect_layer=layer,
            suspect_nodes=[0], severity=float(rng.random()), n_flags=3,
            steps=sorted(set(rng.integers(lo, lo + 12, 4).tolist())),
            layer_deficit={}, node_flags={}, status="closed",
            kind=str(rng.choice(["anomaly", "slo_breach"]))))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_slo_breach_metrics_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 8))
    mine = _incidents(Incident, Layer.STEP, np.random.default_rng(seed), n)
    theirs = _incidents(JIncident, JLayer.STEP, np.random.default_rng(seed),
                        n)
    windows = _random_labels(rng, 220)[1]
    for grace in (0, 4, 40):
        got = metrics.slo_breach_metrics(mine, windows, grace_steps=grace)
        want = jmetrics.slo_breach_metrics(theirs, windows, grace_steps=grace)
        assert got.to_json() == want.to_json()


def _faults(mod, rng):
    kinds = [k for k in mod.ALL_KINDS]
    out = []
    for _ in range(int(rng.integers(0, 6))):
        lo = int(rng.integers(0, 150))
        out.append(mod.Fault(str(rng.choice(kinds)), lo,
                             lo + int(rng.integers(2, 30)), 1.0))
    return out


@dataclasses.dataclass
class _Action:
    kind: str


@dataclasses.dataclass
class _Diagnosis:
    """The fields `diagnosis_metrics` reads off a Diagnosis."""

    steps: list
    t_start: float
    t_end: float
    fault_kind: str
    blamed_nodes: list
    action: _Action


def _diagnoses(rng, actions):
    out = []
    for _ in range(int(rng.integers(0, 7))):
        lo = int(rng.integers(0, 180))
        steps = ([] if rng.random() < 0.3
                 else sorted(set(rng.integers(lo, lo + 10, 3).tolist())))
        t0 = float(rng.uniform(0, 10))
        out.append(_Diagnosis(
            steps=steps, t_start=t0, t_end=t0 + float(rng.uniform(0, 3)),
            fault_kind=str(rng.choice(chaos.ALL_KINDS)),
            blamed_nodes=rng.integers(0, 3, int(rng.integers(0, 3))).tolist(),
            action=_Action(str(rng.choice(actions)))))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_window_kinds_and_diagnosis_metrics_equal_the_reference(seed):
    from repro_torch.core.governor import POLICIES

    actions = sorted({p.action for p in POLICIES.values()})
    mine = _faults(chaos, np.random.default_rng(seed))
    theirs = _faults(jchaos, np.random.default_rng(seed))
    got_w, want_w = metrics.window_kinds(mine), jmetrics.window_kinds(theirs)
    assert got_w == want_w
    rng = np.random.default_rng(100 + seed)
    diags = _diagnoses(rng, actions)
    ids = np.arange(200)
    clock = (ids, np.linspace(0.0, 12.0, 200)) if seed % 2 else None
    for grace in (0, 4):
        kw = dict(grace_steps=grace, fault_nodes=(0,), step_clock=clock)
        got = metrics.diagnosis_metrics(diags, mine, **kw)
        want = jmetrics.diagnosis_metrics(diags, theirs, **kw)
        assert got.to_json() == want.to_json()


# ---------------------------------------------------------------------------
# matrix: constants, helpers and artifacts equal to the reference's
# ---------------------------------------------------------------------------

def test_matrix_constants_equal_the_reference():
    assert matrix.FAR_CEILING == jmatrix.FAR_CEILING
    assert matrix.MODES == jmatrix.MODES
    assert matrix.BAKEOFF_CONFIGS == jmatrix.BAKEOFF_CONFIGS
    assert list(matrix.CONFIG_GRID) == list(jmatrix.CONFIG_GRID)
    for name, cfg in matrix.CONFIG_GRID.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jmatrix.CONFIG_GRID[name])
        assert matrix._config_json(cfg) == jmatrix._config_json(
            jmatrix.CONFIG_GRID[name])


_CELLS = [("clean_control", "train", (), ()),
          ("latency_spike", "train", ("op_latency",), ("operator", "step")),
          ("comm_slowdown", "train", ("net_latency",), ("collective", "step")),
          ("mixed_fault", "train", ("op_latency", "net_latency",
                                    "hw_contention"), ("operator",)),
          ("serve_clean_control", "request", (), ("request",)),
          ("serve_tenant_flood", "request", ("tenant_flood",), ("request",))]


def _random_rows(rng):
    rows = []
    for scenario, workload, kinds, layers in _CELLS:
        for mode in ("batch", "stream"):
            for cname in rng.choice(list(matrix.CONFIG_GRID),
                                    size=int(rng.integers(1, 4)),
                                    replace=False):
                cfg = matrix.CONFIG_GRID[str(cname)]
                faulty = bool(kinds)
                m = {"precision": float(rng.random()),
                     "recall": float(rng.random()),
                     "f1": float(rng.choice([0.0, 0.5, float(rng.random())])),
                     "false_alarm_rate": float(rng.random() * 0.3),
                     "ttd_steps": float(rng.random() * 9) if faulty else None,
                     "ttd_s": None,
                     "faults_total": 3 if faulty else 0,
                     "faults_detected": int(rng.integers(0, 4)) if faulty
                     else 0, "eval_steps": 144, "anomalous_steps": 27}
                row = {"scenario": scenario, "workload": workload,
                       "kinds": list(kinds), "expected_layers": list(layers),
                       "mode": mode, "config": cfg.name,
                       "detector": cfg.backend,
                       "detect_ms_per_window": (None if rng.random() < 0.2
                                                else round(float(
                                                    rng.random() * 50), 3)),
                       "eval_start": 96, "fault_windows": [[113, 127]],
                       "metrics": m, "layers": {}, "wall_s": 1.5}
                if cfg.diagnosis:
                    n = int(rng.integers(0, 4))
                    acc = (None if n == 0 and not faulty else
                           float(rng.random()) if n else 0.0)
                    row["diagnosis"] = {
                        "kinds": [], "actions": [], "diagnoses_total": n,
                        "windows_total": 3 if faulty else 0,
                        "kind_accuracy": acc, "action_match_rate": acc}
                if workload == "request":
                    row["slo"] = {"incidents_total": int(rng.integers(0, 3)),
                                  "windows_total": 2 if faulty else 0,
                                  "recall": float(rng.random())}
                rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_matrix_helpers_equal_the_reference(seed, tmp_path):
    rows = _random_rows(np.random.default_rng(seed))
    if seed == 0:  # a matrix without the control scenarios
        rows = [r for r in rows if "clean" not in r["scenario"]
                and r["workload"] != "request"]
    mx = {"n_steps": 240, "seed": seed, "modes": ["batch", "stream"],
          "configs": {}, "far_ceiling": matrix.FAR_CEILING, "rows": rows}
    mx["winners"] = matrix.crown_winners(rows)
    assert mx["winners"] == jmatrix.crown_winners(rows)
    for fn in ("render_leaderboard", "clean_control_far",
               "clean_control_diagnoses", "mean_kind_accuracy",
               "serve_clean_breaches", "serve_breach_recall"):
        assert getattr(matrix, fn)(mx) == getattr(jmatrix, fn)(mx), fn
    mine = matrix.save_matrix(mx, str(tmp_path / "port"))
    theirs = jmatrix.save_matrix(mx, str(tmp_path / "ref"))
    for key in ("matrix", "leaderboard"):
        with open(mine[key]) as a, open(theirs[key]) as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------------
# fixtures: bit-identical events; golden masks against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_fixture_suite_is_bit_identical(seed):
    from repro.core.events import events_to_columns as jcols
    from repro_torch.core.events import events_to_columns as tcols

    assert fixtures.FIXTURE_KINDS.keys() == jfixtures.FIXTURE_KINDS.keys()
    assert (fixtures.TRAIN_ROWS, fixtures.WINDOW_ROWS, fixtures.BURST_ROWS) \
        == (jfixtures.TRAIN_ROWS, jfixtures.WINDOW_ROWS, jfixtures.BURST_ROWS)
    got, want = fixtures.fixture_suite(seed), jfixtures.fixture_suite(seed)
    assert list(got) == list(want)
    for kind in want:
        (gt, gw, gtruth, gl), (wt, ww, wtruth, wl) = got[kind], want[kind]
        assert gl.value == wl.value
        np.testing.assert_array_equal(gtruth, wtruth)
        for g, w in ((gt, wt), (gw, ww)):
            assert [e.to_json() for e in g] == [e.to_json() for e in w]
            gc, wc = tcols(g), jcols(w)
            assert list(gc) == list(wc)
            for k in wc:
                np.testing.assert_array_equal(gc[k], wc[k])


@pytest.fixture(scope="module")
def goldens():
    return {seed: (fixtures.compute_golden(seed=seed, device=CPU),
                   jfixtures.compute_golden(seed=seed)) for seed in (0, 1)}


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_golden_agrees_with_the_reference(goldens, seed):
    got, want = goldens[seed]
    assert {k: v for k, v in got.items() if k != "cases"} == \
        {k: v for k, v in want.items() if k != "cases"}
    assert list(got["cases"]) == list(want["cases"])
    for kind, wcase in want["cases"].items():
        gcase = got["cases"][kind]
        assert (gcase["layer"], gcase["truth"]) == (wcase["layer"],
                                                   wcase["truth"])
        assert sorted(gcase["flags"]) == sorted(wcase["flags"])
        truth = np.asarray(wcase["truth"], dtype=bool)
        for fam, wmask in wcase["flags"].items():
            g, w = (np.asarray(m, dtype=bool)
                    for m in (gcase["flags"][fam], wmask))
            if fam != "gmm":
                np.testing.assert_array_equal(g, w, err_msg=f"{fam}/{kind}")
                continue
            # the cold init differs: the conformance suite's criteria for a
            # mask, and the flagged share within 5% of rows of the
            # reference's (the port's own init seeds spread 3% on seed 1)
            assert abs(g.mean() - w.mean()) <= 0.05, f"gmm/{kind}"
            if truth.any():
                assert g[truth].mean() >= 0.9 and w[truth].mean() >= 0.9
            elif seed == want["seed"] == 0:  # the committed golden's seed
                assert g.mean() < matrix.FAR_CEILING


# ---------------------------------------------------------------------------
# runner: the deterministic parts
# ---------------------------------------------------------------------------

def test_runner_constants_and_schedule_equal_the_reference():
    assert runner._FAKE_HLO == jrunner._FAKE_HLO
    assert runner.EVAL_PROBES == jrunner.EVAL_PROBES
    for name in ("SERVE_SLO", "SERVE_LOAD", "SERVE_SLOTS", "SERVE_DT",
                 "SERVE_GRACE_STEPS"):
        assert getattr(runner, name) == getattr(jrunner, name)
    got = collective_probe.parse_hlo_collectives(runner._FAKE_HLO)
    assert got == jcollective.parse_hlo_collectives(jrunner._FAKE_HLO)
    assert len(got) == 8 and {r["op"] for r in got} == {"all-reduce"}


@pytest.mark.parametrize("name", list(matrix.CONFIG_GRID))
def test_detector_spec_equals_the_reference(name):
    mine = matrix.CONFIG_GRID[name]
    theirs = jmatrix.CONFIG_GRID[name]
    for holdoff, seed in ((144, 0), (48, 3)):
        assert dataclasses.asdict(mine.detector_spec(holdoff, seed)) == \
            dataclasses.asdict(theirs.detector_spec(holdoff, seed))
    assert mine.detector_spec(1, 0).executor == "inline"


@pytest.mark.parametrize("name", TRAIN)
def test_train_scenarios_label_like_the_reference(name):
    mine, theirs = chaos.get_scenario(name), jchaos.get_scenario(name)
    for n in (80, 120, 160, 240):
        assert int(n * mine.clean_fraction) == int(n * theirs.clean_fraction)
        a, b = mine.injector(n), theirs.injector(n)
        np.testing.assert_array_equal(a.labels(n), b.labels(n))
        assert a.windows() == b.windows()
        assert a.to_json() == b.to_json()


def _scaled_close(got, want, rtol=1e-5, atol=1e-6):
    """``got`` within rtol / atol of ``want`` once both are divided by
    max|want|: the step's outputs shrink to ~1e-12 and below, where a fixed
    atol would accept anything, zeros included."""
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(scale)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", range(3))
def test_synth_step_matches_the_reference(seed):
    """Each of the four normalised products, fed the reference's previous
    iterate: the port's within rtol 1e-5 / atol 1e-6 of the product in
    float64 at its scale, and within rtol 2e-5 of the reference's (the
    reference's float32 sum over 36,864 entries is itself off by up to
    7.8e-6 on a constant input; the port's by 4e-7). The port's step is
    exactly four products, and the whole step is held against the
    reference's jitted one at its scale, where the four products compound
    those sums' errors (up to 3.4e-5 of the scale), so atol 1e-4 there."""
    rng = np.random.default_rng(seed)
    inputs = [np.ones(runner.SYNTH_SHAPE, np.float32) * (1.0 + 0.01 * seed),
              rng.standard_normal(runner.SYNTH_SHAPE).astype(np.float32),
              rng.uniform(-1, 1, runner.SYNTH_SHAPE).astype(np.float32)]
    for x in inputs:
        xj = jnp.asarray(x)
        for _ in range(4):  # the reference's product (repro/eval/runner.py)
            nxt = (xj @ jnp.sin(xj)) / jnp.maximum(jnp.abs(xj).sum(), 1.0)
            x32 = np.array(xj)
            x64 = x32.astype(np.float64)
            exact = (x64 @ np.sin(x64)) / max(np.abs(x64).sum(), 1.0)
            mine = runner._synth_iter(torch.from_numpy(x32))
            _scaled_close(mine.numpy(), exact)
            _scaled_close(mine.numpy(), np.asarray(nxt), rtol=2e-5)
            xj = nxt
        want = np.asarray(jrunner._synth_step(jnp.asarray(x)))
        got = runner._synth_step(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape
        four = torch.from_numpy(x)
        for _ in range(4):
            four = runner._synth_iter(four)
        torch.testing.assert_close(got, four, rtol=0, atol=0)
        _scaled_close(got.numpy(), want, atol=1e-4)
        # off the card the graphed step is the eager one, exactly
        step = runner.GraphedSynthStep()
        torch.testing.assert_close(step(torch.from_numpy(x)), got,
                                   rtol=0, atol=0)
        assert step.graph is None


REQUEST = [n for n in SERVE_PLANE
           if chaos.get_scenario(n).workload == "request"]
SERVE = [n for n in SERVE_PLANE if chaos.get_scenario(n).workload == "serve"]


def _slo_sig(run):
    return (run.slo_metrics().to_json(),
            [(i.kind, i.suspect_nodes, i.n_flags, round(i.severity, 9),
              i.steps) for i in run.report.incidents],
            [d.fault_kind for d in run.report.diagnoses])


@pytest.mark.parametrize("name", REQUEST)
def test_request_scenarios_equal_the_reference(name):
    """A request cell is a pure function of its seed (the virtual clock):
    its SLO-breach incidents, their scoring and the request-plane
    diagnoses equal the reference's, in both modes."""
    for mode in ("batch", "stream"):
        mine = runner.run_scenario(chaos.get_scenario(name), mode,
                                   device=CPU)
        theirs = jrunner.run_scenario(jchaos.get_scenario(name), mode)
        assert _slo_sig(mine) == _slo_sig(theirs), mode
        if name == "serve_clean_control":
            assert mine.slo_metrics().incidents_total == 0
        else:
            assert mine.slo_metrics().recall == 1.0


@pytest.mark.parametrize("name", SERVE)
def test_serve_scenarios_run_the_decode_loop(name):
    """A serve cell runs the decode loop under the probes: finite, every
    step observed once on the STEP and runtime (executable_run) layers as
    in the reference's cell, the operator stream read off the decode step,
    and the labels the reference's."""
    run = runner.run_scenario(chaos.get_scenario(name), "batch", n_steps=80,
                              device=CPU)
    want = jchaos.get_scenario(name).injector(80)
    np.testing.assert_array_equal(run.labels, want.labels(80))
    assert run.windows == want.windows()
    layers = run.report.layers
    assert layers["step"].events == 80
    assert layers["xla"].events == 80  # the step probe's executable_run
    assert layers["operator"].events == 80 * 24  # top 24 ops a step
    assert np.all(np.diff(run.step_ts) > 0)


def test_serve_parts_decode_as_the_reference():
    """`_serve_parts`' step on the CPU: the reduced GPT-2 decode step,
    teacher-forced over the same tokens as the reference's decode_step on
    converted weights, to float32 tolerance (rtol/atol 1e-4)."""
    import jax

    from repro.config import get_arch as jget_arch
    from repro.config import reduced as jreduced
    from repro.models import model as jmodel
    from repro_torch.models.convert import params_from_jax

    cfg, params, step, make_caches = runner._serve_parts(CPU)
    assert cfg == runner._request_parts(CPU)[0]
    jcfg = jreduced(jget_arch("gpt2"))
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (
        jcfg.n_layers, jcfg.d_model, jcfg.vocab_size)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    jstep = jax.jit(lambda p, b, c, i: jmodel.decode_step(
        p, jcfg, jmodel.Runtime(mesh=None, compute_dtype=jnp.float32), b,
        c, i))
    caches, jc = make_caches(2, 8), jmodel.init_decode_caches(jcfg, 2, 8)
    tok = np.random.default_rng(0).integers(1, 200, (2, 6)).astype(np.int32)
    for t in range(6):
        got, caches = step(tp, {"tokens": tok[:, t:t + 1]}, caches, t)
        want, jc = jstep(jp, {"tokens": jnp.asarray(tok[:, t:t + 1])}, jc,
                         jnp.int32(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_request_workload_runs_on_the_virtual_clock():
    """`_run_request_steps` through a session with the request probe: the
    step clock is the virtual one, and requests finish."""
    from repro_torch.session import MonitorSpec, Session

    spec = MonitorSpec(mode="batch", probes=["request"],
                       slo=dict(runner.SERVE_SLO), governor=False)
    session = Session(spec, device=CPU)
    cfg = runner.EvalConfig()
    injector = chaos.get_scenario("serve_clean_control").injector(120)
    ts = runner._run_request_steps(session, injector, 120, 48, cfg, 0)
    np.testing.assert_array_equal(ts, np.arange(120) * runner.SERVE_DT)
    assert session.serve_stats()["requests_total"] > 5


def test_run_scenario_refuses_a_bad_mode_and_a_missing_card():
    with pytest.raises(ValueError, match="batch|stream"):
        runner.run_scenario(chaos.get_scenario("clean_control"), "off",
                            device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runner.run_scenario(chaos.get_scenario("clean_control"),
                                "batch", n_steps=20)


# ---------------------------------------------------------------------------
# runner end to end on the CPU
# ---------------------------------------------------------------------------

def test_run_scenario_end_to_end_batch():
    """tests/test_eval.py::test_run_scenario_end_to_end_batch on the port."""
    ref.CALLS.update({k: 0 for k in ref.CALLS})
    run = runner.run_scenario(chaos.get_scenario("latency_spike"), "batch",
                              runner.EvalConfig(step_sleep=0.001),
                              n_steps=120, seed=0, device=CPU)
    assert run.eval_start == 48
    assert len(run.windows) == 3
    m = run.metrics()
    assert m.faults_total == 3
    assert m.faults_detected >= 2
    assert m.recall > 0.3
    flagged = [ls for ls in run.report.layers.values()
               if ls.anomaly_rate > 0]
    assert any(ls.first_flag_ts is not None for ls in flagged)
    # the scoring ran through the kernels' plain versions on the CPU
    assert ref.CALLS["gmm_best_ref"] > 0
    mx = matrix.run_matrix(["clean_control"], modes=["batch"], n_steps=80,
                           device=CPU)
    assert len(mx["rows"]) == 1
    text = matrix.render_leaderboard(mx)
    assert "clean_control" in text and "FAR" in text


def test_cpu_cell_runs_its_step_on_one_intra_op_thread(monkeypatch):
    """On the CPU every monitored step of a cell (and the call before the
    window) runs at one intra-op thread, as the reference's CPU executable
    runs it, and the process's setting is back after the cell; another
    device's setting is left alone. The mechanism behind
    `test_run_scenario_end_to_end_batch`'s failures under a loaded host:
    at two threads each parallel region of a ~1 ms step waited for the
    slower thread, and steps tens of ms long landed in the fitted prefix."""
    seen = []
    synth = runner._synth_iter

    def counted(x):
        seen.append(torch.get_num_threads())
        return synth(x)

    monkeypatch.setattr(runner, "_synth_iter", counted)
    before = torch.get_num_threads()
    assert before > 1  # this module's setting, as the driver's workers run
    runner.run_scenario(chaos.get_scenario("clean_control"), "batch",
                        runner.EvalConfig(step_sleep=0.0), n_steps=40,
                        seed=0, device=CPU)
    # the call before the window, the operator probe's meta-tensor record
    # of the step, and the 40 monitored steps: four products each
    assert len(seen) == 4 * (1 + 1 + 40) and set(seen) == {1}
    assert torch.get_num_threads() == before
    with runner.one_cpu_thread(torch.device("meta")):
        assert torch.get_num_threads() == before


def test_run_model_cell_drives_a_train_step_as_run_scenario_does():
    """`runner.run_model_cell` under a `runner.scenario_spec` session (how
    chip_smoke.py's eval pass B and scripts/clean_control_rate.py build a
    cell) around the reduced GPT-2 train step: the reference's windows and
    labels, the schedule's COLLECTIVE rows per step as in the reference's
    run, every step observed once, finite losses, a scored row."""
    from repro_torch import quickstart

    n = 60
    scenario = chaos.get_scenario("comm_slowdown")
    spec = runner.scenario_spec(scenario, "stream", n, runner.EvalConfig())
    assert (spec.probes, spec.detector.holdoff_steps) == (
        runner.EVAL_PROBES, n - int(n * scenario.clean_fraction))
    _, _, data, state, step_fn = quickstart._workload(True, CPU, n + 1)
    session = runner.Session(spec, device=CPU)
    run, state, metrics = runner.run_model_cell(
        session, scenario, n, runner.EvalConfig(), step_fn, state, data)
    theirs = jchaos.get_scenario("comm_slowdown").injector(n)
    assert run.windows == theirs.windows()
    np.testing.assert_array_equal(run.labels, theirs.labels(n))
    assert run.mode == "stream" and len(metrics) == n
    assert all(bool(torch.isfinite(m["loss"])) for m in metrics)
    n_msgs = len(collective_probe.parse_hlo_collectives(runner._FAKE_HLO))
    emitted = run.report.overhead[0]["emitted_per_probe"]
    assert emitted["collective"] == n_msgs * (1 + n)
    assert emitted["step"] == 2 * n  # executable_run and train_step
    assert matrix._row(run)["scenario"] == "comm_slowdown"


@pytest.fixture(scope="module")
def comm_runs():
    """comm_slowdown, stream, 160 steps, seed 0, in both packages."""
    scenario = chaos.get_scenario("comm_slowdown")
    mine = runner.run_scenario(scenario, "stream", n_steps=160, seed=0,
                               device=CPU)
    theirs = jrunner.run_scenario(jchaos.get_scenario("comm_slowdown"),
                                  "stream", n_steps=160, seed=0)
    return mine, theirs


def test_comm_slowdown_collective_rows_equal_the_reference(comm_runs):
    """The schedule reaches the collective probe: 8 static rows at
    registration, then one row per all-reduce message per step, as in the
    reference — the COLLECTIVE layer is no longer empty."""
    mine, theirs = comm_runs
    n_msgs = len(collective_probe.parse_hlo_collectives(runner._FAKE_HLO))
    emitted = mine.report.overhead[0]["emitted_per_probe"]["collective"]
    assert emitted == theirs.report.overhead[0]["emitted_per_probe"][
        "collective"] == n_msgs * (1 + 160)
    got = mine.report.layers["collective"].events
    assert got == theirs.report.layers["collective"].events == n_msgs * 160
    assert (mine.eval_start, mine.windows) == (theirs.eval_start,
                                               theirs.windows)
    np.testing.assert_array_equal(mine.labels, theirs.labels)


def test_comm_slowdown_collective_flags_inside_the_fault_windows(comm_runs):
    mine, theirs = comm_runs
    for run in (mine, theirs):
        pred = run.predictions()["collective"]
        hit = [bool(pred[lo:hi].any()) for lo, hi in run.windows]
        assert all(hit), (run.windows, np.flatnonzero(pred))
        live = np.zeros_like(pred)
        live[run.eval_start:] = True
        false = pred & ~run.labels & live
        assert false.sum() <= 0.05 * (live & ~run.labels).sum()
    m = mine.metrics()
    assert m.faults_detected == 3 and m.recall > 0.3


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launcher_writes_the_matrix_and_leaderboard(tmp_path, capsys):
    out = tmp_path / "eval"
    rc = evaluate.main(["--scenarios", "clean_control", "--modes", "batch",
                        "--steps", "80", "--device", "cpu", "--out",
                        str(out)])
    printed = capsys.readouterr()
    assert rc in (0, 1)
    doc = json.loads((out / "scenario_matrix.json").read_text())
    assert [r["scenario"] for r in doc["rows"]] == ["clean_control"]
    assert doc["far_ceiling"] == matrix.FAR_CEILING
    board = (out / "leaderboard.md").read_text()
    assert "Clean-control FAR" in board and "clean_control" in printed.out
    assert rc == int(doc["rows"][0]["metrics"]["false_alarm_rate"]
                     >= matrix.FAR_CEILING
                     or bool(doc["rows"][0]["diagnosis"]["diagnoses_total"]))


def test_launcher_serve_smoke_passes_its_gates(tmp_path, capsys):
    """``--scenarios serve-smoke --device cpu``: the serve clean control
    closes no SLO-breach incident, the tenant flood raises one and is
    diagnosed as tenant_flood, and the launcher exits 0."""
    out = tmp_path / "eval-serve"
    rc = evaluate.main(["--scenarios", "serve-smoke", "--device", "cpu",
                        "--out", str(out)])
    assert rc == 0
    doc = json.loads((out / "scenario_matrix.json").read_text())
    assert [(r["scenario"], r["mode"]) for r in doc["rows"]] == [
        (n, m) for n in jchaos.SERVE_SMOKE_SCENARIOS for m in matrix.MODES]
    assert matrix.serve_clean_breaches(doc) == 0
    assert matrix.serve_breach_recall(doc) == 1.0
    for r in doc["rows"]:
        if r["scenario"] == "serve_tenant_flood":
            assert r["diagnosis"]["kinds"] and set(
                r["diagnosis"]["kinds"]) == {"tenant_flood"}
    assert "breach_inc=" in capsys.readouterr().out


def test_launcher_resolves_every_scenario():
    assert evaluate._resolve_scenarios("all") == jchaos.scenario_names()
    assert evaluate._resolve_scenarios("smoke") == list(
        jchaos.SMOKE_SCENARIOS)
    assert evaluate._resolve_scenarios("serve-smoke") == list(
        jchaos.SERVE_SMOKE_SCENARIOS)
    assert evaluate._resolve_scenarios("clean_control,serve_latency_spike") \
        == ["clean_control", "serve_latency_spike"]
    with pytest.raises(SystemExit, match="unknown scenario"):
        evaluate._resolve_scenarios("no_such_scenario")


def test_launcher_without_a_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(["--scenarios", "clean_control", "--modes", "batch",
                       "--steps", "20", "--out", str(tmp_path)])
