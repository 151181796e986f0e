"""The port's serve plane against the reference's, case for case with
`tests/test_serve_plane.py`: the load generator's purity and faults, FCFS
admission, engine determinism, the join/evict oracle, TTFT/TPOT on the
virtual clock, the client stall, the SLO monitor, and SLO-breach paging
through the Session API. Each case runs both packages on the same seed at
reduced width (GPT-2, float32, the reference's weights converted)."""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.config import reduced as jreduced  # noqa: E402
from repro.models.model import Runtime as JRuntime  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.session import MonitorSpec as JMonitorSpec  # noqa: E402
from repro.session import Session as JSession  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.config import get_arch, reduced  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Runtime  # noqa: E402
from repro_torch.session import MonitorSpec, Session  # noqa: E402

# the eval scenarios' operating point (repro_torch.eval.runner.SERVE_SLO)
SLO = {"ttft_s": 0.4, "tpot_s": 0.08, "queue_wait_s": 0.2, "queue_depth": 8,
       "min_breaches": 6, "gap_s": 0.5, "close_after_s": 0.5}
DT = 0.02
CPU = "cpu"


@functools.lru_cache(maxsize=1)
def _parts():
    """(reference cfg, rt, params), (port cfg, rt, params): one set of
    weights, the reference's, in both."""
    jcfg = jreduced(jget_arch("gpt2"))
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tcfg = reduced(get_arch("gpt2"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    return ((jcfg, JRuntime(mesh=None, compute_dtype=jnp.float32), jp),
            (tcfg, Runtime(torch.float32), tp))


def _engine(pkg, parts, dtype, **kw):
    """The continuous engine; ``dtype`` None keeps its default (bf16
    caches, as the fixed-batch engine's)."""
    cfg, rt, params = parts
    if dtype is not None:
        kw["dtype"] = dtype
    return pkg.ContinuousBatchingEngine(cfg, rt, params, **kw)


def _drain(eng, queue):
    s = 0
    while len(queue) or eng.n_active:
        eng.tick(s, None, queue, None)
        s += 1
    return s


def _sig(reqs):
    return [(r.req_id, r.tenant, r.max_new_tokens, r.client_stall_s,
             r.enqueue_ts, tuple(int(t) for t in r.prompt)) for r in reqs]


# ---------------------------------------------------------------------------
# load generator + scheduler determinism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_load_generator_is_pure_in_seed_and_step(seed):
    """Every draw equals the reference's, and a second generator of the
    same seed repeats it."""
    gens = [tserve.LoadGenerator(rate=0.5, seed=seed, vocab_size=64),
            tserve.LoadGenerator(rate=0.5, seed=seed, vocab_size=64),
            jserve.LoadGenerator(rate=0.5, seed=seed, vocab_size=64)]
    for s in range(60):
        a, b, want = (_sig(g.arrivals(s, 0.1 * s)) for g in gens)
        assert a == b == want
    other = tserve.LoadGenerator(rate=0.5, seed=seed + 1, vocab_size=64)
    sig = lambda g: [len(g.arrivals(s, 0.0)) for s in range(60)]  # noqa: E731
    assert sig(other) != sig(tserve.LoadGenerator(rate=0.5, seed=seed,
                                                  vocab_size=64))


@pytest.mark.parametrize("faults", [None, {"tenant_flood": 8.0},
                                    {"heavy_prompt_skew": 4.0},
                                    {"slow_client_stall": 0.08}])
def test_load_generator_fault_perturbations(faults):
    def mix(pkg, f):
        g = pkg.LoadGenerator(rate=0.4, seed=7, vocab_size=64)
        return [r for s in range(300) for r in g.arrivals(s, 0.0, f)]

    got = mix(tserve, faults)
    assert _sig(got) == _sig(mix(jserve, faults))
    base = mix(tserve, None)
    if faults and "tenant_flood" in faults:
        t0 = lambda rs: sum(r.tenant == 0 for r in rs)  # noqa: E731
        assert t0(got) > 3 * t0(base)
    if faults and "heavy_prompt_skew" in faults:
        assert (np.mean([r.prompt_len for r in got])
                > 2 * np.mean([r.prompt_len for r in base]))
    if faults and "slow_client_stall" in faults:
        assert all(r.client_stall_s == pytest.approx(0.08) for r in got)


def test_admission_scheduler_fcfs_capacity_guard():
    def run(pkg):
        sched = pkg.AdmissionScheduler(max_len=20)
        q = pkg.RequestQueue()
        big = pkg.Request(req_id=0, tenant=0, prompt=np.ones(10, np.int32),
                          max_new_tokens=10, enqueue_ts=0.0)
        small = pkg.Request(req_id=1, tenant=0, prompt=np.ones(2, np.int32),
                            max_new_tokens=2, enqueue_ts=0.0)
        q.push(big)
        q.push(small)
        out = [[r.req_id for r in sched.select(q, 5, free_slots=2)], len(q),
               [r.req_id for r in sched.select(q, 0, free_slots=2)],
               sched.epoch_reset(big, 5, n_active=1),
               sched.epoch_reset(None, 5, n_active=0),
               sched.epoch_reset(big, 5, n_active=0)]
        return out

    got = run(tserve)
    assert got == run(jserve)
    assert got == [[], 2, [0, 1], False, False, True]


def _run_load(pkg, parts, dtype, seed, faults=None, n_steps=120):
    cfg = parts[0]
    eng = _engine(pkg, parts, dtype, slots=4, max_len=n_steps + 96,
                  seed=seed, clock=pkg.VirtualClock(DT))
    load = pkg.LoadGenerator(rate=0.18, seed=seed, prompt_len=(4, 12),
                             max_new=(4, 8), vocab_size=cfg.vocab_size)
    eng.run(load, n_steps=n_steps, faults_for_step=faults, drain=False)
    return eng


def _finished(eng):
    return [(r.req_id, r.tenant, r.tokens_out, r.queue_wait, r.ttft, r.tpot,
             tuple(int(t) for t in r.tokens)) for r in eng.finished]


def test_engine_run_is_deterministic_under_fixed_seed():
    jparts, tparts = _parts()
    a = _run_load(tserve, tparts, torch.float32, 5)
    b = _run_load(tserve, tparts, torch.float32, 5)
    want = _run_load(jserve, jparts, jnp.float32, 5)
    assert len(a.finished) > 10
    assert _finished(a) == _finished(b) == _finished(want)


# ---------------------------------------------------------------------------
# mid-flight join correctness vs the static oracle
# ---------------------------------------------------------------------------

def _join_requests(pkg, vocab):
    rng = np.random.default_rng(11)
    return [pkg.Request(req_id=i, tenant=0,
                        prompt=rng.integers(1, vocab, size=int(
                            rng.integers(3, 7))).astype(np.int32),
                        max_new_tokens=int(rng.integers(4, 7)),
                        enqueue_ts=0.0)
            for i in range(6)]


def join_oracle(pkg, parts, dtype=None, slots=2, max_len=256):
    """The reference test's construction: six requests through a 2-slot
    engine (mid-flight joins into recycled lanes), then each alone through
    the fixed-batch engine from a fresh cache. Returns the engine's
    finished requests and the oracle's tokens per request id."""
    cfg, rt, params = parts
    eng = _engine(pkg, parts, dtype, slots=slots, max_len=max_len, seed=0,
                  clock=pkg.VirtualClock(DT))
    queue = pkg.RequestQueue()
    for r in _join_requests(pkg, cfg.vocab_size):
        queue.push(r)
    _drain(eng, queue)
    oracle = pkg.ServeEngine(cfg=cfg, rt=rt, params=params, batch_size=1,
                             max_len=64, seed=0)
    want = {}
    for r in sorted(eng.finished, key=lambda r: r.req_id):
        out = oracle.generate(r.prompt[None, :], r.max_new_tokens)
        want[r.req_id] = np.asarray(out[0, r.prompt_len:])
    return eng.finished, want


def test_join_evict_matches_static_batch_oracle():
    """Requests joining slots mid-flight must generate token-for-token what
    each generates alone through the fixed-batch engine — and what the
    reference's engine generates."""
    jparts, tparts = _parts()
    fin, want = join_oracle(tserve, tparts)
    assert len(fin) == 6
    assert any(r.start_index > 0 for r in fin)  # real joins
    for r in fin:
        np.testing.assert_array_equal(
            np.asarray(r.tokens), want[r.req_id],
            err_msg=f"req {r.req_id} joined at index {r.start_index}")
    jfin, _ = join_oracle(jserve, jparts)
    assert ([(r.req_id, r.start_index, list(r.tokens)) for r in fin]
            == [(r.req_id, r.start_index, [int(t) for t in r.tokens])
                for r in jfin])


# ---------------------------------------------------------------------------
# per-request accounting on the virtual clock
# ---------------------------------------------------------------------------

def _single(pkg, parts, dtype, dt, plen, n_new, stall=0.0, tenant=0):
    eng = _engine(pkg, parts, dtype, slots=1, max_len=64, seed=0,
                  clock=pkg.VirtualClock(dt))
    req = pkg.Request(req_id=0, tenant=tenant,
                      prompt=np.arange(1, plen + 1, dtype=np.int32),
                      max_new_tokens=n_new, enqueue_ts=0.0,
                      client_stall_s=stall)
    q = pkg.RequestQueue()
    q.push(req)
    steps = _drain(eng, q)
    (fin,) = eng.finished
    return steps, fin


def test_ttft_tpot_accounting_on_virtual_clock():
    jparts, tparts = _parts()
    dt, plen, n_new = 0.05, 5, 4
    _, fin = _single(tserve, tparts, torch.float32, dt, plen, n_new, tenant=1)
    _, want = _single(jserve, jparts, jnp.float32, dt, plen, n_new, tenant=1)
    assert fin.queue_wait == 0.0
    assert fin.ttft == pytest.approx((plen - 1) * dt)
    assert fin.tpot == pytest.approx(dt)
    assert fin.e2e == pytest.approx((plen + n_new - 2) * dt)
    assert fin.tokens_out == n_new
    assert fin.record(0) == want.record(0)


def test_client_stall_inflates_delivery_not_compute():
    jparts, tparts = _parts()
    dt, plen, n_new, stall = 0.05, 3, 5, 0.1
    steps, fin = _single(tserve, tparts, torch.float32, dt, plen, n_new, stall)
    jsteps, want = _single(jserve, jparts, jnp.float32, dt, plen, n_new, stall)
    assert fin.ttft == pytest.approx((plen - 1) * dt + stall)
    assert fin.tpot == pytest.approx(dt + stall)
    assert fin.stall_s == pytest.approx(n_new * stall)
    assert steps == jsteps == plen + n_new - 1
    assert fin.record(0) == want.record(0)


# ---------------------------------------------------------------------------
# SLO monitor (unit)
# ---------------------------------------------------------------------------

def _rows(name, dur, n=10, tenant=0, size=8.0):
    return {"name": np.array([name] * n),
            "ts": np.linspace(0.0, 0.9, n),
            "dur": np.full(n, float(dur)),
            "size": np.full(n, float(size)),
            "step": np.arange(n, dtype=np.int64),
            "tenant": np.full(n, tenant, dtype=np.int64),
            "req_id": np.arange(n, dtype=np.int64)}


def _incident_sig(incs):
    return [(i.kind, i.suspect_layer.value, i.suspect_nodes, i.n_flags,
             round(i.severity, 9), i.steps) for i in incs]


def test_slo_monitor_closes_breach_incident():
    got = []
    for pkg in (tserve, jserve):
        mon = pkg.SLOMonitor(pkg.SLOSpec(ttft_s=0.1, min_breaches=3,
                                         gap_s=0.5, close_after_s=0.2))
        assert mon.observe(_rows("serve/ttft", dur=0.5)) == 10
        incs = mon.tick(now=10.0)
        assert len(incs) == 1 and incs[0].kind == "slo_breach"
        assert mon.breaches_total == 10
        assert 0 in incs[0].suspect_nodes  # tenant id rides as the node
        got.append(_incident_sig(incs))
    assert got[0] == got[1]


def test_slo_monitor_silent_on_met_targets():
    for pkg in (tserve, jserve):
        mon = pkg.SLOMonitor(pkg.SLOSpec())
        assert mon.observe(_rows("serve/ttft", dur=0.01)) == 0
        assert mon.observe(_rows("serve/queue_depth", dur=0.0,
                                 size=3.0)) == 0
        assert mon.tick(now=10.0) == []
        assert mon.flush() == []


def test_slo_spec_rejects_unknown_fields():
    for pkg in (tserve, jserve):
        with pytest.raises(ValueError, match="unknown SLOSpec field"):
            pkg.SLOSpec.from_dict({"ttft_ms": 400})
    with pytest.raises(ValueError, match="unknown SLOSpec field"):
        MonitorSpec(mode="batch", slo={"ttft_ms": 400})


# ---------------------------------------------------------------------------
# end to end through the Session API
# ---------------------------------------------------------------------------

def _serve_report(port: bool, faults, n_steps=200, seed=0):
    jparts, tparts = _parts()
    if port:
        spec = MonitorSpec(mode="batch", probes=["request"], slo=dict(SLO),
                           governor=False, seed=seed)
        session, pkg = Session(spec, device=CPU), tserve
        parts, dtype = tparts, torch.float32
    else:
        spec = JMonitorSpec(mode="batch", probes=["request"], slo=dict(SLO),
                            governor=False, seed=seed)
        session, pkg = JSession(spec), jserve
        parts, dtype = jparts, jnp.float32
    eng = _engine(pkg, parts, dtype, slots=4, max_len=n_steps + 96,
                  seed=seed, clock=pkg.VirtualClock(DT))
    load = pkg.LoadGenerator(rate=0.18, seed=seed, prompt_len=(4, 12),
                             max_new=(4, 8), vocab_size=parts[0].vocab_size)
    with session.monitoring():
        eng.run(load, n_steps=n_steps, faults_for_step=faults,
                on_step=session.on_step, drain=False)
    return session.result()


def _slo_incidents(report):
    return [i for i in report.incidents
            if getattr(i, "kind", "anomaly") == "slo_breach"]


def test_tenant_flood_pages_with_request_plane_diagnosis():
    flood = lambda s: {"tenant_flood": 8.0} if 60 <= s < 120 else {}  # noqa: E731
    report = _serve_report(True, flood)
    want = _serve_report(False, flood)
    slo = _slo_incidents(report)
    assert slo, "sustained flood must close an slo_breach incident"
    assert all(i.suspect_layer.value == "request" for i in slo)
    kinds = [d.fault_kind for d in report.diagnoses]
    assert "tenant_flood" in kinds
    assert _incident_sig(slo) == _incident_sig(_slo_incidents(want))
    assert kinds == [d.fault_kind for d in want.diagnoses]


def test_clean_serve_control_pages_zero():
    for port in (True, False):
        report = _serve_report(port, lambda s: {})
        assert _slo_incidents(report) == []
        assert report.diagnoses == []


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_on_the_cpu(capsys):
    """`repro_torch.launch.serve` on the CPU (reduced GPT-2): every request
    served, the request plane's numbers printed, the SLO plane judged."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args(
        ["--reduced", "--device", "cpu", "--qps", "40", "--num-requests",
         "24", "--monitor-spec",
         '{"mode": "batch", "slo": {"ttft_s": 0.4, "queue_wait_s": 0.2}}'])
    out = serve.serve(args)
    st = out["stats"]
    assert st["requests"] == 24 and st["nonfinite_steps"] == 0
    assert st["tokens"] > 24 and st["tok_per_s"] > 0
    assert all(v is not None for v in st["ttft_s_p50_p95"]
               + st["step_ms_p50_p90"])
    assert out["session"].serve_stats()["requests_total"] == 24
    printed = capsys.readouterr().out
    assert "tok/s" in printed and "ttft p50/p95" in printed
    assert serve.main(["--reduced", "--device", "cpu", "--num-requests",
                       "4", "--static-batch", "--batch", "2", "--tokens",
                       "6"]) == 0


def test_serve_launcher_needs_a_card_or_the_cpu():
    from repro_torch.launch import serve

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--reduced", "--num-requests", "2"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--reduced", "--num-requests", "2",
                        "--metrics-port", "0"])
    # the operator-surface flags are ported: tests/test_torch_obs.py
