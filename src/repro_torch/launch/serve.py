"""Serving entry point: a continuous-batching request plane under generated
load, with optional eACGM monitoring and per-request SLO accounting (port
of `repro/launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --qps 20 \
        --num-requests 64 \
        --monitor-spec '{"mode": "batch", "slo": {"ttft_s": 0.5}}'

Runs on ``cuda`` unless ``--device cpu`` is given: the model at full
width in bf16 (GPT-2 124M by default), its slot step replayed as a CUDA
graph; ``--reduced`` is the CPU-sized model in float32. Without a card and
without ``--device cpu`` it raises.

The launcher runs the slot-based `ContinuousBatchingEngine`: requests arrive
from a deterministic multi-tenant `LoadGenerator` (``--qps``, ``--tenants``,
``--arrival-seed``), join mid-flight as slots free up, and publish their
lifecycle records to the monitor's request probe. With a ``slo`` block on
the monitor spec, breaches close as SLO incidents and are diagnosed on the
request plane. Ctrl-C flushes: the session finalises and the report stays
valid for whatever was served. It prints tok/s, req/s, the queue wait, TTFT
and TPOT (p50, p95), and the engine step's wall ms (p50, p90).

``--arch`` serves every registered decoder: dense GQA with RoPE (Llama,
SmolLM, OLMo), the sliding window's rolling cache (H2O-Danube), MoE
(Arctic) and MLA with MoE (DeepSeek-V2), SSD (Mamba2) and the SSD /
shared-attention hybrid (Zamba2). A model that takes embeddings
(Pixtral's backbone) serves through ``--static-batch`` only, fed zero
embeddings as the reference's engine feeds them; the continuous engine
refuses it. An encoder (HuBERT) has no decode step: the launcher says so
and exits 0, as the reference's does. ``--init-on-device`` draws the
weights on the card (seconds, not minutes, for a billion-parameter
model).

``--static-batch`` keeps the legacy fixed-batch `ServeEngine` path (one
``generate`` call, no request accounting) for A/B comparison.
``--metrics-port`` serves the monitor's self-telemetry (a ``prometheus``
sink; 0 binds a free port) and ``--board-out`` writes a live HTML status
board (a ``board`` sink), as the training launcher does.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import Runtime, init_params
from repro_torch.serve import (ContinuousBatchingEngine, LoadGenerator,
                               RequestQueue, ServeEngine)
from repro_torch.session import MonitorSpec, Session, SinkSpec

# historical tuning of the serve launcher (legacy-flag path only)
LEGACY_SPEC_DEFAULTS = {
    "probe_options": {"python": {"sample_every": 25},
                      "device": {"interval": 0.05}},
    "detector": {"min_events": 48},
}


def _parse_range(arg: str, name: str) -> tuple:
    parts = [int(p) for p in arg.split(",") if p]
    if len(parts) == 1:
        return (parts[0], parts[0])
    if len(parts) != 2 or parts[0] > parts[1]:
        raise SystemExit(f"--{name} wants 'N' or 'LO,HI', got {arg!r}")
    return (parts[0], parts[1])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt2")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the model serves and the GMMs run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-on-device", action="store_true",
                    help="draw the weights with a generator on --device "
                         "(other numbers than the CPU draw)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-len", type=int, default=512,
                    help="KV-cache length (one shared decode index)")
    # request-plane load (continuous engine, the default path)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent request slots (continuous engine)")
    ap.add_argument("--qps", type=float, default=20.0,
                    help="offered load, requests per second of engine time")
    ap.add_argument("--num-requests", type=int, default=64,
                    help="stop after this many requests have been generated "
                         "and served (0 = run --steps engine steps)")
    ap.add_argument("--steps", type=int, default=0,
                    help="engine-step horizon when --num-requests is 0")
    ap.add_argument("--arrival-seed", type=int, default=-1,
                    help="load-generator seed (default: --seed); arrivals "
                         "are a pure function of (seed, step)")
    ap.add_argument("--tenants", default="0.5,0.3,0.2",
                    help="comma-separated tenant arrival weights")
    ap.add_argument("--prompt-len", default="4,24",
                    help="prompt-length range 'LO,HI' (or a single int; "
                         "also the legacy --static-batch prompt length)")
    ap.add_argument("--max-new", default="4,16",
                    help="generation-budget range 'LO,HI' per request")
    # legacy fixed-batch path
    ap.add_argument("--static-batch", action="store_true",
                    help="run the legacy fixed-batch ServeEngine instead")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    MonitorSpec.add_cli_args(ap)
    ap.add_argument("--monitor", action="store_true",
                    help="[deprecated] = --monitor-spec '{\"mode\":\"batch\"}'")
    ap.add_argument("--stream-monitor", action="store_true",
                    help="[deprecated] = --monitor-spec "
                         "'{\"mode\":\"stream\"}'")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve monitor self-metrics on this port "
                         "(= a \"prometheus\" sink; 0 = ephemeral)")
    ap.add_argument("--board-out", default="",
                    help="write a live HTML status board here "
                         "(= a \"board\" sink)")
    return ap


def serve(args) -> Dict[str, Any]:
    """The monitored serving run the CLI drives. Returns the engine's
    numbers (``stats``), the session and its report (None when monitoring
    is off), and whether it was interrupted."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rt = Runtime(compute_dtype=torch.float32 if args.reduced
                 else torch.bfloat16)
    params = init_params(cfg, seed=args.seed, device=dev,
                         generator_device=dev if args.init_on_device
                         else "cpu")

    spec = MonitorSpec.from_args(args, legacy_defaults=LEGACY_SPEC_DEFAULTS)
    if spec.mode != "off":
        if not args.static_batch and "request" not in spec.probes:
            spec.probes = list(spec.probes) + ["request"]
        if args.metrics_port >= 0:
            spec.sinks.append(SinkSpec(
                kind="prometheus",
                options={"serve": True, "port": args.metrics_port}))
        if args.board_out:
            spec.sinks.append(SinkSpec(kind="board", path=args.board_out))
    session = Session(spec, device=dev)
    if not session.off and args.metrics_port >= 0:
        print(f"[monitor] metrics endpoint: "
              f"{session.sink('prometheus').url}/metrics", flush=True)
    run = _run_static if args.static_batch else _run_continuous
    out = run(args, cfg, rt, params, session)
    out.update(session=session, device=str(dev),
               report=None if session.off else session.result())
    return out


def _percentiles(x, qs) -> List[Optional[float]]:
    x = np.asarray(x, dtype=np.float64)
    return [float(np.quantile(x, q)) if x.size else None for q in qs]


def _run_continuous(args, cfg, rt, params, session) -> Dict[str, Any]:
    engine = ContinuousBatchingEngine(
        cfg, rt, params, slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, seed=args.seed)
    # warm traffic outside the monitor: the first run captures the slot
    # step, the second measures the steady per-step wall time that converts
    # --qps into a per-step arrival rate
    warm = LoadGenerator(rate=10.0, num_requests=args.slots,
                         seed=args.seed, prompt_len=(2, 2), max_new=(4, 4),
                         vocab_size=cfg.vocab_size)
    engine.run(warm, drain=True)
    timed = LoadGenerator(rate=float(args.slots),
                          num_requests=2 * args.slots, seed=args.seed + 1,
                          prompt_len=(2, 2), max_new=(16, 16),
                          vocab_size=cfg.vocab_size)
    base = engine.decode_steps
    t0 = time.perf_counter()
    engine.run(timed, drain=True)
    steps = max(engine.decode_steps - base, 1)
    step_s = max((time.perf_counter() - t0) / steps, 1e-6)
    engine.reset()

    weights = tuple(float(w) for w in args.tenants.split(",") if w)
    load = LoadGenerator(
        rate=args.qps * step_s,
        num_requests=args.num_requests or None,
        seed=args.arrival_seed if args.arrival_seed >= 0 else args.seed,
        tenants=weights,
        prompt_len=_parse_range(args.prompt_len, "prompt-len"),
        max_new=_parse_range(args.max_new, "max-new"),
        vocab_size=cfg.vocab_size)
    if args.num_requests > 0:
        n_steps = None  # run() stops once the load drains
    elif args.steps > 0:
        n_steps = args.steps
    else:
        raise SystemExit("--num-requests 0 needs a --steps horizon")
    print(f"[serve] {args.slots} slots, ~{1 / step_s:.0f} steps/s -> "
          f"rate {load.rate:.3f} req/step for --qps {args.qps:g}")

    # the engine step's wall time, timed around the engine's own method
    step_ms: List[float] = []
    engine_step = engine.step

    def timed_step(step: int = -1) -> bool:
        t = time.perf_counter()
        ran = engine_step(step)
        if ran:
            step_ms.append(1e3 * (time.perf_counter() - t))
        return ran

    engine.step = timed_step
    queue = RequestQueue()
    t0 = time.perf_counter()
    interrupted = False
    with session.monitoring():
        # Ctrl-C inside the monitoring context: the session still finalises
        # (the SLO monitor flushes pending breaches)
        try:
            engine.run(load, n_steps=n_steps, queue=queue,
                       on_step=None if session.off else session.on_step)
        except KeyboardInterrupt:
            interrupted = True
            print("\n[serve] interrupted; flushing monitor artifacts")
    wall = time.perf_counter() - t0
    engine.step = engine_step

    fin = engine.finished
    tokens = sum(r.tokens_out for r in fin)
    stats = {
        "requests": len(fin), "tokens": tokens, "wall_s": wall,
        "tok_per_s": tokens / wall if wall else 0.0,
        "req_per_s": len(fin) / wall if wall else 0.0,
        "wait_s_p50_p95": _percentiles([r.queue_wait for r in fin],
                                       (0.5, 0.95)),
        "ttft_s_p50_p95": _percentiles([r.ttft for r in fin], (0.5, 0.95)),
        "tpot_s_p50_p95": _percentiles(
            [r.tpot for r in fin if r.tokens_out > 1], (0.5, 0.95)),
        "step_ms_p50_p90": _percentiles(step_ms, (0.5, 0.9)),
        "decode_steps": engine.decode_steps,
        "nonfinite_steps": engine.nonfinite_steps,
        "mean_occupancy": engine.mean_occupancy,
        "queued": len(queue), "rejected": queue.rejected,
    }
    if fin:
        print(f"[serve] {len(fin)} requests, {tokens} tokens in "
              f"{wall:.2f}s ({stats['tok_per_s']:.1f} tok/s, "
              f"{stats['req_per_s']:.1f} req/s)")
        w, t, p = (stats["wait_s_p50_p95"], stats["ttft_s_p50_p95"],
                   stats["tpot_s_p50_p95"])
        fmt = lambda v: "-" if v is None else f"{v:.4f}"  # noqa: E731
        print(f"[serve] wait p50/p95: {fmt(w[0])}/{fmt(w[1])}s  ttft p50/p95:"
              f" {fmt(t[0])}/{fmt(t[1])}s  tpot p50/p95: {fmt(p[0])}/"
              f"{fmt(p[1])}s  step p50/p90: "
              f"{fmt(stats['step_ms_p50_p90'][0])}/"
              f"{fmt(stats['step_ms_p50_p90'][1])} ms")
        by_tenant: dict = {}
        for r in fin:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
        print(f"[serve] per tenant: "
              f"{ {t: n for t, n in sorted(by_tenant.items())} } "
              f"(queue: {len(queue)} waiting, {queue.rejected} rejected)")
    else:
        print("[serve] no requests finished")
    if not session.off:
        serve_stats = session.serve_stats()
        if serve_stats:
            print("[monitor] serve:", {k: round(v, 4)
                                       for k, v in sorted(serve_stats.items())})
    return {"stats": stats, "interrupted": interrupted, "engine": engine}


def _run_static(args, cfg, rt, params, session) -> Dict[str, Any]:
    engine = ServeEngine(cfg=cfg, rt=rt, params=params,
                         batch_size=args.batch, max_len=args.max_len,
                         temperature=args.temperature, seed=args.seed)
    plen = _parse_range(args.prompt_len, "prompt-len")[0]
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, plen)).astype(np.int32)
    out, dt, interrupted = None, 0.0, False
    with session.monitoring():
        try:
            engine._step = session.observe_step_fn(engine._step)
            if session.spec.mode == "stream":
                # calibration traffic: a short clean generate fits the
                # per-layer baselines (decode steps are homogeneous)
                engine.generate(prompts, 24)
                fitted = session.warmup()
                print(f"[monitor] warmed layers: "
                      f"{[l.value for l in fitted]}")
            t0 = time.perf_counter()
            out = engine.generate(prompts, args.tokens)
            dt = time.perf_counter() - t0
        except KeyboardInterrupt:
            interrupted = True
            print("\n[monitor] interrupted; flushing monitor artifacts")
    stats: Dict[str, Any] = {}
    if out is not None:
        total_tokens = args.batch * (args.tokens + plen - 1)
        stats = {"tokens": total_tokens, "wall_s": dt,
                 "tok_per_s": total_tokens / dt if dt else 0.0}
        print(f"generated {out.shape} in {dt:.2f}s "
              f"({stats['tok_per_s']:.1f} tok/s decode)")
        print("sample:", out[0, : plen + 8].tolist())
    return {"stats": stats, "interrupted": interrupted, "engine": engine}


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        cfg = get_arch(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if not cfg.has_decode:
        print(f"{cfg.name} is encoder-only: no decode step")
        return 0
    if cfg.input_mode != "tokens" and not args.static_batch:
        ap.error(f"{cfg.name} takes embeddings: continuous batching "
                 "requires token inputs (serve it with --static-batch)")
    out = serve(args)
    if out["report"] is not None:
        print(out["report"].render())
    return 130 if out["interrupted"] else 0


if __name__ == "__main__":
    sys.exit(main())
