#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. ``build``: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together) and
   report the seconds and each kernel instantiation's registers, stack
   and spill bytes from ptxas; every specialised instantiation must be
   there, with no stack frame and no spill.
2. ``kernel_check``: every kernel against its plain PyTorch version on the
   card. ``gmm_score`` / ``gmm_best``: the kernel tests' shape grid (up to
   D=32, K=16), N=0, the main path's D=4/K=4 shapes (N = 4096 and 2^20),
   bf16 X, exact ties and NaN components; float32 rtol 1e-5 / atol 1e-4 (the
   kernel tests' own), bf16 X rtol 5e-2 / atol 5e-1, argmax may differ only
   at near-ties (top two within 1e-3), ties and NaN must match exactly.
   ``gmm_stats`` / ``gmm_update``: the kernel tests' grids (``SHAPES[:5]``,
   ``UPDATE_SHAPES`` with K=1, ``BUCKETS`` x nvalid fractions {1, 0.61,
   0.25} with the padding rows poisoned to 1e6), nvalid=0 (also with an
   all-NaN U and with NaN rows: NaN exactly where the plain version has it),
   N=0, bf16 X, D=32/K=16 and N=2^20 at D=4/K=3; rtol 1e-4 / atol 1e-4 x
   max(|want|, 1)
   (tests/test_kernels.py's `_assert_tuple_close`), and every case called
   twice: the two outputs must be bitwise equal. Then, for all four
   kernels on both sides of the specialised / general boundary: U in the
   EM loop's layout (a transposed view) must give bitwise the outputs of a
   contiguous U, and a NaN component of U NaN exactly where the plain
   version gives it; shapes at the boundary must launch the variant the
   wrappers' list names; and the EM kernels captured in one CUDA graph
   must equal the eager call bit for bit over 4 replays, the last on new
   rows.
3. ``graph_check``: the train step's CUDA-graphed forward and backward
   against the eager one at full width, on new batches and perturbed weights
   (loss within 1e-3 relative, gradients within 1e-2 of their norm).
4. ``main_path``: `repro_torch.quickstart.run` on ``cuda`` — full-width GPT-2
   124M in bf16, batch 8, sequence 128, 120 steps, op_latency faults (seed 7,
   0.03 s), the reference quickstart's probes (runtime, operator,
   collective, device, step), per-layer GMM fit and detection on the card.
   The launch counts are set to 0 just before and read just after: both
   scoring kernels must have launched and no plain version may have run.
   The loss must be finite, the STEP layer's hit rate > 0.5 and > 2x its
   false rate, the governor must act, the operator layer and the runtime
   probe must have rows, and the device probe must have lost no sample.
   Then ``table1_path`` (`table1_phase`): paper Table I's six baselines
   (`repro_torch.core.baselines`, NumPy/SciPy) and the GMM on the card
   over the run's STEP-layer features, scored against its op_latency
   windows; every detector must fit, every score be finite and the phase
   take at most 20 s; F1 is printed, not gated.
5. ``stream_path``: `repro_torch.quickstart.run_stream` on ``cuda`` — the
   same model trains 240 steps with a StreamMonitor attached (the
   latency_spike scenario: 3 op_latency bursts of 14 steps after a 96-step
   clean prefix), warmup at step 96, a detection tick every 20 steps, then
   finish(). Counts reset just before, read just after: all four kernels
   must have launched and no plain version may have run; the loss must be
   finite, the incidents must match at least 2 of the 3 fault windows
   (recall >= 2/3) with precision >= 0.5, the top-severity incident's
   deficit must lie mostly on a layer op_latency perturbs (``operator`` or
   ``step``), the wire must have lost no batch and the device probe no
   sample. The engine's own suspect layer is printed beside it, and listed
   under ``unmet`` unless it is ``operator``, where the fault is injected.
6. ``session_path``: the training entry point, `repro_torch.launch.train`,
   in-process at full width with ``--inject-faults`` and its session
   (`session_phase`): 100 steps unmonitored, 200 in batch mode and 240 in
   stream mode with the full probe suite. Per mode: steps/s of the loop,
   steps/s after the graphed step's set-up calls, rows per layer and
   probe, the STEP and OPERATOR layers' hit and false
   rates (batch) or the incidents against the fault windows (stream),
   incidents with their suspect and heaviest layer, diagnoses, governor
   actions, kernel launches and plain calls, the runtime probe's rows; the
   monitoring overhead against the unmonitored rate, both after the set-up
   calls; runtime-probe rows
   written inside a detection zone or on the detection worker (must be
   0). The batch mode's STEP layer must pass the main path's rate gate;
   its governor action is reported under ``unmet`` when there is none.
7. ``fleet_path``: `repro_torch.quickstart.run_fleet` on ``cuda`` — the
   hierarchical fleet plane (node -> group -> fleet) from the reference
   fleet demo's spec: 8 nodes in 2 groups of 4, each training its own
   full-width GPT-2 (model, AdamW and CUDA graph of its own), 80 warm-up
   steps, then 160 live steps with a tick every 16 and an op_latency fault
   of 0.02 s on node 1 over live steps 60-100. Every group fits and scores
   its own GMMs on the card. Counts reset just before, read just after.
   Printed: steps/s, per-group ingest and detect seconds, ms a tick, the
   incidents with their suspect layer and nodes, launches, runtime rows per
   node, failed device samples, peak memory. Gates: finite losses on every
   node; 2 groups of 4, all warmed; gmm_score, gmm_best and gmm_update
   launched, only specialised variants, no plain call; no lost batch; no
   runtime row in a detection zone or on the worker; an incident holding
   node 1 over the fault's steps. Under ``unmet`` when not so: the top
   incident's suspect layer is operator, no incident names only clean
   nodes, no failed device sample. Then a shedding pass (4 nodes, one
   group, 96 steps, no fault, the governor's budget below one node's events
   a flush): the governor must shed, and the shed count on the wire must
   equal the agents' own.
8. ``families_path``: `repro_torch.launch.train` in-process at full width
   in stream mode with ``--inject-faults``, once per NumPy detector family
   (isoforest, mad, spectral), 160 steps each: steps/s, the overhead
   against ``session_path``'s unmonitored rate, incidents against the
   fault windows. Gates: finite loss, a detection for every warmed layer,
   no lost batch, no GMM kernel launch and no plain GMM call. Then
   ``mesh_path`` (`mesh_phase`, in a child, ``--mesh-path OUT``):
   `repro_torch.launch.train` at full width over a 1 x 1 mesh
   (``--data-mesh 1 --model-mesh 1``, a process group of one on NCCL: one
   card holds one rank) in batch mode with ``--inject-faults``, 120 steps,
   after the same run without a mesh, unmonitored. Gates: the first 20
   losses equal the no-mesh run's (bit for bit; within 1e-6 relative under
   ``unmet``; more fails); the STEP layer's hit rate > 0.5 and > 2x its
   false rate; the COLLECTIVE schedule read off the step (none at one
   rank: no row), never a made-up one; gmm_score and gmm_best launched,
   specialised, no plain call; no runtime row in a detection zone. Its
   steady steps/s is printed beside ``session_path``'s batch rate.
9. ``eval_path``: the scenario-matrix evaluation harness on the card, in
   two passes, each in a child process of its own (``chip_smoke.py
   --eval-pass-a OUT``, ``--eval-pass-b OUT``), whose CUDA context has run
   nothing on a second stream (see `isolated`), each cell's launches
   counted from 0 there. Pass A is the reference CI gate,
   `repro_torch.launch.evaluate` with ``--scenarios smoke --modes
   batch,stream --device cuda`` (3 scenarios x 2 modes, 240 steps, the
   synthetic step CUDA-graphed); its exit code must be 0. Pass B builds
   each cell with `runner.scenario_spec` and `runner.run_model_cell`
   around the full-width GPT-2 step, built once and shared: clean_control,
   runtime_stall, comm_slowdown, degraded_device and memory_leak, batch and
   stream, 240 steps each. One ``eval_cell`` line a cell (F1, FAR, faults
   found, detection ms a window, wall seconds, the monitored step's p50 and
   p90 ms, the expected layers' anomaly rates, diagnoses, COLLECTIVE and
   runtime rows, launches), one ``eval_path`` line a pass. Gates, every
   cell: finite losses; batch cells launched gmm_score and gmm_best, stream
   cells gmm_update, only specialised variants, no plain call; the
   collective probe emitted one row per `_FAKE_HLO` message per step (and
   its registration's), as the CPU parity test fixes; no runtime-probe row
   inside a detection zone; no failed device sample. Pass B's clean control,
   both modes: FAR under `FAR_CEILING` and no diagnosis (the reference's
   own gate, `repro/launch/evaluate.py:140-152`). Listed under ``unmet``,
   not enforced: pass B's mean blamed-kind accuracy under the reference's
   0.5. Then ``nvml_path`` (`nvml_phase`, in a child, ``--nvml-path
   OUT``): pass B's clean_control, degraded_device and memory_leak cells
   in batch mode with the device probe reading the card through NVML in
   its sampler process; gates: every DEVICE row from NVML, no failed
   sample, NVML's power limit nvidia-smi's, readings a card can give, and
   the faulted cells' injected memory visible in their fault windows'
   rows; scores, the clean cell's FAR and diagnoses printed, not gated.
10. ``ckpt_path``: checkpointing through `repro_torch.launch.train` at full
   width (GPT-2 124M, bf16, batch 8, sequence 128, the step graphed), the
   stream session with ``--inject-faults``, in a process of its own
   (``chip_smoke.py --ckpt-path OUT``) that starts each run in one more
   (``--ckpt-run OUT DIR``): 120 steps with ``--checkpoint-dir`` and a
   checkpoint every 40; the same run stopped by SIGINT, sent from outside
   once its log shows step 70 (the launcher ends the step in flight,
   raises KeyboardInterrupt and saves); and a run resumed from that
   directory. Gates: the resumed run starts at the stopped run's last save
   and the two runs' losses equal the uninterrupted run's bit for bit (a
   relative difference of at most 1e-6 is reported under ``unmet``; more
   fails); no ``.tmp`` staging directory is left; every checkpoint_now the
   governor asks for is followed by a save at that step, among them the
   one of a python_latency diagnosis planted in the uninterrupted run at
   step 50's cadence point (a clean run rarely asks for one); finite losses;
   specialised kernels only, no plain call. Printed: each save's host
   stall and the next step's excess over the median step, the background
   writes' seconds, the checkpoint's bytes, the launches (GMM kernels run
   only where the session sweeps).
11. ``obs_path``: the operator surface, in a process of its own
   (``--obs-path OUT``): `repro_torch.launch.train` at full width in
   stream mode (240 steps, ``--inject-faults``) with ``--metrics-port 0
   --board-out``, a thread scraping ``/metrics`` and ``/healthz`` every
   0.5 s while it runs. Gates: at least three scrapes, each accepted by
   `repro_torch.obs.parser`, none failing before the endpoint stops; the
   compile-cache families (`SHAPE_CACHE`) counted; ``/healthz`` answered;
   the board written, its final render without a refresh; gmm_update
   launched, specialised only, no plain call. Its steps/s is printed
   beside ``session_path``'s stream rate.
12. ``serve_path``: the serve plane at full width (GPT-2 124M, bf16), in a
   child process of its own (``chip_smoke.py --serve-path OUT``, for pass
   A's reason), in four parts. (a) One request stream through two 4-slot
   continuous engines, the slot step a CUDA graph in one and eager in the
   other, with mid-flight joins and an epoch reset (a 40-position budget):
   every step's logits bitwise equal over >= 48 steps. 32 positions of the
   graphed slot step's decode, one lane joined at position 8 over its
   previous occupant's rows, against the full forward: in float32 within
   1e-4 (tests/test_torch_model.py's tolerance), which a decode with its
   index one step behind and one with the ``start`` mask dropped must each
   fail; in bf16 no further from the float32 forward than twice the bf16
   forward is (``e_dec <= 2 e_fwd``), with the float32 forward's greedy
   token wherever its top-2 margin exceeds ``2 e_fwd``. Joined requests'
   tokens equal to the static-batch oracle's.
   (b) `repro_torch.launch.serve` called in the child, 64 requests in off,
   batch and stream mode with ``slo`` ttft 0.4 s and queue wait 0.2 s: tok/s,
   req/s, wait/TTFT/TPOT p50 and p95, the engine step's p50/p90 ms; gates:
   every request served, no non-finite step, the slot step graphed, batch
   launched gmm_score and gmm_best and stream gmm_update, specialised only,
   no plain call, no runtime row in a detection zone. (c)
   ``--scenarios serve-smoke`` on the card must exit 0 with no SLO-breach
   incident on the serve clean control and tenant_flood diagnosed, its
   cells equal to the same run on the CPU (the request plane's virtual
   clock). (d) serve_latency_spike, serve_runtime_stall
   and serve_degraded_device, both modes, 240 decode steps: each cell's
   kernels as pass B's; mean blamed-kind accuracy under 0.5 is listed
   under ``unmet``.
13. ``arch_path``: the reference's other model families and training
   modes, a process per uncut model (`isolated`). (a) `arch_reduced`
   (alone: ``--arch-reduced``; in the smoke after (b), in its process): every
   registered architecture at its reduced size in bf16, its graphed
   forward and backward against eager with one microbatch and two, and its
   whole train step (forward, backward and the update in one CUDA graph)
   against the eager step with AdamW, with Adafactor and with AdamW over
   two microbatches: losses within 1e-3 relative, gradients within 1e-2 of
   their norm, parameters within 1e-2 of their move. (b) ``--arch-llama``:
   Llama 3.2 1B at full width (1.24B parameters, bf16, batch 8, sequence
   128) through `repro_torch.launch.train`, unmonitored (30 steps) and in
   batch mode with ``--inject-faults`` (200 steps), with
   ``session_path``'s batch gates: finite loss, the STEP layer's hit rate
   > 0.5 and > 2x its false rate, gmm_score and gmm_best launched
   specialised with no plain call, operator and runtime rows, no runtime
   row in a detection zone; steps/s, ms a step, set-up seconds, peak
   memory and the unmonitored rate printed; then, in the same process,
   its whole train step graphed with ``Runtime.remat`` ``none``, ``full``
   and ``dots``, 10 steps each from the same weights (AdamW): the losses,
   ms a step and peak memory (over the steps, and over one eager forward
   and backward); ``full`` and ``dots`` must give ``none``'s losses
   (within 1e-6 relative) and ``full`` a lower forward and backward
   peak. (c)
   ``--arch-mamba``: Mamba2
   2.7B at full width in stream mode (75 steps, the weights drawn on the
   card): finite loss, all four kernels launched specialised with no plain
   call, no lost batch. (d) ``--arch-moe``: DeepSeek-V2 at its published
   widths cut to 2 layers (the dense first layer and one MoE layer of 160
   experts, top-6, 2 shared; 5.35B parameters; ``reduced`` in the line),
   Adafactor, two microbatches, unmonitored, learning rate 1e-4: 3 eager
   steps, then 10 graphed steps from the same weights on the same batch;
   the first 3 within graph_check's bars of the eager ones, the loss
   falling; ms a step and the tokens dropped at capacity printed.
14. ``serve_arch_path``: decode and serving of the other families, a
   process per uncut model (`isolated`). (a) `serve_arch_reduced` (alone:
   ``--serve-arch-reduced``; in the smoke after (d), in its process): every
   registered decoder but GPT-2 at its reduced size: the graphed slot
   step bitwise equal to the eager one over >= 48 steps with joins and an
   epoch reset, in bf16 (Pixtral's backbone, which takes embeddings:
   through the fixed-batch engine, and its slot step on real embeddings
   with a join and an epoch reset); float32 decode against the float32
   forward within 1e-4 (H2O-Danube over 48 positions, past its 32-slot
   ring; MoE at a capacity factor of E / k, where no pair drops), which one
   planted fault per mechanism must fail (`family_plants`: RoPE's query at
   ``index + 1``, a ring of ``slots - 1``, no join-time SSM reset, MLA's
   score without its k_rope term, MoE without Arctic's dense residual);
   the join oracle: SSM and hybrid lanes bit for bit against a fresh lane
   (and not so without the reset), RoPE lanes against a static batch at
   the same absolute positions. (b) ``--serve-arch-llama``: Llama 3.2 1B
   uncut: graphed = eager; float32 decode within 1e-4; bf16 decode
   ``e_dec <= 2 e_fwd`` against the float32 forward, with the greedy token
   where the margin allows; the slot step's graph device ms;
   `repro_torch.launch.serve` in-process, 4 slots, 64 requests in
   ``off`` and ``stream`` with SERVE_SLO: tok/s, req/s, TTFT and TPOT
   p50/p95, the engine step's p50/p90 ms beside the time to read the
   weights once; gates: every request served, no non-finite step, the step
   graphed, gmm_update launched in stream mode with specialised variants
   only and no plain call, no lost batch, no runtime row in a detection
   zone; the SLO verdict printed, not gated (SERVE_SLO was set for
   GPT-2's step). (c) ``--serve-arch-mamba``: Mamba2 2.7B uncut, the same
   with the float32 error reported, not gated, and 32 requests in
   ``stream`` mode. (d) ``--serve-arch-moe``: DeepSeek-V2 at its published
   widths cut to 2 layers: graphed = eager; float32 decode within 1e-4 and
   the bf16 rule at a capacity factor of E / k (positions whose routing a
   bf16 run flipped left out and counted), no pair dropped there; the
   pairs dropped at the default capacity printed.
15. ``kernel_scaling``: kernel and plain times at N = 4096 and 2^20 (D=4,
   K=4 for the scoring kernels; D=4, K=3 for the EM kernels). At the
   main path's shape ``gmm_score``'s library call is timed beside the
   kernel (`library_score`: ``MultivariateNormal(loc,
   precision_matrix=U U^T).log_prob``) and must agree with it within the
   kernel's float32 tolerance.
16. ``profile``: torch.profiler over 5 full-width training steps, one
   GMMDetector fit at the main path's largest layer shape, and one
   streaming detection tick at the stream path's shapes: device time, the
   device's busy share of the wall time, and the costliest kernels.

Every path must launch only specialised kernels (the wrappers'
``VARIANTS``, set to 0 before each path and read after). Every phase line
carries its wall ``seconds``; the ``kernels`` line the whole run's. Every
path line whose sessions detached a device probe carries ``device``
(`device_summary`): the DEVICE source and sampler, NVML's UUIDs and power
limits, each reading's min and max, the sampler process's sweep ms p50 and
p99, the job-side drain's µs a step and the failed samples, which must be
0.
Then the ``kernels`` line (each kernel's launches on its path — the main
path for the scoring kernels, the stream path for the EM kernels — its
largest error against the plain version at that path's largest shape, its
device time per wrapper call, the plain version's, its bound, the library
call's where one computes the same function (``gmm_score``), and beside
them the launch alone, the eager per-call time, the kernels and memsets a
wrapper call puts on the stream, counted with torch.profiler, which must be
one kernel and, for the EM kernels, one memset, and the variants each path
launched, the fleet, eval, ckpt, obs, serve, arch and serve_arch paths'
among them), the card's name and power limit as
nvidia-smi prints them, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failure exits
non-zero before that line. TF32 is off for matmuls
(PyTorch's default) and set off for cuDNN here, so float32 comparisons are
float32.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"gmm_score": CSRC + "gmm_score.cu",
           "gmm_best": CSRC + "gmm_score.cu",
           "gmm_stats": CSRC + "gmm_stats.cu",
           "gmm_update": CSRC + "gmm_stats.cu"}
REPLACES = {"gmm_score": "src/repro/kernels/gmm_score.py:28",
            "gmm_best": "src/repro/kernels/gmm_score.py:45",
            "gmm_stats": "src/repro/kernels/gmm_stats.py:80",
            "gmm_update": "src/repro/kernels/gmm_stats.py:87"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SHAPES = [(128, 2, 2), (1000, 4, 3), (4096, 8, 8), (777, 3, 5),
          (2048, 16, 4), (513, 8, 16), (64, 32, 2), (1000, 32, 16),
          (0, 4, 3), (4096, 4, 4), (1 << 20, 4, 4)]
BF16_SHAPES = [(512, 6, 4), (4096, 4, 4), (1000, 32, 16)]
SCALING = [(4096, 4, 4), (1 << 20, 4, 4)]
# the EM kernels: tests/test_kernels.py's grids, then the edge cases
STATS_SHAPES = SHAPES[:5]
UPDATE_SHAPES = [(256, 2, 2), (1000, 4, 3), (777, 3, 5), (512, 8, 1),
                 (64, 5, 1)]
BUCKETS = [(256, 4, 3), (512, 8, 1), (1024, 2, 4)]
EM_SCALING = [(4096, 4, 3), (1 << 20, 4, 3)]
STREAM_FIT_SHAPE = (2048, 4, 3)  # OnlineGMMDetector.fit_rows, D=4, K=3


class SmokeFailure(Exception):
    pass


# the lines of a path that ran sessions: each reports the device probes
# that detached since the previous one (`watch_device_probes`)
PATH_PHASES = ("main_path", "stream_path", "session_path", "fleet_path",
               "families_path", "eval_path", "ckpt_path", "obs_path",
               "serve_path", "arch_path", "serve_arch_path", "nvml_path",
               "mesh_path")
DEVICE_RUNS = []  # each detached device probe's stats, until reported


def emit(obj) -> None:
    runs = None
    if isinstance(obj, dict) and obj.get("phase") in PATH_PHASES \
            and DEVICE_RUNS:
        runs = DEVICE_RUNS[:]
        DEVICE_RUNS.clear()
        obj = {**obj, "device": device_summary(runs)}
    print(json.dumps(obj), flush=True)
    if runs:
        check_device(obj["phase"], obj["device"])


def watch_device_probes() -> None:
    """Keep every device probe's `stats()` (and its sweeps' ms) as it
    detaches, for the next path line (`emit`)."""
    from repro_torch.core.probes.device_probe import DeviceProbe

    detach = DeviceProbe._detach

    def kept(self):
        detach(self)
        DEVICE_RUNS.append({**self.stats(), "sweep_ms": list(self.sweep_ms),
                            "drain_s": self.drain_s, "drains": self.drains})

    DeviceProbe._detach = kept


def adopt_device_runs(out_path) -> None:
    """The device runs a child (`child_main`) had not reported."""
    side = out_path + ".device.json"
    if os.path.exists(side):
        with open(side) as f:
            DEVICE_RUNS.extend(json.load(f))
        os.remove(side)


def device_summary(runs) -> dict:
    """The DEVICE layer's source over a path's sessions: NVML's UUIDs and
    power limits, each reading's min and max, the job's own memory as the
    GPU driver lists it, the sampler process's start and sweep ms, the job's
    drain µs a step, failed samples."""
    import numpy as np

    sweeps = np.asarray([ms for r in runs for ms in r["sweep_ms"]])
    keys = sorted({k for r in runs for k in r["reading_min_max"]})
    proc = [r["process_memory"] for r in runs]
    drains = sum(r["drains"] for r in runs)
    return {
        "sessions": len(runs),
        "sources": sorted({r["source"] for r in runs}),
        "samplers": sorted({r["sampler"] for r in runs}),
        "uuids": sorted({u for r in runs for u in r["uuids"]}),
        "power_limit_w": sorted({w for r in runs for w in r["power_limit_w"]}),
        "reading_min_max": {
            k: [min(r["reading_min_max"][k][0] for r in runs
                    if k in r["reading_min_max"]),
                max(r["reading_min_max"][k][1] for r in runs
                    if k in r["reading_min_max"])] for k in keys},
        "process_memory": {
            "answered": any(p["answered"] for p in proc),
            "pid_found": any(p["pid_found"] for p in proc),
            "gb_max": max((p["gb"] for p in proc if p["gb"] is not None),
                          default=None)},
        "start_ms_max": max(r["start_ms"] for r in runs),
        "sweeps": int(sweeps.size),
        "sweep_ms_p50_p99": (np.percentile(sweeps, [50, 99]).tolist()
                             if sweeps.size else None),
        "drain_us_per_step": (1e6 * sum(r["drain_s"] for r in runs) / drains
                              if drains else None),
        "failed_samples": sum(r["failed_samples"] for r in runs),
        "last_error": next((r["last_error"] for r in runs
                            if r["last_error"]), None)}


def check_device(where, dev) -> None:
    """No session lost a device sample; ``nvml_path``'s sessions read
    NVML."""
    if where == "nvml_path" and dev["sources"] != ["nvml"]:
        raise SmokeFailure(f"{where}: DEVICE source {dev['sources']}, not "
                           "NVML")
    if dev["failed_samples"]:
        raise SmokeFailure(f"{where}: {dev['failed_samples']} failed device "
                           f"samples ({dev['last_error']})")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def make_params(N, D, K, seed, dtype):
    """The kernel tests' inputs: X ~ N(0, 1), means ~ N(0, 1), U from a
    random SPD covariance; made on the CPU from a seed, moved to the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    X = torch.randn((N, D), generator=g)
    means = torch.randn((K, D), generator=g)
    A = 0.3 * torch.randn((K, D, D), generator=g, dtype=torch.float64)
    cov = A @ A.transpose(-1, -2) + 0.5 * torch.eye(D, dtype=torch.float64)
    L = torch.linalg.cholesky(cov)
    U = torch.linalg.solve_triangular(
        L, torch.eye(D, dtype=torch.float64).expand(K, D, D),
        upper=False).transpose(-1, -2)
    return (X.to(dtype).cuda(), means.cuda(),
            U.to(torch.float32).contiguous().cuda())


def path_layout(U):
    """U as the EM loop hands it over: the transpose of a contiguous tensor
    (`_prec_chol_from_cov` returns L^-T as a view), the same values."""
    return U.transpose(-1, -2).contiguous().transpose(-1, -2)


def ptxas_summary(logs):
    """Registers, stack and spill bytes of every kernel instantiation from
    nvcc's -Xptxas=-v output, keyed by a short name such as
    ``em_fixed<f32,4,3>`` (``score_fixed<bf16,4,3,1>``: the last number of
    a scoring kernel is BEST)."""
    import re

    out, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(_Z\w+)", ln)
            if m:
                mangled = m.group(1)
                base = re.search(r"(score_fixed|score_general|em_fixed|"
                                 r"em_general)", mangled)
                if base is None:
                    name = None
                    continue
                tail = mangled[base.end():]
                args = re.findall(r"L[ib](\d+)E", tail.split("EEv")[0])
                dtype = "bf16" if "bfloat16" in tail.split("EEv")[0] else "f32"
                name = f"{base.group(1)}<{','.join([dtype, *args])}>"
                out.setdefault(name, {})
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                out[name].update(stack=int(m.group(1)),
                                 spill=int(m.group(2)) + int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def compare(name, got, want, rtol, atol, logp=None):
    """Largest |got - want| of one output pair; raises past tolerance."""
    import torch

    if name.endswith("arg"):
        mism = got != want
        if bool(mism.any()):
            top2 = torch.sort(logp[mism], dim=1).values[:, -2:]
            if not bool(torch.all(torch.abs(top2[:, 0] - top2[:, 1]) < 1e-3)):
                raise SmokeFailure(f"{name}: argmax differs away from a tie")
        return 0.0
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} vs "
                           f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    err = torch.abs(got - want)
    if bool(torch.any(err > atol + rtol * torch.abs(want))):
        raise SmokeFailure(f"{name}: max abs err {float(err.max())} "
                           f"beyond rtol {rtol} / atol {atol}")
    return float(err.max())


def check_case(ops, N, D, K, dtype, seed):
    """Both kernels against their plain versions on one input; returns the
    largest error of each kernel."""
    import torch

    X, means, U = make_params(N, D, K, seed, dtype)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (5e-2, 5e-1)
    want = ops.gmm_score(X, means, U, backend="plain")
    got = ops.gmm_score(X, means, U)
    wb, wa = ops.gmm_best(X, means, U, backend="plain")
    gb, ga = ops.gmm_best(X, means, U)
    torch.cuda.synchronize()
    tag = f"N={N} D={D} K={K} {str(dtype)[6:]}"
    return {
        "gmm_score": compare(f"gmm_score {tag}", got, want, rtol, atol),
        "gmm_best": max(
            compare(f"gmm_best {tag} best", gb, wb, rtol, atol),
            compare(f"gmm_best {tag} arg", ga, wa, 0, 0, logp=want)),
    }


def check_em_case(ops, N, D, K, dtype, seed, nvalid=None):
    """``gmm_stats`` and ``gmm_update`` against their plain versions on one
    input, rows at and past ``nvalid`` poisoned to 1e6; each kernel is
    called twice and must give bitwise equal outputs. Returns, per kernel,
    the largest absolute error and the largest error relative to
    max(|want|, 1) of its output."""
    import torch

    X, means, U = make_params(N, D, K, seed, dtype)
    if nvalid is not None:
        X[nvalid:] = 1e6
    log_w = torch.log(torch.full((K,), 1.0 / K, device=X.device))
    tag = f"N={N} D={D} K={K} nvalid={nvalid} {str(dtype)[6:]}"
    worst, worst_rel = {}, {}
    for name in ("gmm_stats", "gmm_update"):
        fn = getattr(ops, name)
        want = fn(X, log_w, means, U, nvalid=nvalid, backend="plain")
        got = fn(X, log_w, means, U, nvalid=nvalid)
        again = fn(X, log_w, means, U, nvalid=nvalid)
        torch.cuda.synchronize()
        worst[name] = worst_rel[name] = 0.0
        for i, (g, w, g2) in enumerate(zip(got, want, again)):
            scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
            err = compare(f"{name} {tag} output {i}", g, w, 1e-4,
                          1e-4 * scale)
            if not bool(torch.isfinite(g).all()):
                raise SmokeFailure(f"{name} {tag} output {i} not finite")
            if not torch.equal(g, g2):
                raise SmokeFailure(f"{name} {tag} output {i}: two calls "
                                   "differ (not deterministic)")
            worst[name] = max(worst[name], err)
            worst_rel[name] = max(worst_rel[name], err / scale)
    return worst, worst_rel


def em_cases():
    """(N, D, K, dtype, nvalid) of the EM kernels' check."""
    import torch

    f32 = torch.float32
    cases = [(N, D, K, f32, None) for N, D, K in STATS_SHAPES + UPDATE_SHAPES]
    cases += [(N, D, K, f32, max(int(N * frac), 1))
              for N, D, K in BUCKETS for frac in (1.0, 0.61, 0.25)]
    cases += [(256, 4, 3, f32, 0), (0, 4, 3, f32, None),
              (2048, 4, 3, torch.bfloat16, None),
              (512, 6, 4, torch.bfloat16, 300), (1000, 32, 16, f32, None),
              (3000, 32, 16, f32, 1777), (1 << 20, 4, 3, f32, None)]
    return cases


def check_ties_and_nan(ops):
    """Exact ties must give the first index and a NaN component must give
    the plain version's (NaN, first NaN index)."""
    import torch

    X, means, U = make_params(2048, 4, 3, 11, torch.float32)
    means[1], U[1] = means[0], U[0]  # component 1 ties component 0
    wb, wa = ops.gmm_best(X, means, U, backend="plain")
    gb, ga = ops.gmm_best(X, means, U)
    if bool(torch.any(ga == 1)) or not torch.equal(
            ga, torch.where(wa == 1, 0, wa)):
        raise SmokeFailure("gmm_best did not keep the first of tied "
                           "components")
    if not torch.allclose(gb, wb, rtol=1e-5, atol=1e-4):
        raise SmokeFailure("gmm_best density differs from plain on ties")
    U[2, 0, 0] = float("nan")  # component 2 is NaN on every row
    wb, wa = ops.gmm_best(X, means, U, backend="plain")
    gb, ga = ops.gmm_best(X, means, U)
    if not (torch.equal(ga, wa) and bool(torch.all(wa == 2))
            and bool(torch.all(torch.isnan(gb)))
            and bool(torch.all(torch.isnan(wb)))):
        raise SmokeFailure("gmm_best differs from plain on a NaN component")


def em_inputs(N, D, K, seed):
    import torch

    X, means, U = make_params(N, D, K, seed, torch.float32)
    return X, torch.log(torch.full((K,), 1.0 / K, device=X.device)), means, U


def check_layout_and_nan(ops):
    """On both sides of the specialised / general boundary: U as the EM
    loop hands it over (a transposed view) gives bitwise the outputs of a
    contiguous U, within tolerance of the plain version; a NaN U (the
    all-NaN factor of a non-PD covariance) gives NaN exactly where the
    plain version does, and elsewhere agrees with it. Returns the cases."""
    import torch

    cases = 0
    for N, D, K in ((227, 4, 3), (2048, 3, 3), (777, 5, 3), (500, 4, 6)):
        X, log_w, means, U = em_inputs(N, D, K, 31 + D + K)
        Ut = path_layout(U)
        assert not Ut.is_contiguous()
        for name in ("gmm_score", "gmm_best", "gmm_stats", "gmm_update"):
            fn = getattr(ops, name)
            args = (X, log_w, means) if name in ("gmm_stats",
                                                  "gmm_update") else (X, means)
            got, want = fn(*args, Ut), fn(*args, U)
            plain = fn(*args, Ut, backend="plain")
            got, want, plain = ((o,) if torch.is_tensor(o) else tuple(o)
                                for o in (got, want, plain))
            for i, (g, w, p) in enumerate(zip(got, want, plain)):
                if not torch.equal(g, w):
                    raise SmokeFailure(f"{name} N={N} D={D} K={K} output {i}:"
                                       " a transposed U differs from a "
                                       "contiguous one")
                if g.dtype == torch.float32:
                    scale = max(float(p.abs().max()), 1.0)
                    rtol, atol = ((1e-5, 1e-4) if name in ("gmm_score",
                                                           "gmm_best")
                                  else (1e-4, 1e-4 * scale))
                    compare(f"{name} transposed U N={N} D={D} K={K} "
                            f"output {i}", g, p, rtol, atol)
            Un = U.clone()
            Un[1] = float("nan")
            got = fn(*args, Un)
            plain = fn(*args, Un, backend="plain")
            got, plain = ((o,) if torch.is_tensor(o) else tuple(o)
                          for o in (got, plain))
            for i, (g, p) in enumerate(zip(got, plain)):
                if g.dtype != torch.float32:
                    if not torch.equal(g, p):
                        raise SmokeFailure(f"{name} NaN U N={N} D={D} K={K}:"
                                           " argmax differs from plain")
                    continue
                nan = torch.isnan(p)
                if not torch.equal(torch.isnan(g), nan) or not bool(
                        nan.any()):
                    raise SmokeFailure(f"{name} NaN U N={N} D={D} K={K} "
                                       f"output {i}: NaNs differ from plain")
                if not bool(nan.all()):
                    compare(f"{name} NaN U N={N} D={D} K={K} output {i}",
                            g[~nan], p[~nan], 1e-5, 1e-4)
            cases += 1
    torch.cuda.synchronize()
    return cases


def check_boundary(ops, kmod, smod):
    """Shapes on both sides of the specialised / general boundary launch
    the variant the wrappers' list says, and agree with the plain
    versions. Returns {shape: variant}."""
    import torch

    seen = {}
    for N, D, K in ((1000, 4, 4), (1000, 5, 4), (1000, 4, 5), (1000, 2, 1),
                    (1000, 1, 3), (1000, 3, 4)):
        want = kmod.variant(D, K)
        before = ({k: dict(v) for k, v in kmod.VARIANTS.items()},
                  {k: dict(v) for k, v in smod.VARIANTS.items()})
        check_case(ops, N, D, K, torch.float32, seed=70 + D + K)
        check_em_case(ops, N, D, K, torch.float32, seed=80 + D + K)
        for counts, old in ((kmod.VARIANTS, before[0]),
                            (smod.VARIANTS, before[1])):
            for name, v in counts.items():
                if v[want] - old[name][want] < 1 or sum(v.values()) - sum(
                        old[name].values()) != v[want] - old[name][want]:
                    raise SmokeFailure(f"{name} at D={D} K={K} did not "
                                       f"launch only the {want} kernel")
        seen[f"D={D} K={K}"] = want
    return seen


def check_em_graph_replay(ops):
    """The EM kernels captured in one CUDA graph (the counter's memset and
    the launch) and replayed: every replay bitwise equal to the eager call,
    also after new rows are copied into the captured input, so a stale
    counter or a last block reading stale partials would show. Returns the
    replays."""
    import torch

    replays = 0
    for N, D, K in ((65536, 4, 3), (2048, 4, 3), (3000, 8, 8)):
        for name in ("gmm_stats", "gmm_update"):
            fn = getattr(ops, name)
            X, log_w, means, U = em_inputs(N, D, K, 41 + N % 97)
            U = path_layout(U)
            fn(X, log_w, means, U)  # warm-up outside the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = fn(X, log_w, means, U)
            for r in range(4):
                if r == 3:  # new rows into the captured input
                    X.copy_(make_params(N, D, K, 99, torch.float32)[0])
                graph.replay()
                eager = fn(X, log_w, means, U)
                torch.cuda.synchronize()
                for i, (g, e) in enumerate(zip(captured, eager)):
                    if not torch.equal(g, e):
                        raise SmokeFailure(
                            f"{name} N={N} D={D} K={K} output {i}: graph "
                            f"replay {r} differs from the eager call")
                replays += 1
            del graph
    return replays


def _device_events(prof):
    """Device events of a torch.profiler trace: {kernel or op name: count}."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def nodes_per_call(fn, calls=20, attempts=5):
    """What one wrapper call puts on the stream, counted by torch.profiler
    over ``calls`` eager calls after a warm-up: kernels, memsets and
    copies per call.

    The profiler now and then loses device events over many short sessions
    — all of a trace, or most of it (one run recorded 2 of 20 calls' kernels
    and memsets). So every call is followed by a marker, one in-place add on
    a one-element tensor, whose device events are learnt first from a trace
    of the marker alone: a trace that holds fewer marker events than calls
    lost events and is taken again, up to ``attempts`` times. The marker's
    events are not counted as the wrapper's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mark = torch.zeros(1, device="cuda")
    fn()
    mark.add_(1.0)
    torch.cuda.synchronize()
    marker = {}
    for _ in range(attempts):
        with profile(activities=acts) as prof:
            mark.add_(1.0)
            torch.cuda.synchronize()
        marker = _device_events(prof)
        if marker:
            break
    for _ in range(attempts):
        with profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
                mark.add_(1.0)
            torch.cuda.synchronize()
        events = _device_events(prof)
        if marker and all(events.get(k, 0) >= n * calls
                          for k, n in marker.items()):
            break
    counts = {"kernels": 0, "memsets": 0, "memcpys": 0}
    for key, n in events.items():
        n -= marker.get(key, 0) * calls
        k = key.lower()
        counts["memsets" if "memset" in k else
               "memcpys" if "memcpy" in k else "kernels"] += max(n, 0)
    return {k: v / calls for k, v in counts.items()}


def check_graphed_step(steps=6):
    """The CUDA-graphed forward and backward against the eager one at full
    width (GPT-2 124M, bf16, batch 8, sequence 128), on a new batch and
    perturbed weights at every call, so a graph that read a stale batch or
    stale weights would disagree. Loss within 1e-3 relative; the gradients'
    difference within 1e-2 of their global norm (the same kernels, with
    cuBLAS free to pick another algorithm inside the capture). Returns the
    largest of each."""
    import torch

    from repro_torch.config import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime, batch_to_device, init_params
    from repro_torch.train.step import CudaGraphed, make_loss_and_grads

    dev = torch.device("cuda")
    cfg = get_arch("gpt2")
    params = init_params(cfg, seed=0, device=dev)
    plist = list(params.values())
    eager = make_loss_and_grads(cfg, Runtime(torch.bfloat16))
    graphed = CudaGraphed(eager)
    data = SyntheticLMData(cfg, seq_len=128, global_batch=8, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst_loss = worst_grad = 0.0
    for s in range(steps):
        batch = batch_to_device(data.batch(s), dev)
        lg, _, gg = graphed(params, batch)
        le, _, ge = eager(params, batch)
        diff = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            torch._foreach_sub(list(gg), list(ge)))))
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            list(ge))))
        rel_loss = abs(float(lg) - float(le)) / abs(float(le))
        rel_grad = float(diff / norm)
        if not (rel_loss <= 1e-3 and rel_grad <= 1e-2):
            raise SmokeFailure(f"graphed step {s} differs from eager: loss "
                               f"{float(lg)} vs {float(le)}, grad diff "
                               f"{rel_grad} of the norm")
        worst_loss, worst_grad = max(worst_loss, rel_loss), max(worst_grad,
                                                                rel_grad)
        with torch.no_grad():
            for p in plist:
                p.add_(torch.randn(p.shape, generator=gen, device=dev),
                       alpha=0.01)
    if graphed.graph is None:
        raise SmokeFailure("the train step was never captured")
    del params, plist, graphed
    return worst_loss, worst_grad


def check_graphed_train_step(steps=6):
    """The whole train step — forward, backward and the AdamW update —
    replayed as one CUDA graph against the eager step with host floats, at
    full width from the same seed: each step's loss within 1e-3 relative,
    and the parameters after the last step within 1e-2 of how far the eager
    step moved them (model-wide norms: Adam's update is scale-free, so an
    entry whose gradient sits at the noise floor may step the other way).
    Returns the largest loss error and the parameters' error."""
    import torch

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime, batch_to_device
    from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                        make_train_step)

    dev = torch.device("cuda")
    cfg = get_arch("gpt2")
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                         total_steps=steps, warmup_steps=5),
                             cfg)
    runs = []
    for graph in (True, False):
        data = SyntheticLMData(cfg, seq_len=128, global_batch=8, seed=0)
        state = init_train_state(cfg, opt, seed=0, device=dev)
        init = [p.detach().clone() for p in state.params.values()]
        fn = make_train_step(cfg, Runtime(torch.bfloat16), opt,
                             cuda_graph=graph)
        losses = []
        for s in range(steps):
            state, m = fn(state, batch_to_device(data.batch(s), dev))
            losses.append(float(m["loss"]))
        runs.append((list(state.params.values()), losses, init))
        del state, fn, data
    (pg, lg, _), (pe, le, init) = runs

    def norm(ts):
        return float(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(ts))))

    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(lg, le))
    with torch.no_grad():
        rel_params = norm(torch._foreach_sub(pg, pe)) / norm(
            torch._foreach_sub(pe, init))
    del runs, pg, pe, init
    gc.collect()
    torch.cuda.empty_cache()
    if not (rel_loss <= 1e-3 and rel_params <= 1e-2):
        raise SmokeFailure(f"the graphed train step differs from the eager "
                           f"one: losses {lg} vs {le}, parameters "
                           f"{rel_params} of their move")
    return rel_loss, rel_params


def host_ms(fn, reps):
    """Per-call time of back-to-back eager calls: what a caller pays while
    the host enqueues launches (CUDA events, after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Per-call device time: ``reps`` calls captured in one CUDA graph and
    replayed, so no host work sits between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def bound_ms(kernel, N, D, K, x_bytes=4):
    """Least time for the work on an H100 SXM: each input read once, each
    output written once, over 3.35 TB/s; the float32 flops over 67 TFLOP/s;
    the larger of the two. Every kernel reads X, means and U, and forms
    mu U and log|det U| once a call (2 K D^2 + K D flops). Scoring kernels:
    (N, K) or 2 (N,) out; K (2 D^2 + 3 D + 3) flops a row (the density).
    EM kernels: log w in besides; nk, sx or means, sxx or cov and ll out;
    K (3 D^2 + 6 D + 10) + 1 flops a row: the density, the
    responsibilities' log-sum-exp (6 a component, exp counted as one), nk
    and sx (1 + 2 D), sxx as the symmetric product of r x with x (D^2 + D:
    half the entries at 2 flops, r x_d reused from sx) and ll (1).
    gmm_update adds its M-step once: K (3 D (D + 1) / 2 + D + 1) flops."""
    params = 4 * (K * D * D + K * D)
    ops = 2 * K * D * D + K * D
    if kernel in ("gmm_score", "gmm_best"):
        out = N * K * 4 if kernel == "gmm_score" else N * 8
        ops += N * K * (2 * D * D + 3 * D + 3)
    else:
        params += 4 * K
        out = 4 * (K * D * D + K * D + K + 1)
        ops += N * (K * (3 * D * D + 6 * D + 10) + 1)
        if kernel == "gmm_update":
            ops += K * (3 * D * (D + 1) // 2 + D + 1)
    bytes_ = N * D * x_bytes + params + out
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure(ops, kmod, N, D, K, reps, library=False):
    """Times of each kernel and its plain version on one float32 input, U
    in the EM loop's layout (a transposed view). ``ms`` / ``plain_ms``:
    device time of a wrapper call (its one launch) and of a plain call;
    ``kernel_only_ms``: the launch alone, through the C entry point;
    ``host_ms`` / ``plain_host_ms``: back-to-back eager calls, bound by the
    host at small N; ``nodes``: what a wrapper call puts on the stream;
    with ``library``, ``gmm_score``'s library call's (`library_score`)."""
    import torch

    X, means, U = make_params(N, D, K, 5, torch.float32)
    U = path_layout(U)
    params = kmod.param_args(*kmod.param_views(means, U))
    spec = int((D, K) in kmod.SPECIALISED)
    outs = {"gmm_score": (torch.empty((N, K), device=X.device),),
            "gmm_best": (torch.empty((N,), device=X.device),
                         torch.empty((N,), dtype=torch.int32,
                                     device=X.device))}
    res = {}
    for name, fn in (("gmm_score", ops.gmm_score), ("gmm_best", ops.gmm_best)):
        launch = kmod._fn(f"{name}_launch")
        ptrs = [t.data_ptr() for t in outs[name]]

        def raw():
            launch(X.data_ptr(), 0, *params, *ptrs, N, D, K, spec,
                   torch.cuda.current_stream().cuda_stream)

        b, by = bound_ms(name, N, D, K)
        res[name] = {
            "ms": device_ms(lambda: fn(X, means, U), reps),
            "plain_ms": device_ms(lambda: fn(X, means, U, backend="plain"),
                                  reps),
            "kernel_only_ms": device_ms(raw, reps),
            "host_ms": host_ms(lambda: fn(X, means, U), reps),
            "plain_host_ms": host_ms(
                lambda: fn(X, means, U, backend="plain"), reps),
            "nodes": nodes_per_call(lambda: fn(X, means, U)),
            # gmm_best: no one call takes the densities' max and argmax
            "bound_ms": b, "bound_by": by, "library_ms": None}
    if library:
        res["gmm_score"].update(library_score(ops, X, means, U, reps))
    return res


def library_score(ops, X, means, U, reps):
    """The one PyTorch call that computes ``gmm_score``'s function, the
    (N, K) Gaussian log densities: ``MultivariateNormal(loc=means,
    precision_matrix=U U^T).log_prob(X[:, None, :])``, timed as the kernel
    is (`device_ms`). The distribution is built once, outside the timing:
    its Cholesky factorisation checks its result on the host, which a CUDA
    graph cannot hold. Its output against the kernel's: the largest
    absolute error, and whether it is within the kernel's own float32
    tolerance (rtol 1e-5, atol 1e-4). At the main path's shape only: at
    N=2^20 the call is slow and wrong, and its capture in a CUDA graph
    crashed the process (`scripts/library_score.py` measures it there)."""
    import torch

    Uc = U.contiguous()
    mvn = torch.distributions.MultivariateNormal(
        loc=means, precision_matrix=Uc @ Uc.transpose(-1, -2),
        validate_args=False)

    def call():
        return mvn.log_prob(X[:, None, :])

    got, want = call(), ops.gmm_score(X, means, U)
    return {"library_ms": device_ms(call, reps),
            "library_max_abs_err": float((got - want).abs().max()),
            "library_agrees": bool(torch.allclose(got, want, rtol=1e-5,
                                                  atol=1e-4))}


def measure_em(ops, smod, N, D, K, reps):
    """The EM kernels' times on one float32 input, as `measure` gives them
    for the scoring kernels: ``ms`` (a wrapper call: the outputs' and
    workspace's allocation, the counter's memset and the launch),
    ``plain_ms``, ``kernel_only_ms`` (the memset and the launch alone),
    ``host_ms`` / ``plain_host_ms`` (back-to-back eager calls), ``nodes``."""
    import torch

    from repro_torch.kernels import gmm_score as kmod

    X, log_w, means, U = em_inputs(N, D, K, 5)
    U = path_layout(U)
    params = kmod.param_args(*kmod.param_views(means, U))
    spec = int((D, K) in kmod.SPECIALISED)
    outs = [torch.empty(shape, device=X.device)
            for shape in ((K,), (K, D), (K, D, D), ())]
    nb, work = smod.workspace(N, D, K, X.device)
    res = {}
    for name in ("gmm_stats", "gmm_update"):
        fn = getattr(ops, name)
        launch = smod._fn(f"{name}_launch")

        def raw():
            launch(X.data_ptr(), 0, log_w.data_ptr(), log_w.stride(0),
                   *params, *(o.data_ptr() for o in outs), work.data_ptr(),
                   N, N, D, K, nb, spec,
                   torch.cuda.current_stream().cuda_stream)

        b, by = bound_ms(name, N, D, K)
        res[name] = {
            "ms": device_ms(lambda: fn(X, log_w, means, U), reps),
            "plain_ms": device_ms(
                lambda: fn(X, log_w, means, U, backend="plain"), reps),
            "kernel_only_ms": device_ms(raw, reps),
            "host_ms": host_ms(lambda: fn(X, log_w, means, U), reps),
            "plain_host_ms": host_ms(
                lambda: fn(X, log_w, means, U, backend="plain"), reps),
            "nodes": nodes_per_call(lambda: fn(X, log_w, means, U)),
            # no one PyTorch call computes the E-step's reductions (the
            # responsibilities' log-sum-exp, then nk, sx, sxx and ll)
            "bound_ms": b, "bound_by": by, "library_ms": None}
    return res


def profile_summary(prof, wall_s, n):
    """Device time per iteration, the device's busy share of the wall time,
    kernels per iteration and the costliest kernels, from a torch.profiler
    trace (null where the trace holds no device time). Only the device's
    own events count: an aten op's device time is its kernels' again."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(r[1] for r in rows)
    return {
        "wall_ms": 1e3 * wall_s / n,
        "device_ms": total_us / 1e3 / n if total_us else None,
        "device_busy_share": total_us / 1e6 / wall_s if total_us else None,
        "device_kernels": sum(r[2] for r in rows) / n,
        "top_ms": [[k[:64], us / 1e3 / n]
                   for k, us, _ in sorted(rows, key=lambda r: -r[1])[:6]]}


def profile_phase(N, D, K):
    """Where the main path's time goes on the card. The full-width training
    step, CUDA-graphed (as the main path runs it) and eager: after 3 warm-up
    steps, the per-step wall time of 10 steps (host clock, synchronised
    each step) with the profiler off, then 5 steps under torch.profiler.
    Then one GMMDetector fit at the main path's largest layer shape, and
    the streaming detector's warmup (cold fits) and one detection tick
    (bootstrap warm refits) on the stream path's shapes, under
    torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.core.detector import GMMDetector
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime, batch_to_device
    from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                        make_train_step)

    dev = torch.device("cuda")
    cfg = get_arch("gpt2")
    opt = make_optimizer_for(TrainConfig(learning_rate=1e-3, total_steps=18,
                                         warmup_steps=2), cfg)
    data = SyntheticLMData(cfg, seq_len=128, global_batch=8, seed=0)
    batches = [batch_to_device(data.batch(s), dev) for s in range(18)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    for name, graph in (("train_step", True), ("train_step_eager", False)):
        state = init_train_state(cfg, opt, device=dev)
        step = make_train_step(cfg, Runtime(torch.bfloat16), opt,
                               cuda_graph=graph)
        for b in batches[:3]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        step_ms = []
        for b in batches[3:13]:
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for b in batches[13:]:
                state, _ = step(state, b)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        out[name] = {"step_ms_p10_p50_p90": np.percentile(
            step_ms, [10, 50, 90]).tolist(),
            **profile_summary(prof, train_s, 5)}
        del state, step
    del batches

    rng = np.random.default_rng(0)
    X = (6.0 * rng.standard_normal((K, D)))[rng.integers(0, K, N)] \
        + rng.standard_normal((N, D))
    GMMDetector(n_components=K, device=dev).fit(X)  # warm-up
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        GMMDetector(n_components=K, device=dev).fit(X)
        fit_s = time.perf_counter() - t0
    out["gmm_fit"] = profile_summary(prof, fit_s, 1)
    out["gmm_fit"]["shape"] = [N, D, K]
    out.update(profile_stream_tick(dev, acts))
    return out


def profile_stream_tick(dev, acts):
    """The streaming detector at the stream path's shapes: STEP and XLA
    rows of a 17.2 ms step for one node, warmup on 96 steps (a cold fit of
    40 EM iterations per layer), one tick at step 120 to settle, then the
    tick at step 140 (score, drift check, a 4-iteration bootstrap warm refit
    and its statistics per layer), each under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from repro_torch.core.events import Event, Layer
    from repro_torch.stream import FleetAggregator, OnlineGMMDetector, wire

    rng = np.random.default_rng(0)

    def batch(lo, hi, seq):
        evs = [Event(layer=layer, name=name, ts=0.0172 * s,
                     dur=0.0172 * float(rng.lognormal(0.0, 0.01)), step=s)
               for s in range(lo, hi)
               for layer, name in ((Layer.STEP, "train_step"),
                                   (Layer.XLA, "executable_run"))]
        return wire.encode_events(evs, node_id=0, seq=seq)

    agg = FleetAggregator(horizon_s=300.0)
    det = OnlineGMMDetector(n_components=3, contamination=0.02,
                            min_events=32, seed=0, device=dev)
    agg.ingest(batch(0, 96, 0))
    out = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        det.warmup(agg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["stream_warmup"] = profile_summary(prof, wall, 1)
    agg.ingest(batch(96, 120, 1))
    det.detect(agg)
    agg.ingest(batch(120, 140, 2))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        modes = {l.value: d.refit for l, d in det.detect(agg).items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["stream_tick"] = profile_summary(prof, wall, 1)
    out["stream_tick"]["modes"] = modes
    return out


def stream_line(st, launches, plain_calls):
    """The stream_path phase's JSON line. Which refit branches ran is
    reckoned from the counts: a cold fit is cold_iters=40 gmm_update calls,
    a bootstrap warm refit refit_iters=4, and an incremental fold none."""
    losses = st["losses"]
    fits = len(st["refits"])  # warmup: one cold fit per modelled layer
    cold = sum(r["cold"] for r in st["refits"].values())
    warm = sum(r["warm"] for r in st["refits"].values())
    bootstrap = (launches["gmm_update"] - 40 * (fits + cold)) / 4
    m = st["match"]
    top = st["incidents"][0] if st["incidents"] else None
    top_suspect = top.suspect_layer.value if top else None
    return {
        "phase": "stream_path", "steps": st["steps"], "batch": st["batch"],
        "seq": st["seq"], "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]), "steps_per_s": st["steps_per_s"],
        "setup_ms": st["setup_ms"], "ticks": st["ticks"], "detect_ms_per_tick": st["detect_ms_per_tick"],
        "refits": st["refits"], "tick_modes": st["tick_modes"],
        "branches": {"cold_fits": fits + cold, "bootstrap_warm": bootstrap,
                     "folds": warm - bootstrap},
        "events_ingested": st["events_ingested"],
        "wire_bytes_per_event": st["wire_bytes_per_event"],
        "lost_batches": st["lost_batches"],
        "window_sizes": st["window_sizes"],
        "failed_samples": st["failed_samples"],
        "windows": st["windows"], "recall": m.recall,
        "precision": m.precision, "window_hits": m.window_hits,
        "spurious": m.spurious,
        "incidents": [i.to_json() for i in st["incidents"]],
        "top_suspect": top_suspect,
        "top_heaviest_layer": (max(top.layer_deficit,
                                   key=top.layer_deficit.get)
                               if top else None),
        "unmet": ([] if top_suspect == "operator" else
                  [f"top incident's suspect layer is operator (the layer "
                   f"op_latency perturbs at its source): the engine names "
                   f"{top_suspect}"]),
        "runtime_probe": st["runtime_probe"],
        "launches": launches, "plain_calls": plain_calls}


def check_stream(st, launches, plain_calls):
    """The stream path's gates. One criterion is reported, not enforced:
    that the top incident's suspect layer is operator, where op_latency is
    injected (the incident engine treats STEP as a symptom and blames a
    cause layer flagged in the cluster); ``stream_line`` lists it under
    ``unmet``. The gate here is that the top incident's deficit lies mostly
    on a layer op_latency perturbs: operator or step."""
    if not all(math.isfinite(float(v)) for v in st["losses"]):
        raise SmokeFailure("non-finite training loss on the stream path")
    if not all(launches.values()):
        raise SmokeFailure(f"a kernel was not launched on the stream path: "
                           f"{launches}")
    if any(plain_calls.values()):
        raise SmokeFailure(f"plain versions ran on the stream path: "
                           f"{plain_calls}")
    m = st["match"]
    if not (m.windows_detected >= 2 and m.precision >= 0.5):
        raise SmokeFailure(f"stream detection too weak: recall {m.recall}, "
                           f"precision {m.precision}")
    top = st["incidents"][0]
    heaviest = max(top.layer_deficit, key=top.layer_deficit.get)
    if heaviest not in PERTURBS:
        raise SmokeFailure(f"top incident's deficit lies mostly on "
                           f"{heaviest}, not operator or step: "
                           f"{top.layer_deficit}")
    if st["lost_batches"] or st["failed_samples"]:
        raise SmokeFailure(f"lost {st['lost_batches']} wire batches, "
                           f"{st['failed_samples']} device samples")


def check_nvalid_zero(ops):
    """nvalid = 0 with N > 0, on both sides of the specialised / general
    boundary: the reference multiplies every row's responsibilities by 0,
    so an all-NaN U or NaN rows make nk, sx and sxx NaN (its ll is 0), and
    finite inputs give zeros. The kernels must give NaN exactly where the
    plain version does and equal it elsewhere. Returns the cases."""
    import torch

    cases = 0
    for N, D, K in ((256, 4, 3), (300, 6, 5)):
        for poison in ("nan_u", "nan_rows", "finite"):
            X, log_w, means, U = em_inputs(N, D, K, 51 + D)
            if poison == "nan_u":
                U.fill_(float("nan"))
            elif poison == "nan_rows":
                X.fill_(float("nan"))
            for name in ("gmm_stats", "gmm_update"):
                fn = getattr(ops, name)
                want = fn(X, log_w, means, U, nvalid=0, backend="plain")
                got = fn(X, log_w, means, U, nvalid=0)
                for i, (g, w) in enumerate(zip(got, want)):
                    nan = torch.isnan(w)
                    if not (torch.equal(torch.isnan(g), nan)
                            and torch.equal(g[~nan], w[~nan])):
                        raise SmokeFailure(
                            f"{name} nvalid=0 {poison} N={N} D={D} K={K} "
                            f"output {i} differs from plain")
                if poison != "finite" and not bool(
                        torch.isnan(got[0]).all()):
                    raise SmokeFailure(f"{name} nvalid=0 {poison}: nk is "
                                       "not NaN")
                cases += 1
    torch.cuda.synchronize()
    return cases


# which injected fault kinds perturb a layer's rows on one card (the
# collective schedule is empty, so net_latency perturbs nothing; device
# telemetry faults perturb only the DEVICE rows)
PERTURBS = {"step": ("op_latency", "python_latency", "xla_latency"),
            "operator": ("op_latency",)}
SESSION_RUNS = (("off", 100), ("batch", 200), ("stream", 240))
# steps before the steady state: the graphed step's eager warm-up calls and
# its capture (`train/step.py::CudaGraphed`), hundreds of ms each
SETUP_STEPS = 3


def steady_steps_per_s(step_end_s):
    """Steps/s after the first SETUP_STEPS steps, so that runs of other
    lengths compare."""
    return ((len(step_end_s) - SETUP_STEPS)
            / (step_end_s[-1] - step_end_s[SETUP_STEPS - 1]))


def layer_rates(report, injector, steps):
    """Per layer of PERTURBS: the share of the steps of the faults that
    perturb it that it flagged (hit), of the fault-free steps it flagged
    (false), and the hit share over every injected step (hit_all)."""
    import numpy as np
    from repro_torch.core import FaultInjector

    labels = injector.labels(steps)
    clean = set(np.flatnonzero(~labels).tolist())
    out = {}
    for layer, kinds in PERTURBS.items():
        ls = report.layers.get(layer)
        if ls is None:
            out[layer] = None
            continue
        flagged = set(ls.anomalous_steps)
        seen = set(np.flatnonzero(FaultInjector(
            [f for f in injector.faults if f.kind in kinds]).labels(
                steps)).tolist())
        every = set(np.flatnonzero(labels).tolist())
        out[layer] = {
            "hit": len(flagged & seen) / max(len(seen), 1),
            "false": len(flagged & clean) / max(len(clean), 1),
            "hit_all": len(flagged & every) / max(len(every), 1),
            "fault_steps": len(seen)}
    return out


@contextlib.contextmanager
def runtime_leaks():
    """Count the runtime-probe rows written inside a detection zone or on
    the detection plane's worker thread while the block runs (the probe's
    row writer wrapped, and restored after). Yields the counts."""
    import threading

    from repro_torch.core.probes import runtime_probe
    from repro_torch.detect import in_detection_zone

    leaks = {"in_zone": 0, "on_worker": 0}
    record = runtime_probe.CudaRuntimeProbe._record

    def counted(self, call, t0, t1):
        leaks["in_zone"] += in_detection_zone()
        leaks["on_worker"] += threading.current_thread().name \
            == "eacgm-detect"
        record(self, call, t0, t1)

    runtime_probe.CudaRuntimeProbe._record = counted
    try:
        yield leaks
    finally:
        runtime_probe.CudaRuntimeProbe._record = record


TABLE1_BUDGET_S = 20.0


def table1_phase(cols, labels, device="cuda"):
    """Phase ``table1_path``: paper Table I's six baselines
    (`repro_torch.core.baselines`, NumPy/SciPy on the host) and the GMM (on
    the card) over the STEP-layer features of ``main_path``'s run, scored
    with `evaluate` against its injected op_latency windows. Features by
    the reference's protocol (`benchmarks/common.py::layer_train_eval`):
    per-name baselines fitted on the clean steps, every step scored. Each
    baseline is fitted on every step, supervised ones with the labels, at
    the labels' contamination (`tests/test_baselines.py`); the GMM on the
    clean steps at a 5% false-positive budget (`detect_with_gmm`). Gates:
    every detector fits, every score is finite, the phase takes at most
    TABLE1_BUDGET_S; F1 is reported, not gated."""
    import numpy as np

    from repro_torch.core.baselines import evaluate, make_detectors
    from repro_torch.core.detector import GMMDetector
    from repro_torch.core.events import Layer, select_columns
    from repro_torch.core.features import LayerFeaturizer

    t0 = time.perf_counter()
    n = len(labels)
    step = cols["step"]
    clean = (step >= 0) & (step < n)
    clean[clean] = ~labels[step[clean]]
    feat = LayerFeaturizer(Layer.STEP)
    clean_cols = select_columns(cols, clean)
    if feat.fit(clean_cols) is None:
        raise SmokeFailure("table1_path: no STEP rows in the clean steps")
    X_clean = feat.transform(clean_cols).X
    fs = feat.transform(cols)
    valid = fs.steps >= 0
    X = fs.X[valid]
    y = labels[np.clip(fs.steps[valid], 0, n - 1)].astype(bool)
    rows = {}
    for name, det in make_detectors(contamination=float(y.mean()),
                                    seed=0).items():
        t = time.perf_counter()
        try:
            det.fit(X, y.astype(float))
            scores = det.scores(X)
            rows[name] = {**evaluate(det.predict(X), y),
                          "finite": bool(np.isfinite(scores).all())}
        except Exception as e:  # a detector that cannot fit fails the gate
            rows[name] = {"error": repr(e)}
        rows[name]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    gmm = GMMDetector(n_components=4, contamination=0.05, seed=0,
                      device=device).fit(X_clean)
    scores = gmm.score(X)
    rows["GMM"] = {**evaluate(scores < gmm.log_delta, y),
                   "finite": bool(np.isfinite(scores).all()),
                   "seconds": time.perf_counter() - t}
    seconds = time.perf_counter() - t0
    emit({"phase": "table1_path", "rows": int(len(X)),
          "features": list(fs.names),
          "clean_rows": int(len(X_clean)), "anomalous": int(y.sum()),
          "detectors": rows, "seconds": seconds,
          "budget_s": TABLE1_BUDGET_S})
    bad = [k for k, r in rows.items() if "error" in r or not r["finite"]]
    if bad:
        raise SmokeFailure(f"table1_path: {bad} did not fit or gave "
                           f"non-finite scores: {rows}")
    if seconds > TABLE1_BUDGET_S:
        raise SmokeFailure(f"table1_path took {seconds:.1f} s, over "
                           f"{TABLE1_BUDGET_S} s")


def session_phase(train, reset_counts, read_counts, read_variants):
    """`repro_torch.launch.train` in-process at full width (GPT-2 124M,
    bf16, batch 8, sequence 128, --inject-faults), once per mode of
    SESSION_RUNS, with the launcher's legacy probe options (python 1-in-25,
    device every 0.05 s). The runtime probe's row writer is wrapped for the
    phase to count rows written inside a detection zone or on the detection
    plane's worker thread (both must be 0). Returns the phase's line; raises
    on a failed gate."""
    import torch

    t_phase = time.perf_counter()
    line = {"phase": "session_path", "modes": {}}
    with runtime_leaks() as leaks:
        for mode, steps in SESSION_RUNS:
            spec = {"mode": mode,
                    "probe_options": train.LEGACY_PROBE_OPTIONS}
            args = train.parser().parse_args(
                ["--arch", "gpt2", "--device", "cuda", "--steps", str(steps),
                 "--batch", "8", "--seq", "128", "--inject-faults",
                 "--log-every", "0", "--monitor-spec", json.dumps(spec)])
            reset_counts()
            out = train.train(args)
            launches, plain = read_counts()
            losses = out["losses"]
            if not all(math.isfinite(v) for v in losses):
                raise SmokeFailure(f"session_path {mode}: non-finite loss")
            res = {"steps": steps, "steps_per_s": out["steps_per_s"],
                   "steady_steps_per_s": steady_steps_per_s(
                       out["step_end_s"]),
                   "train_s": out["seconds"], "setup_s": out["setup_s"],
                   "finalize_s": out["finalize_s"],
                   "loss_first": losses[0], "loss_last": losses[-1]}
            if mode != "off":
                res.update(session_summary(out, mode, steps, launches, plain,
                                           read_variants(
                                               f"session_path {mode}")))
            line["modes"][mode] = res
            del out
            torch.cuda.empty_cache()
    # monitoring overhead in the steady state (the set-up steps apart)
    off = line["modes"]["off"]["steady_steps_per_s"]
    line["overhead"] = {
        mode: 1.0 - line["modes"][mode]["steady_steps_per_s"] / off
        for mode in ("batch", "stream")}
    line["runtime_rows_in_zone"] = leaks["in_zone"]
    line["runtime_rows_on_worker"] = leaks["on_worker"]
    line["seconds"] = time.perf_counter() - t_phase
    try:
        line["unmet"] = check_session(line)
    finally:
        emit(line)
    return line


def session_summary(out, mode, steps, launches, plain, variants):
    """One monitored mode of the session phase, as printed. The batch
    mode's verdict is its final detections (hit and false rates per layer);
    the stream mode's is its incidents, matched against the windows of the
    faults that perturb the operator and step layers (its final detections
    cover the last tick only)."""
    from repro_torch.core import FaultInjector
    from repro_torch.stream import match_incidents

    report, session = out["report"], out["session"]
    emitted = report.overhead[0]["emitted_per_probe"]
    xla = session.collector["xla"]
    injector = out["injector"]
    if mode == "batch":
        verdict = {"rates": layer_rates(report, injector, steps)}
    else:
        windows = FaultInjector([f for f in injector.faults
                                 if f.kind in PERTURBS["step"]]).windows()
        m = match_incidents(report.incidents, windows,
                            grace_steps=session.spec.detector.flush_every)
        verdict = {"match": {"windows": windows, "recall": m.recall,
                             "precision": m.precision,
                             "window_hits": m.window_hits,
                             "spurious": m.spurious}}
    return {
        "rows_per_layer": {k: v.events for k, v in report.layers.items()},
        "rows_per_probe": emitted, **verdict,
        "faults": [f.to_json() for f in injector.faults],
        "incidents": [
            {"id": i.incident_id, "suspect": i.suspect_layer.value,
             "heaviest": max(i.layer_deficit, key=i.layer_deficit.get),
             "severity": i.severity, "n_flags": i.n_flags,
             "steps": [min(i.steps), max(i.steps)] if i.steps else []}
            for i in sorted(report.incidents, key=lambda i: -i.severity)],
        "diagnoses": [{"incident": d.incident_id, "fault_kind": d.fault_kind,
                       "confidence": d.confidence, "action": d.action.kind}
                      for d in report.diagnoses],
        "governor_actions": session.action_counts(),
        "detect_plane": report.overhead.get("detect_plane"),
        "runtime_probe": {"rows": xla.emitted,
                          "dropped_in_zone": xla.dropped_in_zone},
        "launches": launches, "plain_calls": plain, "variants": variants}


def check_session(line):
    """The session phase's gates: the batch mode's STEP layer as the main
    path's (hit > 0.5 and > 2x false, against the faults that perturb it);
    OPERATOR and XLA rows in every monitored mode; its kernels launched, no
    plain version; no runtime row inside a detection zone or on the worker
    thread. One criterion is reported, not enforced: a governor action in
    the batch mode. The batch session forms incidents only past its final
    fit's clean prefix (the reference's `_batch_incidents` floor), and the
    governor's rate path acts above a 0.25 anomaly rate; a fault inside the
    prefix gives neither (``unmet`` in the line)."""
    if line["runtime_rows_in_zone"] or line["runtime_rows_on_worker"]:
        raise SmokeFailure(f"runtime-probe rows inside a detection zone: "
                           f"{line['runtime_rows_in_zone']}, on the worker: "
                           f"{line['runtime_rows_on_worker']}")
    for mode, want in (("batch", ("gmm_score", "gmm_best")),
                       ("stream", ("gmm_score", "gmm_best", "gmm_stats",
                                   "gmm_update"))):
        m = line["modes"][mode]
        if not all(m["launches"][k] for k in want):
            raise SmokeFailure(f"session_path {mode}: a kernel was not "
                               f"launched: {m['launches']}")
        if any(m["plain_calls"].values()):
            raise SmokeFailure(f"session_path {mode}: plain versions ran: "
                               f"{m['plain_calls']}")
        rows = m["rows_per_probe"]
        if not (rows["operator"] and rows["xla"]
                and m["runtime_probe"]["rows"]):
            raise SmokeFailure(f"session_path {mode}: no operator or "
                               f"runtime rows: {rows}")
    b = line["modes"]["batch"]
    step = b["rates"]["step"]
    if step is None or not (step["hit"] > 0.5
                            and step["hit"] > 2 * step["false"]):
        raise SmokeFailure(f"session_path batch: STEP detection too weak: "
                           f"{step}")
    return [] if (b["governor_actions"] or b["diagnoses"]) else [
        "batch: a governor action (none: no incident past the final fit's "
        "prefix, layer anomaly rates under the governor's 0.25)"]


# the fleet phase's second pass: the backpressure governor armed with a
# budget below one node's events per flush (24 operator rows a step alone
# make 384 a 16-step flush)
SHED_TOPOLOGY = {"group_size": 4, "fan_in": 32, "max_events_per_flush": 256}
FLEET_KERNELS = ("gmm_score", "gmm_best", "gmm_update")
FAMILIES = ("isoforest", "mad", "spectral")
FAMILY_STEPS = 160


def fleet_phase(quickstart, reset_counts, read_counts, read_all_variants):
    """`repro_torch.quickstart.run_fleet` on the card at full width: 8
    nodes in 2 groups of 4, each node its own GPT-2 124M (bf16, batch 8,
    sequence 128), 80 warm-up and 160 live steps, an op_latency fault of
    0.02 s on node 1 over live steps 60-100. Counts are set to 0 just before
    and read just after. Then a second, shorter pass (4 nodes, one group,
    32 + 64 steps, no fault) with the backpressure governor armed
    (`SHED_TOPOLOGY`). Prints the phase's line, then checks its gates
    (`check_fleet`); returns the line."""
    import torch

    t_phase = time.perf_counter()
    with runtime_leaks() as leaks:
        reset_counts()
        out = quickstart.run_fleet(device="cuda")
        launches, plain = read_counts()
        variants = read_all_variants()
    stats = out["stats"]
    incidents = [{"id": i.incident_id, "suspect": i.suspect_layer.value,
                  "nodes": i.suspect_nodes, "severity": i.severity,
                  "heaviest": max(i.layer_deficit, key=i.layer_deficit.get),
                  "steps": [min(i.steps), max(i.steps)] if i.steps else []}
                 for i in out["incidents"]]
    faulty = {quickstart.FLEET_FAULT_NODE}
    line = {
        "phase": "fleet_path", "nodes": out["nodes"], "batch": out["batch"],
        "seq": out["seq"], "warmup_steps": out["warmup_steps"],
        "extra_warmup_steps": out["extra_warmup_steps"],
        "live_steps": out["live_steps"], "fault_steps": out["fault_steps"],
        "losses_finite": {nid: bool(all(math.isfinite(float(v)) for v in l))
                          for nid, l in out["losses"].items()},
        "loss_last": {nid: float(l[-1]) for nid, l in out["losses"].items()},
        "steps_per_s": out["steps_per_s"],
        "node_steps_per_s": out["node_steps_per_s"],
        "register_s": out["register_s"], "warmup_s": out["warmup_s"],
        "live_s": out["live_s"], "groups": out["groups"],
        "warmed_layers": out["warmed_layers"],
        "tiers": stats["tiers"],
        "per_group_seconds": {
            gid: {"ingest": g["ingest_seconds"], "detect": g["detect_seconds"]}
            for gid, g in stats["groups"].items()},
        "ticks": stats["ticks"],
        "detect_ms_per_tick": stats["detect_ms_per_tick"],
        "events_ingested": stats["aggregator"]["events_ingested"],
        "window_sizes": stats["aggregator"]["window_sizes"],
        "lost_batches": stats["aggregator"]["lost_batches"],
        "incidents": incidents,
        "hits": [i.incident_id for i in out["hits"]],
        "runtime_rows_per_node": out["runtime_rows"],
        "runtime_rows_in_zone": leaks["in_zone"],
        "runtime_rows_on_worker": leaks["on_worker"],
        "failed_samples": out["failed_samples"],
        "peak_memory_gb": out["peak_memory_bytes"] / 2**30,
        "launches": launches, "plain_calls": plain, "variants": variants}
    events_per_flush = {nid: a["events_shipped"] / max(a["flushes"], 1)
                        for nid, a in stats["agents"].items()}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    shed = quickstart.run_fleet(device="cuda", nodes=4, warmup_steps=32,
                                live_steps=64, fault_s=0.0,
                                topology=SHED_TOPOLOGY)
    sst = shed["stats"]
    line["shed_pass"] = {
        "nodes": shed["nodes"], "topology": SHED_TOPOLOGY,
        "steps": shed["warmup_steps"] + shed["extra_warmup_steps"]
        + shed["live_steps"],
        "first_pass_events_per_node_flush": events_per_flush,
        "events_shed_agents": sst["events_shed"],
        "events_shed_wire": sst["aggregator"]["events_shed_at_source"],
        "events_ingested": sst["aggregator"]["events_ingested"],
        "lost_batches": sst["aggregator"]["lost_batches"],
        "budgets": {nid: a["governor_budget"]
                    for nid, a in sst["agents"].items()},
        "losses_finite": bool(all(math.isfinite(float(v))
                                  for l in shed["losses"].values()
                                  for v in l)),
        "steps_per_s": shed["steps_per_s"]}
    del shed
    gc.collect()
    torch.cuda.empty_cache()
    line["unmet"] = [
        *([] if incidents and incidents[0]["suspect"] == "operator" else
          [f"the top incident's suspect layer is operator: "
           f"{incidents[0]['suspect'] if incidents else None}"]),
        *([f"an incident names only clean nodes: {i}" for i in incidents
           if not faulty & set(i["nodes"])]),
        *([f"device samples failed: {line['failed_samples']}"]
          if any(line["failed_samples"].values()) else [])]
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    check_fleet(line)
    return line


def check_fleet(line):
    """The fleet phase's gates: finite losses on every node; 2 groups of 4,
    all warmed; the group detectors launched gmm_score, gmm_best and
    gmm_update, only specialised variants, no plain call; no lost batch; no
    runtime row in a detection zone or on the worker; an incident holding
    node 1 over the fault's steps. The shedding pass: finite losses, no lost
    batch, the governor shed, and the wire's shed count equals the agents'.
    What the reference's design does not guarantee (the top incident's
    suspect layer, no incident on clean nodes only, device samples on a host
    with 8 samplers) is listed under ``unmet``, not enforced."""
    if not all(line["losses_finite"].values()):
        raise SmokeFailure(f"fleet_path: non-finite loss: "
                           f"{line['losses_finite']}")
    groups = line["groups"]
    if sorted(len(g["nodes"]) for g in groups.values()) != [4, 4] or not all(
            g["warmed"] for g in groups.values()):
        raise SmokeFailure(f"fleet_path: not 2 warmed groups of 4: {groups}")
    if not all(line["launches"][k] for k in FLEET_KERNELS):
        raise SmokeFailure(f"fleet_path: a kernel was not launched: "
                           f"{line['launches']}")
    if any(v["general"] for v in line["variants"].values()):
        raise SmokeFailure(f"fleet_path launched a general kernel: "
                           f"{line['variants']}")
    if any(line["plain_calls"].values()):
        raise SmokeFailure(f"fleet_path: plain versions ran: "
                           f"{line['plain_calls']}")
    if line["lost_batches"]:
        raise SmokeFailure(f"fleet_path: {line['lost_batches']} lost batches")
    if line["runtime_rows_in_zone"] or line["runtime_rows_on_worker"]:
        raise SmokeFailure(f"fleet_path: runtime-probe rows inside a "
                           f"detection zone: {line['runtime_rows_in_zone']}, "
                           f"on the worker: {line['runtime_rows_on_worker']}")
    if not line["hits"]:
        raise SmokeFailure(f"fleet_path: no incident holds node 1 over steps "
                           f"{line['fault_steps']}: {line['incidents']}")
    sp = line["shed_pass"]
    if not sp["losses_finite"] or sp["lost_batches"]:
        raise SmokeFailure(f"fleet_path shedding pass: {sp}")
    if not (sp["events_shed_agents"] > 0
            and sp["events_shed_wire"] == sp["events_shed_agents"]):
        raise SmokeFailure(f"fleet_path shedding pass: shed on the wire "
                           f"{sp['events_shed_wire']}, by the agents "
                           f"{sp['events_shed_agents']}")


def families_phase(train, reset_counts, read_counts, off_steady):
    """`repro_torch.launch.train` in-process at full width in stream mode
    with ``--inject-faults`` and the session_path's probe options, once per
    NumPy detector family (isoforest, mad, spectral), FAMILY_STEPS steps
    each. Per family: steps/s, the steady rate's overhead against the
    session_path's unmonitored steady rate (``off_steady``), the incidents
    against the injected fault windows (with the launcher's seed-0 schedule
    over 160 steps: hw_contention, which perturbs the device layer, and
    net_latency, which perturbs nothing on one card), the warmed layers and
    those the last tick detected on, GMM launches and plain calls (both
    must be 0). Prints the line, then checks its gates:
    finite loss, a detection for every warmed layer, no lost batch, no GMM
    kernel and no plain GMM call."""
    import torch

    from repro_torch.stream import match_incidents

    t_phase = time.perf_counter()
    line = {"phase": "families_path", "steps": FAMILY_STEPS, "families": {}}
    for family in FAMILIES:
        spec = {"mode": "stream", "detector": {"backend": family},
                "probe_options": train.LEGACY_PROBE_OPTIONS}
        args = train.parser().parse_args(
            ["--arch", "gpt2", "--device", "cuda", "--steps",
             str(FAMILY_STEPS), "--batch", "8", "--seq", "128",
             "--inject-faults", "--log-every", "0",
             "--monitor-spec", json.dumps(spec)])
        t0 = time.perf_counter()
        reset_counts()
        out = train.train(args)
        launches, plain = read_counts()
        report, session = out["report"], out["session"]
        mon = session.detector.monitor
        injector = out["injector"]
        windows = injector.windows()
        m = match_incidents(report.incidents, windows,
                            grace_steps=session.spec.detector.flush_every)
        steady = steady_steps_per_s(out["step_end_s"])
        line["families"][family] = {
            "losses_finite": all(math.isfinite(v) for v in out["losses"]),
            "loss_last": out["losses"][-1],
            "steps_per_s": out["steps_per_s"], "steady_steps_per_s": steady,
            "overhead_vs_off": 1.0 - steady / off_steady,
            "warmed": sorted(l.value for l in mon.detector.states),
            "detected": sorted(l.value for l in mon.last_detections),
            "lost_batches": mon.stats()["aggregator"]["lost_batches"],
            "faults": [f.to_json() for f in injector.faults],
            "windows": windows, "recall": m.recall,
            "precision": m.precision, "window_hits": m.window_hits,
            "spurious": m.spurious,
            "incidents": [
                {"suspect": i.suspect_layer.value, "nodes": i.suspect_nodes,
                 "severity": i.severity,
                 "steps": [min(i.steps), max(i.steps)] if i.steps else []}
                for i in sorted(report.incidents, key=lambda i: -i.severity)],
            "gmm_launches": launches, "plain_calls": plain,
            "seconds": time.perf_counter() - t0}
        del out, report, session, mon
        gc.collect()
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    for family, r in line["families"].items():
        if not r["losses_finite"]:
            raise SmokeFailure(f"families_path {family}: non-finite loss")
        if not r["warmed"] or r["detected"] != r["warmed"]:
            raise SmokeFailure(f"families_path {family}: warmed layers "
                               f"{r['warmed']}, detected {r['detected']}")
        if r["lost_batches"]:
            raise SmokeFailure(f"families_path {family}: "
                               f"{r['lost_batches']} lost batches")
        if any(r["gmm_launches"].values()) or any(r["plain_calls"].values()):
            raise SmokeFailure(f"families_path {family}: GMM kernels "
                               f"{r['gmm_launches']} or plain calls "
                               f"{r['plain_calls']} ran")
    return line


# the eval phase: pass B's scenarios (latency_spike is left out: main_path
# and stream_path measure op_latency at full width), its steps, the modes
EVAL_B_SCENARIOS = ("clean_control", "runtime_stall", "comm_slowdown",
                    "degraded_device", "memory_leak")
EVAL_STEPS = 240
EVAL_MODES = ("batch", "stream")
EVAL_KERNELS = {"batch": ("gmm_score", "gmm_best"), "stream": ("gmm_update",)}


def tally(totals, launches, variants):
    """Add one run's launches and variants into ``totals``."""
    for k, v in launches.items():
        totals["launches"][k] = totals["launches"].get(k, 0) + v
    for k, v in variants.items():
        tv = totals["variants"].setdefault(k, {"specialised": 0,
                                               "general": 0})
        for kk in tv:
            tv[kk] += v[kk]


def eval_cell_extras(session, step_s, counts):
    """What a ScenarioRun's report does not keep, read off the cell's
    session: rows each probe emitted, the runtime probe's rows, failed
    device samples, the monitored step's wall ms (p50, p90) from
    ``step_s``, the cell's launches, plain calls and variants, and the
    flagged steps per layer."""
    import numpy as np

    emitted = session.collector.overhead_stats()["emitted_per_probe"]
    launches, plain, variants = counts
    report = session.result()
    return {"rows_per_probe": emitted,
            "runtime_rows": session.collector["xla"].emitted,
            "failed_samples": session.collector["device"].failed_samples,
            "step_ms_p50_p90": (np.percentile(1e3 * np.asarray(step_s),
                                              [50, 90]).tolist()
                                if step_s else None),
            "launches": launches, "plain_calls": plain,
            "variants": variants,
            "flagged_steps": {k: [int(x) for x in v.anomalous_steps]
                              for k, v in report.layers.items()}}


@contextlib.contextmanager
def watched_cell(session, reset_counts, read_counts, read_all_variants):
    """For the block: each call of the step that ``session.observe_step_fn``
    returns timed, and the launch counts set to 0 before and read after
    (the session's finalise, inside the block, included). Yields a dict
    that holds ``extras`` once the block has run."""
    step_s = []
    observe = session.observe_step_fn

    def timed_observe(fn, **kw):
        monitored = observe(fn, **kw)

        def call(*a):
            t0 = time.perf_counter()
            out = monitored(*a)
            step_s.append(time.perf_counter() - t0)
            return out
        return call

    session.observe_step_fn = timed_observe
    cell = {}
    reset_counts()
    try:
        yield cell
    finally:
        counts = (*read_counts(), read_all_variants())
        session.observe_step_fn = observe
    cell["extras"] = eval_cell_extras(session, step_s, counts)


def eval_cell_line(pass_name, row, extras):
    """One cell's printed line: the matrix row's scores beside the
    extras."""
    m = row["metrics"]
    dg = row.get("diagnosis", {})
    return {
        "phase": "eval_cell", "pass": pass_name, "scenario": row["scenario"],
        "mode": row["mode"], "f1": m["f1"],
        "false_alarm_rate": m["false_alarm_rate"],
        "faults": f"{m['faults_detected']}/{m['faults_total']}",
        "fault_recall": m["fault_recall"], "ttd_steps": m["ttd_steps"],
        "detect_ms_per_window": row["detect_ms_per_window"],
        "wall_s": row["wall_s"],
        "expected_layers": {
            name: (row["layers"][name]["anomaly_rate"]
                   if name in row["layers"] else None)
            for name in row["expected_layers"]},
        "anomaly_rates": {k: v["anomaly_rate"]
                          for k, v in row["layers"].items()},
        "layer_rows": {k: v["events"] for k, v in row["layers"].items()},
        "incidents": row.get("incidents"),
        "diagnoses": dg.get("kinds"), "kind_accuracy": dg.get("kind_accuracy"),
        **extras}


def check_eval_cell(where, line, n_msgs):
    """The gates every eval cell holds."""
    mode = line["mode"]
    if not all(line["launches"][k] for k in EVAL_KERNELS[mode]):
        raise SmokeFailure(f"{where}: a kernel was not launched: "
                           f"{line['launches']}")
    if any(v["general"] for v in line["variants"].values()):
        raise SmokeFailure(f"{where} launched a general kernel: "
                           f"{line['variants']}")
    if any(line["plain_calls"].values()):
        raise SmokeFailure(f"{where}: plain versions ran: "
                           f"{line['plain_calls']}")
    want = n_msgs * (EVAL_STEPS + 1)  # registration + one row a message a step
    got = line["rows_per_probe"].get("collective")
    if got != want or line["layer_rows"].get("collective") != \
            n_msgs * EVAL_STEPS:
        raise SmokeFailure(f"{where}: COLLECTIVE rows {got} emitted, "
                           f"{line['layer_rows'].get('collective')} detected,"
                           f" not {want} and {n_msgs * EVAL_STEPS}")
    if line["failed_samples"]:
        raise SmokeFailure(f"{where}: {line['failed_samples']} failed device "
                           "samples")


def eval_pass_a(reset_counts, read_counts, read_all_variants):
    """Pass A: the reference's CI gate (`repro_torch.launch.evaluate
    --scenarios smoke --modes batch,stream`) on the card, called in this
    process (the smoke's child, `isolated`), each cell's session watched
    through the runner's train workload. Returns
    the pass's line and the cells' lines."""
    from repro_torch.eval import runner
    from repro_torch.launch import evaluate

    out_dir = os.path.join(ROOT, "results", "eval_smoke")
    inner = runner._run_train_steps
    cells = []

    def watched(session, *a):
        with watched_cell(session, reset_counts, read_counts,
                          read_all_variants) as cell:
            step_ts = inner(session, *a)
        cells.append(cell["extras"])
        return step_ts

    t0 = time.perf_counter()
    runner._run_train_steps = watched
    try:
        with runtime_leaks() as leaks:
            rc = evaluate.main(["--scenarios", "smoke", "--modes",
                                "batch,stream", "--device", "cuda", "--out",
                                out_dir])
    finally:
        runner._run_train_steps = inner
    with open(os.path.join(out_dir, "scenario_matrix.json")) as f:
        mx = json.load(f)
    lines = [eval_cell_line("A", row, extras)
             for row, extras in zip(mx["rows"], cells)]
    return {"rc": rc, "matrix": mx, "leaks": leaks,
            "seconds": time.perf_counter() - t0}, lines


def eval_pass_b(reset_counts, read_counts, read_all_variants):
    """Pass B: EVAL_B_SCENARIOS x EVAL_MODES at 240 steps, each cell
    `runner.run_model_cell` under a session of `runner.scenario_spec`,
    scored by `matrix._row`, around the full-width GPT-2 124M step (bf16,
    batch 8, sequence 128, CUDA-graphed), built once by
    `quickstart._workload`, its set-up calls made before the first cell,
    and shared by every cell. Returns the pass's
    line and the cells' lines."""
    import torch

    from repro_torch import quickstart
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import matrix, runner
    from repro_torch.models.model import batch_to_device
    from repro_torch.session import Session

    t_pass = time.perf_counter()
    dev = torch.device("cuda")
    cells = len(EVAL_B_SCENARIOS) * len(EVAL_MODES)
    batch, seq, data, state, step_fn = quickstart._workload(
        False, dev, cells * EVAL_STEPS + quickstart.SETUP_STEPS)
    for s in range(quickstart.SETUP_STEPS):  # graph capture, first use
        state, _ = step_fn(state, batch_to_device(data.batch(s), dev))
    torch.cuda.synchronize()
    cfg = runner.EvalConfig()
    rows, cells_out, finite = [], [], True
    with runtime_leaks() as leaks:
        for name in EVAL_B_SCENARIOS:
            scenario = get_scenario(name)
            for mode in EVAL_MODES:
                session = Session(runner.scenario_spec(
                    scenario, mode, EVAL_STEPS, cfg, seed=0), device=dev)
                with watched_cell(session, reset_counts, read_counts,
                                  read_all_variants) as cell:
                    run, state, metrics = runner.run_model_cell(
                        session, scenario, EVAL_STEPS, cfg, step_fn, state,
                        data)
                row = matrix._row(run)
                rows.append(row)
                loss = torch.stack([m["loss"] for m in metrics]).float().cpu()
                finite &= bool(torch.isfinite(loss).all())
                cells_out.append((row, cell["extras"], float(loss[-1])))
                del session, run, metrics
                gc.collect()
    lines = []
    for row, extras, loss_last in cells_out:
        lines.append(eval_cell_line("B", row, extras))
        lines[-1]["loss_last"] = loss_last
    mx = {"n_steps": EVAL_STEPS, "seed": 0, "modes": list(EVAL_MODES),
          "configs": {"default": matrix._config_json(cfg)},
          "far_ceiling": matrix.FAR_CEILING, "rows": rows,
          "winners": matrix.crown_winners(rows)}
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"matrix": mx, "leaks": leaks, "losses_finite": finite,
            "batch": batch, "seq": seq,
            "seconds": time.perf_counter() - t_pass}, lines


# the nvml phase: pass B's cells of these scenarios, batch mode, with the
# device probe's nvml source
NVML_SCENARIOS = ("clean_control", "degraded_device", "memory_leak")
NVML_INJECTED_GB = 0.5  # fault windows' mean mem_gb over the rest, at least


def nvml_phase(reset_counts, read_counts, read_all_variants):
    """``--nvml-path OUT``: NVML_SCENARIOS as pass B builds its cells
    (`eval_pass_b`: the full-width GPT-2 step, 240 steps, batch mode), the
    DEVICE rows from the card through NVML in the sampler process
    (``probe_options={"device": {"source": "nvml"}}``). Per cell: the
    scores, the DEVICE layer's anomaly rate and the mean readings inside
    and outside the fault windows. Returns the line; `check_nvml` gates it:
    every DEVICE row from NVML, no failed sample, the card's power limit as
    nvidia-smi gives it, readings a card can give, and each faulted cell's
    injection visible in its rows (the fault is injected into the
    readings, as DCGM's error injection does; it does not load the card).
    The clean cell's FAR and diagnoses are reported, not gated."""
    import numpy as np
    import torch

    from repro_torch import quickstart
    from repro_torch.core.chaos import get_scenario
    from repro_torch.core.probes.device_probe import DeviceProbe
    from repro_torch.eval import matrix, runner
    from repro_torch.models.model import batch_to_device
    from repro_torch.session import Session

    t_phase = time.perf_counter()
    rows_seen = []  # (step, util, mem_gb, power_w, temp_c) of gpu0 rows
    emit_rows = DeviceProbe._emit

    def kept(self, recs):
        ok = recs[recs["status"] == 0]
        idx = np.searchsorted(self._mark_t, ok["ts"], side="right") - 1
        steps = np.asarray(self._mark_n)[idx]
        rows_seen.extend([n, *t] for n, t in zip(
            steps.tolist(), ok["tele"][:, 0, :].tolist()))
        return emit_rows(self, recs)

    DeviceProbe._emit = kept
    dev = torch.device("cuda")
    batch, seq, data, state, step_fn = quickstart._workload(
        False, dev, len(NVML_SCENARIOS) * EVAL_STEPS + quickstart.SETUP_STEPS)
    for s in range(quickstart.SETUP_STEPS):  # graph capture, first use
        state, _ = step_fn(state, batch_to_device(data.batch(s), dev))
    torch.cuda.synchronize()
    cfg = runner.EvalConfig()
    cells = []
    for name in NVML_SCENARIOS:
        scenario = get_scenario(name)
        spec = runner.scenario_spec(scenario, "batch", EVAL_STEPS, cfg,
                                    seed=0)
        spec.probe_options["device"]["source"] = "nvml"
        session = Session(spec, device=dev)
        del rows_seen[:]
        t0 = time.perf_counter()
        run, state, metrics = runner.run_model_cell(
            session, scenario, EVAL_STEPS, cfg, step_fn, state, data)
        row = matrix._row(run)
        probe = session.collector["device"]
        seen = np.asarray(rows_seen, dtype=np.float64).reshape(-1, 5)
        inside = np.isin(seen[:, 0], np.flatnonzero(run.labels))
        mean = {k: [float(seen[inside, i].mean()) if inside.any() else None,
                    float(seen[~inside, i].mean()) if (~inside).any()
                    else None]
                for i, k in enumerate(("util", "mem_gb", "power_w",
                                       "temp_c"), start=1)}
        m = row["metrics"]
        cells.append({
            "scenario": name, "f1": m["f1"],
            "false_alarm_rate": m["false_alarm_rate"],
            "faults": f"{m['faults_detected']}/{m['faults_total']}",
            "diagnoses": row.get("diagnosis", {}).get("kinds"),
            "device_anomaly_rate": row["layers"].get("device", {}).get(
                "anomaly_rate"),
            "device_rows": int(len(seen)), "rows_in_faults": int(inside.sum()),
            "mean_in_out_of_faults": mean, "probe": probe.stats(),
            "loss_last": float(metrics[-1]["loss"]),
            "seconds": time.perf_counter() - t0})
        del session, run, metrics
        gc.collect()
    DeviceProbe._emit = emit_rows
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "nvml_path", "mode": "batch", "steps": EVAL_STEPS,
            "batch": batch, "seq": seq, "cells": cells,
            "seconds": time.perf_counter() - t_phase}


def check_nvml(line, power_limit_w) -> None:
    """The gates of ``nvml_path`` (`nvml_phase`)."""
    for c in line["cells"]:
        where = f"nvml_path {c['scenario']}"
        st = c["probe"]
        if st["source"] != "nvml" or st["failed_samples"]:
            raise SmokeFailure(f"{where}: source {st['source']}, "
                               f"{st['failed_samples']} failed samples "
                               f"({st['last_error']})")
        if not st["power_limit_w"] or \
                abs(st["power_limit_w"][0] - power_limit_w) > 1.0:
            raise SmokeFailure(f"{where}: NVML's power limit "
                               f"{st['power_limit_w']}, nvidia-smi's "
                               f"{power_limit_w}")
        lo_hi = st["reading_min_max"]
        sane = {"util": (0.0, 100.0), "mem_gb": (0.0, 81.0),
                "power_w": (1.0, power_limit_w + 50.0),
                "temp_c": (5.0, 100.0)}
        bad = {k: lo_hi.get(k) for k, (a, b) in sane.items()
               if k not in lo_hi or lo_hi[k][0] < a or lo_hi[k][1] > b}
        if bad or not c["device_rows"]:
            raise SmokeFailure(f"{where}: readings out of range {bad} or "
                               f"no rows ({c['device_rows']})")
        if c["scenario"] != "clean_control":
            inside, outside = c["mean_in_out_of_faults"]["mem_gb"]
            if inside is None or inside < outside + NVML_INJECTED_GB:
                raise SmokeFailure(
                    f"{where}: the injection did not reach the readings: "
                    f"mem_gb {inside} in the fault windows, {outside} out")


def child_main(flag, out_path, *extra) -> int:
    """``chip_smoke.py FLAG OUT [ARG]``: one of `CHILDREN` alone, in a
    process of its own, with TF32 off as in `main`; what it returns is
    written to OUT as JSON."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    watch_device_probes()
    got = CHILDREN[flag](*counters(), *extra)
    with open(out_path, "w") as f:  # NumPy scalars as Python numbers
        json.dump(got, f, default=lambda o: o.item())
    with open(out_path + ".device.json", "w") as f:  # not yet reported
        json.dump(DEVICE_RUNS, f)
    return 0


def isolated(flag, what, timeout=600):
    """Run ``chip_smoke.py FLAG OUT`` (`child_main`) and return what it
    wrote, its printed lines passed on. The child's CUDA context has run
    nothing on a second stream: kernels on a second stream (the thread
    executor's sweeps in ``session_path`` and ``families_path``) move a
    context's graph replays between two levels ~5% apart, and the context
    may move again at a random later time (scripts/step_levels.py); such a
    move inside a clean control is a false alarm. The counts are set to 0
    and read in the child."""
    out = os.path.join(ROOT, "results", f"{flag.strip('-')}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                           out], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    adopt_device_runs(out)
    if proc.returncode or not os.path.exists(out):
        raise SmokeFailure(f"{what}: its process exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    with open(out) as f:
        got = json.load(f)
    if isinstance(got, dict):  # the child's start-up and exit included
        got["process_s"] = wall
    return got


def eval_phase():
    """Phase ``eval_path``: pass A, then pass B (`eval_pass_a`,
    `eval_pass_b`), each in a process of its own (`isolated`), each cell's
    line printed, then one line a pass; then the gates. Returns the launches
    and variants summed over every cell."""
    from repro_torch.core.probes.collective_probe import parse_hlo_collectives
    from repro_torch.eval import matrix, runner

    n_msgs = len(parse_hlo_collectives(runner._FAKE_HLO))
    totals = {"launches": {}, "variants": {}}
    passes = {}
    for name in ("A", "B"):
        res, lines = isolated(f"--eval-pass-{name.lower()}",
                              f"eval_path pass {name}")
        for line in lines:
            emit(line)
            tally(totals, line["launches"], line["variants"])
        mx = res["matrix"]
        far = matrix.clean_control_far(mx)
        acc = matrix.mean_kind_accuracy(mx)
        a_clean = [l for l in lines if l["scenario"] == "clean_control"]
        summary = {
            "phase": "eval_path", "pass": name, "cells": len(lines),
            "steps": EVAL_STEPS, "clean_control_far": far,
            "far_ceiling": matrix.FAR_CEILING,
            "clean_control_diagnoses": matrix.clean_control_diagnoses(mx),
            "mean_kind_accuracy": acc,
            "winners": [{"kind": w["kind"], "mode": w["mode"],
                         "f1": w["winner"]["f1"]} for w in mx["winners"]],
            "clean_step_ms_p50_p90": {l["mode"]: l["step_ms_p50_p90"]
                                      for l in a_clean},
            "runtime_rows_in_zone": res["leaks"]["in_zone"],
            "runtime_rows_on_worker": res["leaks"]["on_worker"],
            "seconds": res["seconds"], "unmet": []}
        if name == "A":
            summary["rc"] = res["rc"]
        else:
            summary.update(batch=res["batch"], seq=res["seq"],
                           losses_finite=res["losses_finite"])
            if acc is not None and acc < 0.5:
                summary["unmet"].append(
                    f"mean blamed-kind accuracy {acc} under the reference's "
                    "--min-kind-acc 0.5 (ROADMAP §3)")
            summary["clean_control_far_by_mode"] = {
                l["mode"]: l["false_alarm_rate"] for l in a_clean}
        emit(summary)
        passes[name] = (summary, lines)
    for name, (summary, lines) in passes.items():
        where = f"eval_path pass {name}"
        for line in lines:
            check_eval_cell(f"{where} {line['scenario']} {line['mode']}",
                            line, n_msgs)
        if summary["runtime_rows_in_zone"] or summary["runtime_rows_on_worker"]:
            raise SmokeFailure(f"{where}: runtime-probe rows inside a "
                               f"detection zone: {summary}")
    a = passes["A"][0]
    if a["rc"]:
        raise SmokeFailure(f"eval_path pass A: the evaluator exited "
                           f"{a['rc']} (clean-control FAR "
                           f"{a['clean_control_far']}, diagnoses "
                           f"{a['clean_control_diagnoses']}, mean kind "
                           f"accuracy {a['mean_kind_accuracy']})")
    b = passes["B"][0]
    if not b["losses_finite"]:
        raise SmokeFailure("eval_path pass B: non-finite training loss")
    if b["clean_control_diagnoses"] != 0:
        raise SmokeFailure(f"eval_path pass B: "
                           f"{b['clean_control_diagnoses']} diagnoses on the "
                           "clean control")
    for l in passes["B"][1]:
        if l["scenario"] == "clean_control" and \
                l["false_alarm_rate"] >= matrix.FAR_CEILING:
            raise SmokeFailure(
                f"eval_path pass B: {l['mode']} clean-control FAR "
                f"{l['false_alarm_rate']} not under {matrix.FAR_CEILING}; "
                f"STEP rows flagged at {l['flagged_steps'].get('step')}")
    return totals


# the serve phase: part a's engines, part b's launcher runs, part d's cells
SERVE_SLO = {"ttft_s": 0.4, "queue_wait_s": 0.2}
SERVE_REQUESTS = 64
SERVE_MODES = ("off", "batch", "stream")
SERVE_KERNELS = {"batch": ("gmm_score", "gmm_best"), "stream": ("gmm_update",)}
SERVE_D_SCENARIOS = ("serve_latency_spike", "serve_runtime_stall",
                     "serve_degraded_device")
SERVE_TOL_F32 = 1e-4  # tests/test_torch_model.py's float32 decode rtol/atol
DECODE_T, DECODE_JOIN = 32, 8  # part a's decode positions, lane 1's join


def graphed_vs_eager(cfg, rt, params):
    """Part a's first check: one request stream through two 4-slot engines
    on the card, the slot step replayed as a CUDA graph in one and eager in
    the other; a ``max_len`` of 40 forces an epoch reset. Every step's
    logits and every token must be bitwise equal."""
    import torch

    from repro_torch.serve import (ContinuousBatchingEngine, LoadGenerator,
                                   RequestQueue, VirtualClock)

    runs = []
    for graphed in (True, False):
        eng = ContinuousBatchingEngine(cfg, rt, params, slots=4, max_len=40,
                                       seed=0, clock=VirtualClock(0.02))
        step = eng._step_fn  # the engine's GraphedStep
        if not graphed:
            step.WARMUP = 1 << 30  # every call eager
        logits = []

        def kept(*a, step=step, logits=logits):
            out = step(*a)
            logits.append(out[0][:, -1].float().clone())
            return out

        eng._step_fn = kept
        load = LoadGenerator(rate=0.6, num_requests=16, seed=3,
                             prompt_len=(3, 8), max_new=(4, 10),
                             vocab_size=cfg.vocab_size)
        eng.run(load, queue=RequestQueue())
        torch.cuda.synchronize()
        runs.append((eng, step, torch.stack(logits)))
    (g, gstep, lg), (e, _, le) = runs
    same = (lg == le).all(dim=(1, 2))
    return {"steps": int(lg.shape[0]), "captured": gstep.graph is not None,
            "replays": gstep.replays,
            "joins": sum(r.start_index > 0 for r in g.finished),
            "epoch_resets": g.scheduler.epoch_resets,
            "bitwise_equal_steps": int(same.sum()),
            "max_abs_diff": float((lg - le).abs().max()),
            "tokens_equal": [r.tokens for r in g.finished]
            == [r.tokens for r in e.finished],
            "nonfinite_steps": g.nonfinite_steps + e.nonfinite_steps}


def decode_runtime(dtype, cf=None):
    """A Runtime computing in ``dtype``, its MoE capacity factor ``cf``
    (None: the default)."""
    import dataclasses

    from repro_torch.models.model import Runtime

    rt = Runtime(compute_dtype=dtype)
    return rt if cf is None else dataclasses.replace(
        rt, moe_capacity_factor=cf)


def slot_decode(cfg, params, dtype, x, index_of, starts, joins, cf=None,
                graphed=True, max_len=None):
    """Teacher-forced decode of ``x`` (lanes, T) token ids, or (lanes, T,
    d_model) frame embeddings, through the continuous engine's slot step
    (`make_slot_step`), replayed as a CUDA graph (`GraphedStep`; every call
    eager with ``graphed`` false) over caches of ``max_len`` (default T)
    rows in ``dtype`` with ``dtype`` compute (MoE capacity factor ``cf``,
    default the Runtime's): step ``t`` feeds column ``t`` at index
    ``index_of(t)`` with ``starts[t]`` and ``joins[t]``. Embeddings reach
    the graph through a device buffer it reads, filled before each call.
    Returns the logits (lanes, T, V) in float32 and the step's replay
    count."""
    import numpy as np
    import torch

    from repro_torch.models.model import init_decode_caches
    from repro_torch.serve.continuous import make_slot_step
    from repro_torch.serve.engine import GraphedStep

    lanes, T = x.shape[:2]
    dev = next(iter(params.values())).device
    caches = init_decode_caches(cfg, lanes, max_len or T, dtype=dtype,
                                device=dev)
    slot = make_slot_step(cfg, decode_runtime(dtype, cf))
    if cfg.input_mode == "tokens":
        def inputs(tok):
            return {"tokens": tok}
    else:
        emb = torch.zeros((lanes, 1, cfg.d_model), device=dev)

        def inputs(tok):
            return {"embeddings": emb}
    step = GraphedStep(lambda p, c, tok, index, start, join:
                       slot(p, inputs(tok), c, index, start, join))
    if not graphed:
        step.WARMUP = 1 << 30
    out = []
    for t in range(T):
        if cfg.input_mode == "tokens":
            tok = x[:, t:t + 1]
        else:
            emb.copy_(x[:, t:t + 1])
            tok = np.zeros((lanes, 1), np.int32)
        logits, caches = step(params, caches, tok, index_of(t), starts[t],
                              joins[t])
        out.append(logits[:, -1].float().clone())
    return torch.stack(out, 1), step.replays


@contextlib.contextmanager
def patched(obj, name, fn):
    """``obj.name`` replaced by ``fn`` inside the block (a planted fault)."""
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def decode_check(cfg, params, T=None, J=None, cf=None, plants=None,
                 bf16=True, seed=5):
    """Decode against the full forward. Lane 0 decodes one sequence of T
    positions (tokens, or frame embeddings for an embeddings model); lane 1
    decodes J of another, then a new request joins it at position J
    (``start`` = J, the previous occupant's rows and state left in its
    caches, the join mask set once). The truth is the full forward: of lane
    0's whole sequence, of lane 1's first occupant, and of the joined
    request alone from position 0 (RoPE and the window see only distances,
    an SSM lane is reset at the join; MoE at capacity factor ``cf``).

    float32, TF32 off: within SERVE_TOL_F32 of the forward; each of
    ``plants`` (name -> {"index_of", "starts", "cfg", "patch": a context
    manager}) must fail that check. bf16 (``bf16``): with ``e_fwd =
    max|forward_bf16 - forward_f32|`` and ``e_dec = max|decode_bf16 -
    forward_f32|``, ``e_dec <= 2 e_fwd``, and the greedy token equal to the
    float32 forward's wherever its top-2 margin exceeds ``2 e_fwd``. With
    MoE, a position where the bf16 forward or the bf16 decode routes a
    token to other experts than the float32 forward does (a near-tie in
    the gates, flipped by rounding: a discrete choice, as the greedy token
    is) is left out of both errors; the flips and both unrestricted errors
    are printed. The elementwise 2e-2 reading against the bf16 forward is
    printed beside, not enforced. Returns the line and (the inputs, the
    float32 decode and the plants' decodes) for `join_check`."""
    import numpy as np
    import torch

    from repro_torch.models.model import forward

    T, J, V = T or DECODE_T, J or DECODE_JOIN, cfg.vocab_size
    dev = next(iter(params.values())).device
    rng = np.random.default_rng(seed)
    key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
    if key == "tokens":
        x = rng.integers(0, V, (2, T)).astype(np.int32)
    else:
        x = torch.as_tensor((0.1 * rng.standard_normal(
            (2, T, cfg.d_model))).astype(np.float32), device=dev)
    starts = [np.array([0, 0 if t < J else J], np.int32) for t in range(T)]
    joins = [np.array([False, t == J]) for t in range(T)]

    def truth(dtype):
        rt = decode_runtime(dtype, cf)
        xs = torch.as_tensor(x, device=dev)
        with torch.no_grad():
            whole, _ = forward(params, cfg, rt, {key: xs})
            joined, _ = forward(params, cfg, rt, {key: xs[1:, J:]})
        return torch.stack([whole[0], torch.cat([whole[1, :J], joined[0]])]
                           )[..., :V].float()

    def decode(dtype, index_of=lambda t: t, starts=starts, cfg=cfg,
               patch=None):
        with patch or contextlib.nullcontext():
            got, replays = slot_decode(cfg, params, dtype, x, index_of,
                                       starts, joins, cf=cf)
        return got[..., :V], replays

    def within(got, want, tol):
        return bool(((got - want).abs() <= tol + tol * want.abs()).all())

    want32 = truth(torch.float32)
    got32, replays = decode(torch.float32)
    planted = {name: decode(torch.float32, **spec)[0]
               for name, spec in (plants or {}).items()}
    f32 = {"max_abs_err": float((got32 - want32).abs().max()),
           "within_tol": within(got32, want32, SERVE_TOL_F32),
           "tol": SERVE_TOL_F32, "graph_replays": replays,
           "plants": {name: {"max_abs_err": float((g - want32).abs().max()),
                             "within_tol": within(g, want32, SERVE_TOL_F32)}
                      for name, g in planted.items()}}
    line = {"lanes": 2, "positions": T, "join_at": J, "float32": f32}
    if bf16:
        fwd16 = truth(torch.bfloat16)
        got16, _ = decode(torch.bfloat16)
        # MoE: positions where a bf16 run routes a token to other experts
        # than the float32 forward (a near-tie in the gates flipped by
        # rounding) are left out of both errors and counted
        same = torch.ones(want32.shape[:2], dtype=torch.bool,
                          device=want32.device)
        flips = None
        if cfg.n_experts:
            r32, r16 = (forward_routes(truth, dt, J)
                        for dt in (torch.float32, torch.bfloat16))
            d16 = decode_routes(cfg, params, x, starts, joins, cf)
            flips = {"forward": (r16 != r32).any(-1).any(0),
                     "decode": (d16 != r32).any(-1).any(0)}
            same = ~flips["forward"] & ~flips["decode"]
        e_fwd = float((fwd16 - want32).abs()[same].max())
        e_dec = float((got16 - want32).abs()[same].max())
        top2 = want32.topk(2, dim=-1).values
        sure = ((top2[..., 0] - top2[..., 1]) > 2 * e_fwd) & same
        greedy_diff = int(((got16.argmax(-1) != want32.argmax(-1))
                           & sure).sum())
        line["bf16"] = {
            "e_fwd": e_fwd, "e_dec": e_dec,
            "within_2_e_fwd": e_dec <= 2 * e_fwd,
            "positions_with_margin": int(sure.sum()),
            "greedy_mismatches": greedy_diff,
            "max_abs_logit": float(want32.abs().max()),
            "elementwise_2e-2_vs_bf16_forward": within(got16, fwd16, 2e-2)}
        if flips is not None:
            line["bf16"].update(
                e_fwd_all=float((fwd16 - want32).abs().max()),
                e_dec_all=float((got16 - want32).abs().max()),
                routing_flips={k: int(v.sum()) for k, v in flips.items()},
                positions_compared=int(same.sum()))
    return line, {"x": x, "got32": got32, "planted": planted}


def recorded_routes(fn):
    """Run ``fn`` eagerly with `moe.route` recording each call's experts,
    sorted per token. Returns the list of (tokens, k) tensors."""
    from repro_torch.models import moe as tmoe

    route, recs = tmoe.route, []

    def kept(*a):
        out = route(*a)
        recs.append(out[2].sort(dim=-1).values)
        return out

    with patched(tmoe, "route", kept):
        fn()
    return recs


def forward_routes(truth, dtype, J):
    """The experts of every MoE layer for `decode_check`'s truth in
    ``dtype``, laid out as its lanes: (layers, 2, T, k)."""
    import torch

    recs = recorded_routes(lambda: truth(dtype))
    n = len(recs) // 2  # the whole batch's calls, then the joined request's
    out = []
    for whole, joined in zip(recs[:n], recs[n:]):
        whole = whole.view(2, -1, whole.shape[-1])
        out.append(torch.stack([whole[0], torch.cat([whole[1, :J],
                                                     joined])]))
    return torch.stack(out)


def decode_routes(cfg, params, x, starts, joins, cf):
    """The experts of every MoE layer in an eager bf16 decode of
    `decode_check`'s lanes: (layers, 2, T, k)."""
    import torch

    T = x.shape[1]
    recs = recorded_routes(lambda: slot_decode(
        cfg, params, torch.bfloat16, x, lambda t: t, starts, joins, cf=cf,
        graphed=False))
    steps = torch.stack(recs).view(T, len(recs) // T, 2, -1)
    return steps.permute(1, 2, 0, 3)


def decode_vs_forward(cfg, params):
    """Part a's decode checks at full width (`decode_check`): GPT-2 has no
    positional embedding, so its planted faults are the index one step
    behind (each step writes over the previous token's row) and the
    ``start`` mask dropped (the joined request sees the previous
    occupant)."""
    import numpy as np

    plants = {"index_one_behind": {"index_of": lambda t: max(t - 1, 0)},
              "start_mask_dropped": {"starts": [np.zeros(2, np.int32)]
                                     * DECODE_T}}
    return decode_check(cfg, params, plants=plants)[0]


def join_oracle(cfg, rt, params):
    """Part a's third check: `test_join_evict_matches_static_batch_oracle`'s
    construction at full width on the card — six requests through a 2-slot
    engine (joins into recycled lanes), each alone through the fixed-batch
    engine; the tokens must match."""
    import numpy as np

    from repro_torch.serve import (ContinuousBatchingEngine, Request,
                                   RequestQueue, ServeEngine, VirtualClock)

    rng = np.random.default_rng(11)
    reqs = [Request(req_id=i, tenant=0,
                    prompt=rng.integers(1, cfg.vocab_size, size=int(
                        rng.integers(3, 7))).astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 7)), enqueue_ts=0.0)
            for i in range(6)]
    eng = ContinuousBatchingEngine(cfg, rt, params, slots=2, max_len=256,
                                   seed=0, clock=VirtualClock(0.02))
    queue = RequestQueue()
    for r in reqs:
        queue.push(r)
    s = 0
    while len(queue) or eng.n_active:
        eng.tick(s, None, queue, None)
        s += 1
    oracle = ServeEngine(cfg=cfg, rt=rt, params=params, batch_size=1,
                         max_len=64)
    compared = mismatched = 0
    for r in eng.finished:
        want = oracle.generate(r.prompt[None, :], r.max_new_tokens)
        want = want[0, r.prompt_len:]
        compared += len(want)
        mismatched += int((np.asarray(r.tokens) != want).sum())
    return {"requests": len(eng.finished),
            "joined_mid_flight": sum(r.start_index > 0
                                     for r in eng.finished),
            "compared": compared, "mismatched": mismatched}


def check_graph(where, g):
    """`graphed_vs_eager`'s bars: the graph captured, >= 48 steps with
    joins and an epoch reset, every step's logits and every token bitwise
    equal, no non-finite step."""
    if not (g["captured"] and g["steps"] >= 48 and g["joins"]
            and g["epoch_resets"]):
        raise SmokeFailure(f"{where}: the graph run is too short or lacks "
                           f"joins or an epoch reset: {g}")
    if g["bitwise_equal_steps"] != g["steps"] or not g["tokens_equal"] \
            or g["nonfinite_steps"]:
        raise SmokeFailure(f"{where}: the graphed slot step differs from "
                           f"the eager one: {g}")


def check_decode_line(where, d, gate_f32=True):
    """`decode_check`'s bars: float32 within SERVE_TOL_F32 (when gated) on
    a graphed step, every planted fault outside it; bf16 (when run)
    ``e_dec <= 2 e_fwd`` with no greedy mismatch where the margin
    allows."""
    f32 = d["float32"]
    if not f32["graph_replays"] or (gate_f32 and not f32["within_tol"]):
        raise SmokeFailure(f"{where}: float32 decode against the forward: "
                           f"{f32}")
    passed = [k for k, v in f32["plants"].items() if v["within_tol"]]
    if passed:
        raise SmokeFailure(f"{where}: planted decode faults {passed} pass "
                           f"the float32 check: {f32['plants']}")
    b16 = d.get("bf16")
    if b16 and (not b16["within_2_e_fwd"] or b16["greedy_mismatches"]):
        raise SmokeFailure(f"{where}: bf16 decode against the float32 "
                           f"forward: {b16}")


def serve_part_a():
    """Part a: the slot step's CUDA graph, decode against the forward (float32
    and bf16), and mid-flight joins against the static-batch oracle, at full
    width (GPT-2 124M; bf16 but for the float32 check)."""
    import torch

    from repro_torch.config import get_arch
    from repro_torch.models.model import Runtime, init_params

    t0 = time.perf_counter()
    cfg = get_arch("gpt2")
    rt = Runtime(compute_dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    line = {"phase": "serve_path", "part": "a", "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "graph": graphed_vs_eager(cfg, rt, params),
            "decode_vs_forward": decode_vs_forward(cfg, params),
            "join_oracle": join_oracle(cfg, rt, params),
            "seconds": time.perf_counter() - t0}
    emit(line)
    check_graph("serve_path a", line["graph"])
    check_decode_line("serve_path a", line["decode_vs_forward"])
    j = line["join_oracle"]
    if j["mismatched"] or not j["joined_mid_flight"]:
        raise SmokeFailure(f"serve_path a: join oracle: {j}")
    del params
    torch.cuda.empty_cache()


def serve_part_b(serve, reset_counts, read_counts, read_all_variants):
    """Part b: `repro_torch.launch.serve` in-process at full width, 64
    requests in each of SERVE_MODES with SERVE_SLO. Returns the launches
    and variants summed over the monitored modes."""
    import torch

    t0 = time.perf_counter()
    line = {"phase": "serve_path", "part": "b", "slo": SERVE_SLO,
            "requests": SERVE_REQUESTS, "modes": {}}
    totals = {"launches": {}, "variants": {}}
    with runtime_leaks() as leaks:
        for mode in SERVE_MODES:
            t_mode = time.perf_counter()
            args = serve.parser().parse_args(
                ["--device", "cuda", "--num-requests", str(SERVE_REQUESTS),
                 "--monitor-spec", json.dumps({"mode": mode,
                                               "slo": SERVE_SLO})])
            reset_counts()
            out = serve.serve(args)
            launches, plain = read_counts()
            variants = read_all_variants()
            res = {**out["stats"],
                   "graphed": out["engine"]._step_fn.graph is not None,
                   "seconds": time.perf_counter() - t_mode}
            report = out["report"]
            if report is not None:
                res.update(
                    incidents=[{"kind": i.kind, "suspect":
                                i.suspect_layer.value,
                                "severity": i.severity}
                               for i in report.incidents],
                    diagnoses=[d.fault_kind for d in report.diagnoses],
                    rows_per_layer={k: v.events
                                    for k, v in report.layers.items()},
                    serve_stats=out["session"].serve_stats(),
                    runtime_rows=out["session"].collector["xla"].emitted,
                    launches=launches, plain_calls=plain, variants=variants)
                tally(totals, launches, variants)
            line["modes"][mode] = res
            del out, report
            torch.cuda.empty_cache()
    line["runtime_rows_in_zone"] = leaks["in_zone"]
    line["runtime_rows_on_worker"] = leaks["on_worker"]
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    for mode, res in line["modes"].items():
        if res["requests"] != SERVE_REQUESTS or res["nonfinite_steps"] \
                or not res["graphed"]:
            raise SmokeFailure(f"serve_path b {mode}: {res['requests']} "
                               f"requests, {res['nonfinite_steps']} "
                               f"non-finite steps, graphed "
                               f"{res['graphed']}")
        if mode == "off":
            continue
        if not all(res["launches"][k] for k in SERVE_KERNELS[mode]):
            raise SmokeFailure(f"serve_path b {mode}: a kernel was not "
                               f"launched: {res['launches']}")
        if any(v["general"] for v in res["variants"].values()) \
                or any(res["plain_calls"].values()):
            raise SmokeFailure(f"serve_path b {mode}: a general kernel or a "
                               f"plain version ran: {res['variants']}, "
                               f"{res['plain_calls']}")
    if line["runtime_rows_in_zone"] or line["runtime_rows_on_worker"]:
        raise SmokeFailure(f"serve_path b: runtime-probe rows inside a "
                           f"detection zone: {leaks}")
    return totals


def serve_part_c():
    """Part c: `repro_torch.launch.evaluate --scenarios serve-smoke` on the
    card, its cells held against the same run on the CPU (the request
    plane runs on a virtual clock: every SLO number must agree)."""
    from repro_torch.eval import matrix
    from repro_torch.launch import evaluate

    t0 = time.perf_counter()
    rows = {}
    rcs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(ROOT, "results", f"eval_serve_{dev}")
        rcs[dev] = evaluate.main(["--scenarios", "serve-smoke", "--device",
                                  dev, "--out", out])
        with open(os.path.join(out, "scenario_matrix.json")) as f:
            rows[dev] = json.load(f)["rows"]
    cells = [{"scenario": r["scenario"], "mode": r["mode"], "slo": r["slo"],
              "diagnoses": r["diagnosis"]["kinds"],
              "equal_to_cpu": (r["slo"], r["diagnosis"]["kinds"])
              == (c["slo"], c["diagnosis"]["kinds"])}
             for r, c in zip(rows["cuda"], rows["cpu"])]
    clean = matrix.serve_clean_breaches({"rows": rows["cuda"]})
    line = {"phase": "serve_path", "part": "c", "rc": rcs["cuda"],
            "rc_cpu": rcs["cpu"], "clean_breach_incidents": clean,
            "cells": cells, "seconds": time.perf_counter() - t0}
    emit(line)
    if rcs["cuda"] or clean != 0:
        raise SmokeFailure(f"serve_path c: serve-smoke exited {rcs['cuda']}"
                           f" with {clean} breach incidents on the clean "
                           "control")
    flood = [c for c in cells if c["scenario"] == "serve_tenant_flood"]
    if not all("tenant_flood" in c["diagnoses"] for c in flood):
        raise SmokeFailure(f"serve_path c: tenant_flood not diagnosed: "
                           f"{flood}")
    if not all(c["equal_to_cpu"] for c in cells):
        raise SmokeFailure(f"serve_path c: the card's cells differ from the "
                           f"CPU's: {cells}")


def serve_part_d(reset_counts, read_counts, read_all_variants):
    """Part d: the serve GMM scenarios at full width, 240 steps, both
    modes, through `run_scenario`; each cell's line, then the part's.
    Returns the launches and variants summed over the cells."""
    from repro_torch.core.chaos import get_scenario
    from repro_torch.eval import matrix, runner

    t0 = time.perf_counter()
    totals = {"launches": {}, "variants": {}}
    rows = []
    with runtime_leaks() as leaks:
        for name in SERVE_D_SCENARIOS:
            for mode in EVAL_MODES:
                reset_counts()
                run = runner.run_scenario(get_scenario(name), mode,
                                          n_steps=EVAL_STEPS, device="cuda")
                launches, plain = read_counts()
                variants = read_all_variants()
                row = matrix._row(run)
                rows.append(row)
                m = row["metrics"]
                emit({"phase": "serve_cell", "scenario": name, "mode": mode,
                      "f1": m["f1"], "false_alarm_rate":
                      m["false_alarm_rate"],
                      "faults": f"{m['faults_detected']}/"
                                f"{m['faults_total']}",
                      "diagnoses": row["diagnosis"]["kinds"],
                      "kind_accuracy": row["diagnosis"]["kind_accuracy"],
                      "layer_rows": {k: v["events"]
                                     for k, v in row["layers"].items()},
                      "wall_s": row["wall_s"], "launches": launches,
                      "plain_calls": plain, "variants": variants})
                if not all(launches[k] for k in EVAL_KERNELS[mode]) \
                        or any(plain.values()) \
                        or any(v["general"] for v in variants.values()):
                    raise SmokeFailure(
                        f"serve_path d {name} {mode}: kernels {launches}, "
                        f"plain {plain}, variants {variants}")
                tally(totals, launches, variants)
                del run
    acc = matrix.mean_kind_accuracy({"rows": rows})
    line = {"phase": "serve_path", "part": "d", "cells": len(rows),
            "steps": EVAL_STEPS, "mean_kind_accuracy": acc,
            "runtime_rows_in_zone": leaks["in_zone"],
            "runtime_rows_on_worker": leaks["on_worker"],
            "seconds": time.perf_counter() - t0, "unmet": []}
    if acc is not None and acc < 0.5:
        line["unmet"].append(f"mean blamed-kind accuracy {acc} under the "
                             "reference's --min-kind-acc 0.5 (ROADMAP §3)")
    emit(line)
    if leaks["in_zone"] or leaks["on_worker"]:
        raise SmokeFailure(f"serve_path d: runtime-probe rows inside a "
                           f"detection zone: {leaks}")
    return totals


def serve_phase(reset_counts, read_counts, read_all_variants):
    """Phase ``serve_path``: parts a-d. Returns the launches and variants
    of the monitored runs (parts b and d) summed."""
    from repro_torch.launch import serve

    serve_part_a()
    b = serve_part_b(serve, reset_counts, read_counts, read_all_variants)
    serve_part_c()
    d = serve_part_d(reset_counts, read_counts, read_all_variants)
    out = {"launches": {}, "variants": {}}
    for part in (b, d):
        tally(out, part["launches"], part["variants"])
    return out


# the serve_arch phase: decode and serving of the other families, a process
# per model (`isolated`)
SERVE_ARCH_LLAMA, SERVE_ARCH_MAMBA = "llama3.2-1b", "mamba2-2.7b"
SERVE_ARCH_MOE, SERVE_ARCH_MOE_LAYERS = "deepseek-v2-236b", 2
SERVE_ARCH_RUNS = {SERVE_ARCH_LLAMA: (("off", 64), ("stream", 64)),
                   SERVE_ARCH_MAMBA: (("stream", 32),)}
SERVE_ARCH_WRAP_T = 48  # h2o-danube's decode positions: past its 32-slot ring
# part a's join position: the joined request's forward (T - 16 positions)
# divides into the reduced SSD's 16-token chunks
SERVE_ARCH_JOIN = 16


def rope_plant(shift_query=False, zero_key=False):
    """A planted RoPE fault: `attention.apply_rope` wrapped so that every
    decode step's query rotation (the first call of each pair: q, then k;
    MLA's q_rope, then k_rope) happens at ``index + 1``, or its key
    rotation returns zeros (MLA's score without the k_rope term)."""
    from repro_torch.models import attention as attn

    rope, calls = attn.apply_rope, [0]

    def planted(x, pos, theta):
        query = calls[0] % 2 == 0
        calls[0] += 1
        if query and shift_query:
            return rope(x, pos + 1, theta)
        out = rope(x, pos, theta)
        return out * 0 if not query and zero_key else out

    return patched(attn, "apply_rope", planted)


def family_plants(cfg):
    """The planted faults of ``cfg``'s decode mechanisms, each of which
    must fail the float32 decode check: the query rotated at ``index + 1``
    (RoPE: Llama), a ring of ``slots - 1`` (the rolling cache, whose
    oldest live row is then overwritten: H2O-Danube), no join-time reset
    of the SSM state (Mamba2), MLA's score without its k_rope term
    (DeepSeek-V2), MoE decode without the dense residual (Arctic)."""
    import dataclasses

    import torch

    from repro_torch.models import attention as attn
    from repro_torch.serve import continuous

    name = cfg.name
    if name == "llama3.2-1b":
        return {"rope_query_at_index_plus_1": {
            "patch": rope_plant(shift_query=True)}}
    if name == "h2o-danube-3-4b":
        return {"ring_of_slots_minus_1": {"patch": patched(
            attn, "ring_slot",
            lambda cfg, idx, slots: torch.remainder(idx, slots - 1))}}
    if name == "mamba2-2.7b":
        return {"no_join_reset": {"patch": patched(
            continuous, "_reset_joined", lambda caches, mask: caches)}}
    if name == "deepseek-v2-236b":
        return {"mla_score_without_k_rope": {
            "patch": rope_plant(zero_key=True)}}
    if name == "arctic-480b":
        return {"moe_without_dense_residual": {
            "cfg": dataclasses.replace(cfg, dense_residual=False)}}
    return {}


def join_check(cfg, params, line, extras, cf=None):
    """The join oracle, float32, on `decode_check`'s inputs. An SSM or
    hybrid lane (recurrent state reset at the join): the joined request's
    logits equal, bit for bit, those of the same two lanes decoded from
    position J in fresh caches (the joined lane's other history gone), and
    a planted run without the reset does not. Otherwise (RoPE): within
    SERVE_TOL_F32 of the request decoded alone (a static batch of one)
    from position J, the greedy tokens equal."""
    import numpy as np
    import torch

    x, T, J, V = extras["x"], line["positions"], line["join_at"], \
        cfg.vocab_size
    joined = extras["got32"][1, J:]
    n = T - J
    if cfg.family in ("ssm", "hybrid"):
        fresh, _ = slot_decode(cfg, params, torch.float32, x[:, J:],
                               lambda t: J + t,
                               [np.array([0, J], np.int32)] * n,
                               [np.zeros(2, bool)] * n, cf=cf, max_len=T)
        fresh = fresh[1, :, :V]
        out = {"oracle": "fresh lane, bit for bit",
               "bitwise_equal": bool(torch.equal(joined, fresh)),
               "max_abs_diff": float((joined - fresh).abs().max())}
        out["plants_bitwise_equal"] = {
            k: bool(torch.equal(g[1, J:], fresh))
            for k, g in extras["planted"].items()}
        out["ok"] = out["bitwise_equal"] and not any(
            out["plants_bitwise_equal"].values())
        return out
    alone, _ = slot_decode(cfg, params, torch.float32, x[1:, J:],
                           lambda t: J + t, [np.array([J], np.int32)] * n,
                           [np.zeros(1, bool)] * n, cf=cf, max_len=T)
    alone = alone[0, :, :V]
    err = float((joined - alone).abs().max())
    ok = bool(((joined - alone).abs()
               <= SERVE_TOL_F32 + SERVE_TOL_F32 * alone.abs()).all())
    mism = int((joined.argmax(-1) != alone.argmax(-1)).sum())
    return {"oracle": "static batch at the same positions",
            "max_abs_err": err, "within_tol": ok,
            "greedy_mismatches": mism, "ok": ok and not mism}


def static_graph_check(cfg, rt, params):
    """The fixed-batch engine (the only one an embeddings model has) with
    its step graphed and eager: 2 lanes, a 4-token prompt, 48 generated
    positions; every step's logits bitwise equal (the engine feeds zero
    embeddings, as the reference's does, so they carry little; the slot
    step's graph on real embeddings is `emb_graph_check`)."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeEngine

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32)
    runs = []
    for graphed in (True, False):
        eng = ServeEngine(cfg=cfg, rt=rt, params=params, batch_size=2,
                          max_len=64)
        if not graphed:
            eng._graphed.WARMUP = 1 << 30
        logits = []
        eng.generate(prompts, 48, step_hook=lambda t, l, logits=logits:
                     logits.append(l[:, -1].float().clone()))
        runs.append((eng._graphed, torch.stack(logits)))
    (g, lg), (_, le) = runs
    return {"steps": int(lg.shape[0]), "captured": g.graph is not None,
            "replays": g.replays,
            "bitwise_equal_steps": int((lg == le).all(dim=(1, 2)).sum()),
            "max_abs_logit": float(lg.abs().max())}


def emb_graph_check(cfg, params):
    """The slot step on real frame embeddings (a device buffer the graph
    reads), graphed against eager in bf16 over 48 steps: lane 1 joins at
    position 8, and at step 40 the index rewinds to 0 (an epoch reset)
    with both lanes joining. Every step's logits bitwise equal."""
    import numpy as np
    import torch

    T, J, R = 48, 8, 40
    x = torch.as_tensor((0.1 * np.random.default_rng(1).standard_normal(
        (2, T, cfg.d_model))).astype(np.float32), device="cuda")
    starts = [np.array([0, 0 if t < J else J] if t < R else [0, 0],
                       np.int32) for t in range(T)]
    joins = [np.array([t == R, t in (J, R)]) for t in range(T)]
    index_of = lambda t: t if t < R else t - R  # noqa: E731
    lg, replays = slot_decode(cfg, params, torch.bfloat16, x, index_of,
                              starts, joins, max_len=R)
    le, _ = slot_decode(cfg, params, torch.bfloat16, x, index_of, starts,
                        joins, graphed=False, max_len=R)
    return {"steps": T, "replays": replays, "joins": 1, "epoch_resets": 1,
            "bitwise_equal_steps": int((lg == le).all(dim=(0, 2)).sum())}


def serve_arch_reduced(reset_counts, read_counts, read_all_variants):
    """``--serve-arch-reduced`` (a process of its own): every registered
    decoder but GPT-2 at its reduced size. Per model: the graphed slot step
    against eager in bf16 (`graphed_vs_eager`: >= 48 steps, joins, an
    epoch reset; the embeddings model through the fixed-batch engine and
    `emb_graph_check`); float32 decode against the float32 forward within
    SERVE_TOL_F32 (`decode_check`; H2O-Danube over SERVE_ARCH_WRAP_T
    positions, past its ring's wrap; lane 1 joined at SERVE_ARCH_JOIN; MoE
    at a capacity factor of E / k, where no pair drops) with the model's
    planted faults (`family_plants`) failing it; the join oracle
    (`join_check`)."""
    import gc as _gc

    import torch

    from repro_torch.config import get_arch, list_archs, reduced
    from repro_torch.models.model import Runtime, init_params

    t0 = time.perf_counter()
    out = {}
    for arch in list_archs():
        cfg = reduced(get_arch(arch))
        if arch == "gpt2" or not cfg.has_decode:
            continue
        t_arch = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        rt = Runtime(compute_dtype=torch.bfloat16)
        cf = cfg.n_experts / cfg.moe_top_k if cfg.n_experts else None
        res = {}
        if cfg.input_mode == "tokens":
            res["graph"] = graphed_vs_eager(cfg, rt, params)
        else:
            res["graph"] = static_graph_check(cfg, rt, params)
            res["emb_graph"] = emb_graph_check(cfg, params)
        T = SERVE_ARCH_WRAP_T if cfg.sliding_window and not cfg.ssm_state \
            else DECODE_T
        res["decode"], extras = decode_check(
            cfg, params, T=T, J=SERVE_ARCH_JOIN, cf=cf,
            plants=family_plants(cfg), bf16=False)
        res["join"] = join_check(cfg, params, res["decode"], extras, cf=cf)
        res["seconds"] = time.perf_counter() - t_arch
        out[arch] = res
        del params, extras
        _gc.collect()
        torch.cuda.empty_cache()
    return {"archs": out, "seconds": time.perf_counter() - t0}


def check_serve_arch_reduced(out):
    """Part a's gates, model by model (`check_graph`, `check_decode_line`;
    the embeddings model's two graph checks; the join oracle), and one
    plant per mechanism."""
    for arch, res in out["archs"].items():
        where = f"serve_arch_path a {arch}"
        g = res["graph"]
        if "emb_graph" in res:
            e = res["emb_graph"]
            if not (g["captured"] and g["steps"] >= 48
                    and g["bitwise_equal_steps"] == g["steps"]
                    and e["replays"]
                    and e["bitwise_equal_steps"] == e["steps"]):
                raise SmokeFailure(f"{where}: the graphed step differs from "
                                   f"eager or the run is short: {g} {e}")
        else:
            check_graph(where, g)
        check_decode_line(where, res["decode"])
        if not res["join"]["ok"]:
            raise SmokeFailure(f"{where}: join oracle: {res['join']}")
    planted = {k for res in out["archs"].values()
               for k in res["decode"]["float32"]["plants"]}
    if len(planted) != 5:
        raise SmokeFailure(f"serve_arch_path a: plants {sorted(planted)}, "
                           "not one per mechanism")
    if out["archs"]["h2o-danube-3-4b"]["decode"]["positions"] < 48:
        raise SmokeFailure("serve_arch_path a: h2o-danube short of a wrap")


def serve_arch_serve(serve, reset_counts, read_counts, read_all_variants,
                     arch, mode, requests):
    """`repro_torch.launch.serve` in-process at full width (bf16, 4 slots,
    the weights drawn on the card): ``requests`` requests in ``mode``,
    the SLO verdict reported (SERVE_SLO was set for GPT-2's step; no gate
    on it). The run's numbers, launches and variants."""
    import torch

    t0 = time.perf_counter()
    args = serve.parser().parse_args(
        ["--arch", arch, "--device", "cuda", "--init-on-device",
         "--num-requests", str(requests), "--slots", "4",
         "--monitor-spec", json.dumps({"mode": mode, "slo": SERVE_SLO})])
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    out = serve.serve(args)
    launches, plain = read_counts()
    res = {**out["stats"], "mode": mode,
           "graphed": out["engine"]._step_fn.graph is not None,
           "launches": launches, "plain_calls": plain,
           "variants": read_all_variants(), "lost_batches": 0}
    report = out["report"]
    if report is not None:
        res["slo_breach_incidents"] = sum(i.kind == "slo_breach"
                                          for i in report.incidents)
        res["incidents"] = len(report.incidents)
        res["diagnoses"] = [d.fault_kind for d in report.diagnoses]
        res["serve_stats"] = out["session"].serve_stats()
        if mode == "stream":
            res["lost_batches"] = out["session"].detector.monitor.stats()[
                "aggregator"]["lost_batches"]
    res["seconds"] = time.perf_counter() - t0
    del out, report
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_serve_arch_run(where, res, requests):
    """Every request served, no non-finite step, the slot step graphed;
    in a monitored mode gmm_update launched, specialised only, no plain
    call, no lost batch."""
    if res["requests"] != requests or res["nonfinite_steps"] \
            or not res["graphed"]:
        raise SmokeFailure(f"serve_arch_path {where}: {res['requests']} of "
                           f"{requests} requests, {res['nonfinite_steps']} "
                           f"non-finite steps, graphed {res['graphed']}")
    if res["mode"] == "off":
        return
    if not res["launches"]["gmm_update"] or any(
            res["plain_calls"].values()) or any(
            v["general"] for v in res["variants"].values()):
        raise SmokeFailure(f"serve_arch_path {where}: launches "
                           f"{res['launches']}, plain {res['plain_calls']},"
                           f" variants {res['variants']}")
    if res["lost_batches"]:
        raise SmokeFailure(f"serve_arch_path {where}: {res['lost_batches']} "
                           "lost batches")


def slot_step_ms(cfg, params, slots=4, max_len=512, reps=20):
    """The continuous engine's slot step in bf16 as `launch.serve` builds
    it (``slots`` lanes, ``max_len`` cache rows), captured as a CUDA graph:
    its device ms a replay, CUDA events over ``reps`` replays with nothing
    between them."""
    import numpy as np
    import torch

    from repro_torch.models.model import Runtime, init_decode_caches
    from repro_torch.serve.continuous import make_slot_step
    from repro_torch.serve.engine import GraphedStep

    caches = init_decode_caches(cfg, slots, max_len, device="cuda")
    slot = make_slot_step(cfg, Runtime(compute_dtype=torch.bfloat16))
    step = GraphedStep(lambda p, c, tok, index, start, join:
                       slot(p, {"tokens": tok}, c, index, start, join))
    tok, start = np.zeros((slots, 1), np.int32), np.zeros(slots, np.int32)
    join = np.zeros(slots, bool)
    for i in range(step.WARMUP + 1):  # the eager calls, then the capture
        step(params, caches, tok, i, start, join)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        step.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def serve_arch_full(arch, reset_counts, read_counts, read_all_variants,
                    gate_f32):
    """A full-width decoder on the card (bf16 serving, the weights drawn on
    the card): the graphed slot step against eager (`graphed_vs_eager`),
    decode against the forward in float32 (within SERVE_TOL_F32 when
    ``gate_f32``, else reported) and bf16 (`decode_check`), then
    `repro_torch.launch.serve` in each of SERVE_ARCH_RUNS[arch]. The
    engine step's p50/p90 ms stands beside the slot step graph's device ms
    (`slot_step_ms`) and the time to read the weights once at
    HBM_BYTES_PER_S (float32 masters, which the step casts, and their
    bf16 size). ``part_s``: the seconds of each part before serving."""
    import torch

    from repro_torch.config import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import Runtime, init_params

    t0 = time.perf_counter()
    cfg = get_arch(arch)
    parts = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        got = fn(*a)
        parts[name] = time.perf_counter() - t
        return got

    with runtime_leaks() as leaks:
        params = timed("init", lambda: init_params(
            cfg, seed=0, device="cuda", generator_device="cuda"))
        n = sum(p.numel() for p in params.values())
        out = {"arch": arch, "params": n,
               "weights_read_ms": {"float32": 1e3 * 4 * n / HBM_BYTES_PER_S,
                                   "bf16": 1e3 * 2 * n / HBM_BYTES_PER_S},
               "graph": timed("graph", graphed_vs_eager, cfg, Runtime(
                   compute_dtype=torch.bfloat16), params),
               "part_s": parts}
        out["decode"], _ = timed("decode", decode_check, cfg, params)
        out["decode"]["float32"]["gated"] = gate_f32
        out["slot_step_graph_ms"] = timed("slot_step", slot_step_ms, cfg,
                                          params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["runs"] = {mode: serve_arch_serve(
            serve, reset_counts, read_counts, read_all_variants, arch, mode,
            requests) for mode, requests in SERVE_ARCH_RUNS[arch]}
    out["runtime_rows_in_zone"] = leaks["in_zone"]
    out["runtime_rows_on_worker"] = leaks["on_worker"]
    out["seconds"] = time.perf_counter() - t0
    return out


def serve_arch_llama(reset_counts, read_counts, read_all_variants):
    """``--serve-arch-llama``: Llama 3.2 1B uncut (`serve_arch_full`, the
    float32 decode gated)."""
    return serve_arch_full(SERVE_ARCH_LLAMA, reset_counts, read_counts,
                           read_all_variants, gate_f32=True)


def serve_arch_mamba(reset_counts, read_counts, read_all_variants):
    """``--serve-arch-mamba``: Mamba2 2.7B uncut (`serve_arch_full`). Its
    float32 decode error is reported, not gated: over 64 layers the
    chunked SSD forward and the recurrence round differently, so the 1e-4
    bar holds at reduced size (part a) only."""
    return serve_arch_full(SERVE_ARCH_MAMBA, reset_counts, read_counts,
                           read_all_variants, gate_f32=False)


def serve_arch_moe(reset_counts, read_counts, read_all_variants):
    """``--serve-arch-moe``: DeepSeek-V2 at its published widths cut to
    SERVE_ARCH_MOE_LAYERS layers (the dense first layer, one MoE layer of
    160 experts with MLA; the weights drawn on the card). The graphed slot
    step against eager (bf16, default capacity); decode against the
    forward in float32 (within SERVE_TOL_F32) and bf16 at a capacity factor
    of E / k, where no pair can drop; the pairs dropped counted on eager
    runs at that capacity (0 on both sides) and at the default one."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import get_arch
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import Runtime, forward, init_params

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(SERVE_ARCH_MOE),
                              n_layers=SERVE_ARCH_MOE_LAYERS)
    cf = cfg.n_experts / cfg.moe_top_k
    params = init_params(cfg, seed=0, device="cuda", generator_device="cuda")
    n = sum(p.numel() for p in params.values())
    out = {"arch": SERVE_ARCH_MOE, "params": n,
           "reduced": {"n_layers": [get_arch(SERVE_ARCH_MOE).n_layers,
                                    SERVE_ARCH_MOE_LAYERS]},
           "no_drop_capacity_factor": cf,
           "graph": graphed_vs_eager(cfg, Runtime(
               compute_dtype=torch.bfloat16), params)}
    out["decode"], extras = decode_check(cfg, params, cf=cf)

    def drops(capacity_factor):
        """Pairs dropped by the forward (T = 2 x DECODE_T tokens a layer)
        and by decode (T = 2 a step), float32, eager."""
        counted = {"forward": 0, "decode": 0}
        where = ["forward"]
        route = tmoe.route
        rt = decode_runtime(torch.float32, capacity_factor)

        def kept(p, prefix, c, xf, rt_=None):
            got = route(p, prefix, c, xf, rt_)
            C = tmoe._capacity(xf.shape[0], c.moe_top_k, c.n_experts,
                               capacity_factor)
            counted[where[0]] += int(tmoe.dropped(got[2], c.n_experts, C))
            return got

        x = extras["x"]
        with patched(tmoe, "route", kept), torch.no_grad():
            forward(params, cfg, rt, {"tokens": torch.as_tensor(
                x, device="cuda")})
            where[0] = "decode"
            zeros = [np.zeros(2, np.int32)] * DECODE_T
            slot_decode(cfg, params, torch.float32, x, lambda t: t, zeros,
                        [np.zeros(2, bool)] * DECODE_T, cf=capacity_factor,
                        graphed=False)
        return counted

    out["dropped_no_drop_capacity"] = drops(cf)
    out["dropped_default_capacity"] = drops(Runtime().moe_capacity_factor)
    out["pairs"] = {"forward": 2 * DECODE_T * cfg.moe_top_k,
                    "decode": 2 * DECODE_T * cfg.moe_top_k}
    out["seconds"] = time.perf_counter() - t0
    del params, extras
    gc.collect()
    torch.cuda.empty_cache()
    # the reduced decoders in this process: one CUDA context fewer
    out["reduced_models"] = serve_arch_reduced(reset_counts, read_counts,
                                               read_all_variants)
    return out


def serve_arch_phase():
    """Phase ``serve_arch_path``: decode and serving of the other families
    on the card, a process per uncut model (`isolated`): (a) every reduced
    decoder (`serve_arch_reduced`, in (d)'s process), (b) Llama 3.2 1B
    uncut (``--serve-arch-llama``), (c) Mamba2 2.7B uncut
    (``--serve-arch-mamba``), (d) a two-layer DeepSeek-V2
    (``--serve-arch-moe``). Returns the line; raises on a failed gate."""
    t_phase = time.perf_counter()
    line = {"phase": "serve_arch_path",
            "llama": isolated("--serve-arch-llama", "serve_arch_path llama"),
            "mamba": isolated("--serve-arch-mamba", "serve_arch_path mamba"),
            "moe": isolated("--serve-arch-moe", "serve_arch_path moe")}
    line["reduced_models"] = line["moe"].pop("reduced_models")
    line["reduced"] = {SERVE_ARCH_MOE: line["moe"]["reduced"]}
    runs = [r for w in ("llama", "mamba") for r in line[w]["runs"].values()]
    names = runs[0]["launches"]
    line["launches"] = {k: sum(r["launches"][k] for r in runs
                               if r["mode"] != "off") for k in names}
    line["variants"] = {k: {v: sum(r["variants"][k][v] for r in runs
                                   if r["mode"] != "off")
                            for v in ("specialised", "general")}
                        for k in names}
    line["seconds"] = time.perf_counter() - t_phase
    try:
        check_serve_arch(line)
    finally:
        emit(line)
    return line


def check_serve_arch(line):
    """Parts a-d's gates (`check_serve_arch_reduced`, `check_graph`,
    `check_decode_line`, `check_serve_arch_run`)."""
    check_serve_arch_reduced(line["reduced_models"])
    for where in ("llama", "mamba"):
        res = line[where]
        check_graph(f"serve_arch_path {where}", res["graph"])
        check_decode_line(f"serve_arch_path {where}", res["decode"],
                          res["decode"]["float32"]["gated"])
        for mode, run in res["runs"].items():
            requests = dict(SERVE_ARCH_RUNS[res["arch"]])[mode]
            check_serve_arch_run(f"{where} {mode}", run, requests)
        if res["runtime_rows_in_zone"] or res["runtime_rows_on_worker"]:
            raise SmokeFailure(f"serve_arch_path {where}: runtime-probe rows "
                               "in a detection zone or on the worker")
    mo = line["moe"]
    check_graph("serve_arch_path moe", mo["graph"])
    check_decode_line("serve_arch_path moe", mo["decode"])
    if any(mo["dropped_no_drop_capacity"].values()):
        raise SmokeFailure(f"serve_arch_path moe: pairs dropped at the "
                           f"no-drop capacity: "
                           f"{mo['dropped_no_drop_capacity']}")


# the checkpoint phase: three runs of the launcher's stream session at full
# width (uninterrupted; stopped by SIGINT once step CKPT_SIGINT_AT is
# logged; resumed from the second's checkpoints), a checkpoint every
# CKPT_EVERY steps
CKPT_STEPS = 120
CKPT_EVERY = 40
CKPT_SIGINT_AT = 70
CKPT_LOG_EVERY = 10
# the uninterrupted run's diagnosis planted at this stream cadence point
# (flush_every 25): python_latency, whose governor action is checkpoint_now
CKPT_PLANT_AT = 50


def ckpt_argv(ckpt_dir):
    spec = {"mode": "stream", "probe_options": {
        "python": {"sample_every": 25}, "device": {"interval": 0.05}}}
    return ["--arch", "gpt2", "--device", "cuda", "--steps", str(CKPT_STEPS),
            "--batch", "8", "--seq", "128", "--inject-faults",
            "--log-every", str(CKPT_LOG_EVERY), "--monitor-spec",
            json.dumps(spec), "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", str(CKPT_EVERY)]


def plant_checkpoint_now(step):
    """A python_latency diagnosis added to the session's outcome at
    ``step``'s cadence point: the governor's policy for it is
    checkpoint_now, which the launcher must follow with a save (the clean
    run's own diagnoses rarely ask for one)."""
    from repro_torch.core.governor import Governor
    from repro_torch.diagnosis.engine import Diagnosis
    from repro_torch.session.session import Session

    planted = Diagnosis(incident_id=0, fault_kind="python_latency",
                        family="straggler", confidence=0.9, severity=0.5,
                        blamed_nodes=[0], causal_chain=[], action=None,
                        steps=[step - 1, step], t_start=0.0, t_end=0.0,
                        candidates={"python_latency": 0.9}, evidence={})
    planted.action = Governor().act(planted)
    detect = Session._detect_step

    def detect_planted(self, at, out):
        detect(self, at, out)
        if at == step:
            out.diagnoses.append(planted)

    Session._detect_step = detect_planted


def ckpt_run(reset_counts, read_counts, read_all_variants, ckpt_dir,
             plant_at=""):
    """``chip_smoke.py --ckpt-run OUT DIR [STEP]``: one run of the
    checkpoint phase, `repro_torch.launch.train.train` in this process with
    its checkpoints in DIR (SIGINT stops it at the end of the step in
    flight, the launcher's handler), a checkpoint_now planted at STEP when
    given. Returns its losses (as float hex), saves, actions and
    launches."""
    from repro_torch.launch import train

    if plant_at:
        plant_checkpoint_now(int(plant_at))
    reset_counts()
    out = train.train(train.parser().parse_args(ckpt_argv(ckpt_dir)))
    launches, plain = read_counts()
    return {"losses": [float(v).hex() for v in out["losses"]],
            "losses_finite": all(math.isfinite(v) for v in out["losses"]),
            "start_step": out["start_step"],
            "interrupted": out["interrupted"], "saves": out["saves"],
            "actions": [a.kind for a in out["actions"]],
            "action_steps": out["action_steps"],
            "step_end_s": out["step_end_s"],
            "steps_per_s": out["steps_per_s"],
            "diagnoses": [d.fault_kind for d in out["report"].diagnoses],
            "launches": launches, "plain_calls": plain,
            "variants": read_all_variants()}


def run_ckpt(ckpt_dir, sigint_at=None, plant_at=None, timeout=600):
    """One `ckpt_run` in a process of its own; with ``sigint_at``, SIGINT
    goes to it once its log shows that step (from outside, as a scheduler
    preempts a job); with ``plant_at``, a checkpoint_now is planted there.
    Returns what it wrote, ``rc`` added."""
    import signal

    out = ckpt_dir.rstrip("/") + (".cut.json" if sigint_at is not None
                                  else ".run.json")
    if os.path.exists(out):
        os.remove(out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".err", "w+") as err_f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--ckpt-run", out, ckpt_dir]
                                + ([str(plant_at)] if plant_at else []),
                                stdout=subprocess.PIPE, stderr=err_f,
                                text=True)
        tail, sent = [], False
        t0 = time.perf_counter()
        for line in proc.stdout:
            tail = (tail + [line])[-40:]
            parts = line.split()
            if sigint_at is not None and not sent \
                    and parts[:1] == ["step"] and int(parts[1]) >= sigint_at:
                proc.send_signal(signal.SIGINT)
                sent = True
            if time.perf_counter() - t0 > timeout:
                proc.kill()
                break
        rc = proc.wait()
        err_f.seek(0)
        err = err_f.read()
    adopt_device_runs(out)
    if rc or not os.path.exists(out):
        raise SmokeFailure(f"ckpt_path: a run exited {rc}: {err[-2000:]} "
                           f"{''.join(tail)[-1500:]}")
    with open(out) as f:
        got = json.load(f)
    got.update(rc=rc, sigint_sent=sent)
    return got


def save_stalls(run):
    """Per save of a run: the seconds it held the loop on the host, and
    the ms the loop's next step took past the run's median step."""
    import numpy as np

    ends = np.asarray(run["step_end_s"])
    dur = np.diff(ends)
    med = float(np.median(dur)) if len(dur) else 0.0
    out = []
    for s in run["saves"]:
        j = s["step"] - 1 - run["start_step"]  # the step it followed
        nxt = float(dur[j]) if 0 <= j < len(dur) else None
        out.append({"step": s["step"], "reason": s["reason"],
                    "host_stall_ms": 1e3 * s["stall_s"],
                    "next_step_excess_ms": (1e3 * (nxt - med)
                                            if nxt is not None else None),
                    "write_s": s.get("write_s"), "bytes": s["bytes"]})
    return out


def ckpt_phase(reset_counts, read_counts, read_all_variants):
    """Phase ``ckpt_path`` (in a process of its own, each run in one more):
    the uninterrupted run, the run stopped by SIGINT, and its resume.
    Returns the runs and what the gates read; `check_ckpt` holds them."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "results", "ckpt")
    shutil.rmtree(root, ignore_errors=True)
    full = run_ckpt(os.path.join(root, "full"), plant_at=CKPT_PLANT_AT)
    cut = run_ckpt(os.path.join(root, "cut"), sigint_at=CKPT_SIGINT_AT)
    resumed = run_ckpt(os.path.join(root, "cut"))
    left = {d: sorted(os.listdir(os.path.join(root, d)))
            for d in ("full", "cut")}
    shutil.rmtree(root, ignore_errors=True)
    runs = {"full": full, "cut": cut, "resumed": resumed}
    for r in runs.values():
        r["save_stalls"] = save_stalls(r)
        del r["step_end_s"]
    out = {"launches": {}, "variants": {}}
    for r in runs.values():
        tally(out, r["launches"], r["variants"])
    out.update(runs=runs, dirs_left=left,
               seconds=time.perf_counter() - t_phase)
    return out


def ckpt_line(res):
    """The phase's line: whether the resume equals the uninterrupted run,
    the saves' stalls, write seconds and bytes, the governor's asks."""
    import numpy as np

    runs = res["runs"]
    full = [float.fromhex(v) for v in runs["full"]["losses"]]
    both = [float.fromhex(v) for v in runs["cut"]["losses"]
            + runs["resumed"]["losses"]]
    n = min(len(full), len(both))
    diff = (float(np.max(np.abs(np.asarray(full[:n]) - np.asarray(both[:n]))
                         / np.maximum(np.abs(full[:n]), 1e-30)))
            if n else None)
    saves = [s for r in runs.values() for s in r["save_stalls"]]
    return {"phase": "ckpt_path", "steps": CKPT_STEPS,
            "every": CKPT_EVERY, "sigint_after_step": CKPT_SIGINT_AT,
            "cut_at": runs["resumed"]["start_step"],
            "interrupted": runs["cut"]["interrupted"],
            "resume_bitwise": full == both,
            "resume_max_rel_diff": diff, "losses": [len(full), len(both)],
            "saves": saves,
            "save_host_stall_ms": [round(s["host_stall_ms"], 3)
                                   for s in saves],
            "save_next_step_excess_ms": [
                round(s["next_step_excess_ms"], 3) for s in saves
                if s["next_step_excess_ms"] is not None],
            "write_s": [round(s["write_s"], 3) for s in saves
                        if s["write_s"] is not None],
            "checkpoint_bytes": max(s["bytes"] for s in saves),
            "checkpoint_now_planted": {"full": CKPT_PLANT_AT},
            "checkpoint_now": {k: [s for a, s in zip(r["actions"],
                                                     r["action_steps"])
                                   if a == "checkpoint_now"]
                               for k, r in runs.items()},
            "diagnoses": {k: r["diagnoses"] for k, r in runs.items()},
            "steps_per_s": {k: r["steps_per_s"] for k, r in runs.items()},
            "dirs_left": res["dirs_left"], "launches": res["launches"],
            "variants": res["variants"], "seconds": res["seconds"]}


def check_ckpt(line, runs):
    """The resumed run's losses are the uninterrupted run's bit for bit
    (a 1e-6 relative difference at most would be reported, with its
    cause, as ``unmet``); no staging directory is left; every
    checkpoint_now the governor asked for is followed by a save at that
    step, the one planted in the uninterrupted run among them; finite
    losses; the run stopped by SIGINT did stop, and saved."""
    unmet = []
    if not all(r["losses_finite"] for r in runs.values()):
        raise SmokeFailure("ckpt_path: non-finite loss")
    if not line["interrupted"] or not runs["cut"]["sigint_sent"]:
        raise SmokeFailure(f"ckpt_path: the SIGINT run did not stop: "
                           f"{line['interrupted']}")
    if line["cut_at"] != runs["cut"]["saves"][-1]["step"]:
        raise SmokeFailure(f"ckpt_path: resumed at {line['cut_at']}, the "
                           f"cut run saved {runs['cut']['saves'][-1]}")
    if line["losses"] != [CKPT_STEPS, CKPT_STEPS]:
        raise SmokeFailure(f"ckpt_path: losses {line['losses']}")
    if not line["resume_bitwise"]:
        if line["resume_max_rel_diff"] is None \
                or line["resume_max_rel_diff"] > 1e-6:
            raise SmokeFailure(f"ckpt_path: the resumed run's losses differ "
                               f"from the uninterrupted run's by "
                               f"{line['resume_max_rel_diff']}")
        unmet.append("resume within 1e-6, not bitwise")
    if CKPT_PLANT_AT not in line["checkpoint_now"]["full"]:
        raise SmokeFailure(f"ckpt_path: the checkpoint_now planted at step "
                           f"{CKPT_PLANT_AT} was not acted on: "
                           f"{line['checkpoint_now']}")
    tmp = [f for d in line["dirs_left"].values() for f in d
           if f.endswith(".tmp")]
    if tmp:
        raise SmokeFailure(f"ckpt_path: staging dirs left: {tmp}")
    for k, r in runs.items():
        saved = {s["step"] for s in r["saves"]}
        for a, s in zip(r["actions"], r["action_steps"]):
            if a == "checkpoint_now" and s + 1 not in saved:
                raise SmokeFailure(f"ckpt_path {k}: checkpoint_now after "
                                   f"step {s} and no save at {s + 1}: "
                                   f"{sorted(saved)}")
        if any(r["plain_calls"].values()) or any(
                v["general"] for v in r["variants"].values()):
            raise SmokeFailure(f"ckpt_path {k}: plain calls "
                               f"{r['plain_calls']} or general kernels "
                               f"{r['variants']}")
    return unmet


# the operator-surface phase: the launcher's stream session with the
# metrics endpoint and the board, scraped every OBS_SCRAPE_S meanwhile
OBS_STEPS = 240
OBS_SCRAPE_S = 0.5


def obs_phase(reset_counts, read_counts, read_all_variants):
    """Phase ``obs_path`` (a process of its own): `repro_torch.launch.train`
    in stream mode at full width with ``--metrics-port 0 --board-out``;
    a thread scrapes ``/metrics`` (each parsed by `repro_torch.obs.parser`)
    and ``/healthz`` while it runs. Returns what the gates read."""
    import threading
    import urllib.request

    from repro_torch.launch import train
    from repro_torch.obs import httpd, parse_exposition

    t_phase = time.perf_counter()
    servers = []
    start = httpd.MetricsServer.start

    def start_kept(self):  # the endpoint, once bound
        out = start(self)
        servers.append(self)
        return out

    httpd.MetricsServer.start = start_kept
    board = os.path.join(ROOT, "results", "obs_board.html")
    if os.path.exists(board):
        os.remove(board)
    spec = {"mode": "stream", "probe_options": train.LEGACY_PROBE_OPTIONS}
    args = train.parser().parse_args(
        ["--arch", "gpt2", "--device", "cuda", "--steps", str(OBS_STEPS),
         "--batch", "8", "--seq", "128", "--inject-faults", "--log-every",
         "0", "--monitor-spec", json.dumps(spec), "--metrics-port", "0",
         "--board-out", board])
    scrapes, errors, health = [], [], []
    done = threading.Event()

    def scrape():
        while not done.wait(OBS_SCRAPE_S):
            if not servers:
                continue
            url = servers[0].url
            try:
                with urllib.request.urlopen(url + "/metrics",
                                            timeout=5) as r:
                    exp = parse_exposition(r.read().decode("utf-8"))
                hits = exp.sample("eacgm_detect_compile_cache_hits_total")
                misses = exp.sample(
                    "eacgm_detect_compile_cache_misses_total")
                scrapes.append({"t": time.perf_counter() - t_phase,
                                "families": len(exp.family_names()),
                                "cache_hits": hits.value if hits else None,
                                "cache_misses": (misses.value if misses
                                                 else None)})
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as r:
                    health.append(json.loads(r.read().decode("utf-8")))
            except Exception as e:  # a gate reads it
                if servers[0]._server is not None:  # not yet stopped
                    errors.append(repr(e))

    thread = threading.Thread(target=scrape, name="obs-scraper",
                              daemon=True)
    thread.start()
    reset_counts()
    try:
        out = train.train(args)
    finally:
        done.set()
        thread.join(timeout=30)
        httpd.MetricsServer.start = start
    launches, plain = read_counts()
    with open(board) as f:
        final = f.read()
    report = out["report"]
    return {"steps": OBS_STEPS,
            "url": servers[0].url if servers else None,
            "scrapes": len(scrapes), "scrape_errors": errors[:5],
            "first_scrapes": scrapes[:3], "last_scrape": scrapes[-1:],
            "healthz": health[-1] if health else None,
            "healthz_answers": len(health),
            "board_bytes": len(final),
            "board_refreshes": 'http-equiv="refresh"' in final,
            "board_has_fleet": 'id="fleet"' in final,
            "sink_outputs": report.sink_outputs,
            "losses_finite": all(math.isfinite(v) for v in out["losses"]),
            "steps_per_s": out["steps_per_s"],
            "steady_steps_per_s": steady_steps_per_s(out["step_end_s"]),
            "launches": launches, "plain_calls": plain,
            "variants": read_all_variants(),
            "seconds": time.perf_counter() - t_phase}


def check_obs(line):
    """At least three scrapes, every one parsed; the compile-cache
    (SHAPE_CACHE) families counted; /healthz answered; the board written
    and its final render static; the kernels launched, no plain call."""
    if line["scrapes"] < 3 or line["scrape_errors"]:
        raise SmokeFailure(f"obs_path: {line['scrapes']} scrapes, errors "
                           f"{line['scrape_errors']}")
    last = line["last_scrape"][0]
    if not ((last["cache_hits"] or 0) + (last["cache_misses"] or 0)):
        raise SmokeFailure(f"obs_path: SHAPE_CACHE families read 0: {last}")
    if not line["healthz_answers"] or line["healthz"].get("status") is None:
        raise SmokeFailure(f"obs_path: /healthz: {line['healthz']}")
    if line["board_refreshes"] or not line["board_has_fleet"]:
        raise SmokeFailure(f"obs_path: final board: refresh "
                           f"{line['board_refreshes']}, fleet grid "
                           f"{line['board_has_fleet']}")
    if not line["losses_finite"]:
        raise SmokeFailure("obs_path: non-finite loss")
    if not line["launches"]["gmm_update"] or any(
            line["plain_calls"].values()) or any(
            v["general"] for v in line["variants"].values()):
        raise SmokeFailure(f"obs_path: launches {line['launches']}, plain "
                           f"calls {line['plain_calls']}, variants "
                           f"{line['variants']}")


# ---------------------------------------------------------------------------
# arch_path: every registered architecture on the card
# ---------------------------------------------------------------------------

# (optimizer, microbatches) of each reduced model's graphed-step checks
ARCH_CASES = (("adamw", 1), ("adafactor", 1), ("adamw", 2))
ARCH_REDUCED_STEPS = 4  # 2 eager warm-up calls, the capture, a replay
ARCH_LLAMA = "llama3.2-1b"
ARCH_LLAMA_RUNS = (("off", 30), ("batch", 200))
# 75 steps: three stream flushes (100, four, until the smoke outgrew 900 s
# on a slower host)
ARCH_MAMBA, ARCH_MAMBA_STEPS = "mamba2-2.7b", 75
ARCH_MOE, ARCH_MOE_LAYERS = "deepseek-v2-236b", 2
# graphed steps; the eager ones they are held to: the two warm-up calls and
# the first replay of the graph
ARCH_MOE_STEPS, ARCH_MOE_EAGER = 10, 3
# a 5.36B model whose every update is clipped to an RMS of one learning
# rate: 1e-3 moved each weight by 3-7% of its scale a step, and the loss
# jumped before it fell (12.0 -> 20.6 -> 5.4 over 20 steps)
ARCH_MOE_LR = 1e-4
ARCH_BATCH, ARCH_SEQ = 8, 128


def _norm(ts):
    import torch

    return float(torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(ts)))))


def arch_grads_check(cfg, rt, microbatches, data, dev):
    """`make_loss_and_grads` (``microbatches`` slices) CUDA-graphed against
    eager on the same parameters, new batches and perturbed weights at
    every call: the largest relative loss error and gradient error (the
    difference's global norm over the gradients')."""
    import torch

    from repro_torch.models.model import batch_to_device, init_params
    from repro_torch.train.step import CudaGraphed, make_loss_and_grads

    params = init_params(cfg, seed=0, device=dev)
    eager = make_loss_and_grads(cfg, rt, microbatches)
    graphed = CudaGraphed(eager)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = [0.0, 0.0]
    for s in range(ARCH_REDUCED_STEPS):
        batch = batch_to_device(data.batch(s), dev)
        lg, _, gg = graphed(params, batch)
        le, _, ge = eager(params, batch)
        worst[0] = max(worst[0], abs(float(lg) - float(le)) / abs(float(le)))
        worst[1] = max(worst[1], _norm(torch._foreach_sub(list(gg), list(ge)))
                       / _norm(ge))
        with torch.no_grad():
            for p in params.values():
                p.add_(torch.randn(p.shape, generator=gen, device=dev),
                       alpha=0.01)
    if graphed.graph is None:
        raise SmokeFailure(f"arch_path: {cfg.name}'s step was never captured")
    return worst


def arch_step_check(cfg, rt, optimizer, microbatches, data, dev):
    """The whole train step — forward, backward and the update — as one
    CUDA graph against the eager step from the same seed: the largest
    relative loss error over the steps, and the parameters' difference over
    how far the eager steps moved them (model-wide norms)."""
    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.models.model import batch_to_device
    from repro_torch.train.step import (init_train_state, make_optimizer_for,
                                        make_train_step)

    opt = make_optimizer_for(TrainConfig(
        learning_rate=1e-3, total_steps=ARCH_REDUCED_STEPS, warmup_steps=1,
        optimizer=optimizer), cfg)
    runs = []
    for graph in (True, False):
        state = init_train_state(cfg, opt, seed=0, device=dev)
        init = [p.detach().clone() for p in state.params.values()]
        fn = make_train_step(cfg, rt, opt, microbatches=microbatches,
                             cuda_graph=graph)
        losses = []
        for s in range(ARCH_REDUCED_STEPS):
            state, m = fn(state, batch_to_device(data.batch(s), dev))
            losses.append(float(m["loss"]))
        runs.append((list(state.params.values()), losses, init))
    (pg, lg, _), (pe, le, init) = runs
    if not all(math.isfinite(v) for v in lg + le):
        raise SmokeFailure(f"arch_path: {cfg.name} {optimizer}: non-finite "
                           f"loss {lg} {le}")
    with torch.no_grad():
        moved = _norm(torch._foreach_sub(pe, init))
        return (max(abs(a - b) / abs(b) for a, b in zip(lg, le)),
                _norm(torch._foreach_sub(pg, pe)) / moved)


def arch_reduced(reset_counts, read_counts, read_all_variants):
    """``--arch-reduced`` (a process of its own): every registered
    architecture at its reduced size in bf16 (batch 4, sequence 64: four
    SSD chunks, the reduced sliding window inside the sequence), its
    forward and backward graphed against eager with one microbatch and two,
    and its whole train step graphed against eager with each of
    ARCH_CASES. Gates: loss within 1e-3 relative; gradients within 1e-2 of
    their norm; the parameters within 1e-2 of their move."""
    import torch

    from repro_torch.config import get_arch, list_archs, reduced
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rt = Runtime(torch.bfloat16)
    out = {}
    for arch in list_archs():
        cfg = reduced(get_arch(arch))
        data = SyntheticLMData(cfg, seq_len=64, global_batch=4, seed=0)
        res = {f"grads_mb{m}": arch_grads_check(cfg, rt, m, data, dev)
               for m in (1, 2)}
        for optimizer, m in ARCH_CASES:
            res[f"step_{optimizer}_mb{m}"] = arch_step_check(
                cfg, rt, optimizer, m, data, dev)
        out[arch] = res
        bad = {k: v for k, v in res.items()
               if not (v[0] <= 1e-3 and v[1] <= 1e-2)}
        if bad:
            raise SmokeFailure(f"arch_path: {arch}'s graphed step differs "
                               f"from eager: {bad}")
        gc.collect()
        torch.cuda.empty_cache()
    return {"archs": out, "seconds": time.perf_counter() - t0}


def arch_session(train, reset_counts, read_counts, read_all_variants, arch,
                 mode, steps, extra=()):
    """`repro_torch.launch.train` at full width (bf16, batch 8, sequence
    128, ``--inject-faults``) in ``mode``: the run's numbers, and the
    session's as `session_summary` gives them."""
    import torch

    spec = {"mode": mode, "probe_options": train.LEGACY_PROBE_OPTIONS}
    args = train.parser().parse_args(
        ["--arch", arch, "--device", "cuda", "--steps", str(steps),
         "--batch", str(ARCH_BATCH), "--seq", str(ARCH_SEQ),
         "--inject-faults", "--log-every", "0", "--monitor-spec",
         json.dumps(spec), *extra])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = train.train(args)
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    losses = out["losses"]
    steady = steady_steps_per_s(out["step_end_s"])
    res = {"steps": steps, "losses_finite": all(math.isfinite(v)
                                                for v in losses),
           "loss_first": losses[0], "loss_last": losses[-1],
           "steps_per_s": out["steps_per_s"], "steady_steps_per_s": steady,
           "ms_per_step": 1e3 / steady,
           # init, the host-to-device copy and the session's attach
           "setup_s": wall - out["seconds"] - out["finalize_s"],
           "finalize_s": out["finalize_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": train.get_arch(arch).param_count()}
    if mode != "off":
        res.update(session_summary(out, mode, steps, launches, plain,
                                   read_all_variants()))
        res["lost_batches"] = (out["session"].detector.monitor.stats()
                               ["aggregator"]["lost_batches"]
                               if mode == "stream" else 0)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_arch_session(where, res, want):
    """The kernels ``want`` launched, specialised only, no plain call; the
    probes' operator and runtime rows; no lost batch."""
    if not res["losses_finite"]:
        raise SmokeFailure(f"arch_path {where}: non-finite loss")
    if not all(res["launches"][k] for k in want) or any(
            res["plain_calls"].values()) or any(
            v["general"] for v in res["variants"].values()):
        raise SmokeFailure(f"arch_path {where}: launches {res['launches']}, "
                           f"plain calls {res['plain_calls']}, variants "
                           f"{res['variants']}")
    rows = res["rows_per_probe"]
    if not (rows["operator"] and rows["xla"] and res["runtime_probe"]["rows"]):
        raise SmokeFailure(f"arch_path {where}: no operator or runtime "
                           f"rows: {rows}")
    if res["lost_batches"]:
        raise SmokeFailure(f"arch_path {where}: {res['lost_batches']} lost "
                           "batches")


def arch_llama(reset_counts, read_counts, read_all_variants):
    """``--arch-llama`` (a process of its own): Llama 3.2 1B at full width
    (RoPE, SwiGLU, GQA 32/8, tied 128,256-token vocabulary; the weights drawn
    on the card, ``--init-on-device``) through the launcher,
    unmonitored, then in batch mode with the full probe suite. Gates: those
    of ``session_path``'s batch mode — finite loss, the STEP layer's hit
    rate > 0.5 and > 2x its false rate, gmm_score and gmm_best launched
    specialised with no plain call, operator and runtime rows, no runtime
    row in a detection zone or on the worker."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    out = {"arch": ARCH_LLAMA}
    with runtime_leaks() as leaks:
        for mode, steps in ARCH_LLAMA_RUNS:
            out[mode] = arch_session(train, reset_counts, read_counts,
                                     read_all_variants, ARCH_LLAMA, mode,
                                     steps, extra=("--init-on-device",))
    out["runtime_rows_in_zone"] = leaks["in_zone"]
    out["runtime_rows_on_worker"] = leaks["on_worker"]
    out["overhead"] = 1.0 - (out["batch"]["steady_steps_per_s"]
                             / out["off"]["steady_steps_per_s"])
    out["remat"] = arch_remat()
    out["seconds"] = time.perf_counter() - t0
    # the reduced models in this process: one CUDA context fewer
    out["reduced_models"] = arch_reduced(reset_counts, read_counts,
                                         read_all_variants)
    return out


REMAT_MODES, REMAT_STEPS = ("none", "full", "dots"), 10


def arch_remat():
    """Llama 3.2 1B uncut (bf16, batch 8, sequence 128, the whole step
    graphed, AdamW) with each ``Runtime.remat`` of REMAT_MODES, REMAT_STEPS
    steps from the same weights on the same batches: the losses, ms a step
    after the graphed step's set-up calls, and two peaks of
    ``torch.cuda.max_memory_allocated``: over one eager forward and
    backward from the initial state (``fwd_bwd_peak_gb``, where remat
    acts) and over the graphed steps (``peak_gb``: its graph holds the
    AdamW update too, whose temporaries beside the gradients and moments
    set that peak). Each is reset before; the state and graph of one
    variant are freed before the next."""
    import torch

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Runtime, batch_to_device
    from repro_torch.train.step import (init_train_state,
                                        make_loss_and_grads,
                                        make_optimizer_for, make_train_step)

    dev = torch.device("cuda")
    cfg = get_arch(ARCH_LLAMA)
    data = SyntheticLMData(cfg, seq_len=ARCH_SEQ, global_batch=ARCH_BATCH,
                           seed=0)
    batches = [batch_to_device(data.batch(i), dev)
               for i in range(REMAT_STEPS)]
    out = {}
    for mode in REMAT_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = make_optimizer_for(TrainConfig(learning_rate=3e-4,
                                             total_steps=REMAT_STEPS,
                                             warmup_steps=1), cfg)
        state = init_train_state(cfg, opt, seed=0, device=dev,
                                 generator_device=dev)
        rt = Runtime(torch.bfloat16, remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads = make_loss_and_grads(cfg, rt)(state.params, batches[0])[2]
        torch.cuda.synchronize()
        fwd_bwd_peak = torch.cuda.max_memory_allocated() / 1e9
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, rt, opt)
        losses, ends = [], []
        t0 = time.perf_counter()
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))  # waits for the step
            ends.append(time.perf_counter() - t0)
        out[mode] = {"losses": losses,
                     "ms_per_step": 1e3 * (ends[-1] - ends[SETUP_STEPS - 1])
                     / (len(ends) - SETUP_STEPS),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "fwd_bwd_peak_gb": fwd_bwd_peak}
        del state, step, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    none = out["none"]["losses"]
    for mode in REMAT_MODES[1:]:
        got = out[mode]["losses"]
        out[mode]["losses_bitwise"] = got == none
        out[mode]["max_rel_loss_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(got, none))
    return out


def arch_mamba(reset_counts, read_counts, read_all_variants):
    """``--arch-mamba`` (a process of its own): Mamba2 2.7B at full width
    (64 SSD layers, state 128, one 128-token chunk; the weights drawn on the
    card, ``--init-on-device``) through the launcher in stream mode,
    ARCH_MAMBA_STEPS steps. Gates: finite loss; all four GMM kernels
    launched, specialised, no plain call; no lost batch; the runtime probe
    writes no row in a detection zone."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    with runtime_leaks() as leaks:
        out = arch_session(train, reset_counts, read_counts,
                           read_all_variants, ARCH_MAMBA, "stream",
                           ARCH_MAMBA_STEPS, extra=("--init-on-device",))
    return {"arch": ARCH_MAMBA, "stream": out,
            "runtime_rows_in_zone": leaks["in_zone"],
            "runtime_rows_on_worker": leaks["on_worker"],
            "seconds": time.perf_counter() - t0}


def arch_moe(reset_counts, read_counts, read_all_variants):
    """``--arch-moe`` (a process of its own): DeepSeek-V2 at its published
    widths cut to ARCH_MOE_LAYERS layers (the dense first layer and one MoE
    layer of 160 experts, top-6, 2 shared; MLA attention; an untied head),
    bf16, batch 8, sequence 128, Adafactor, two microbatches, unmonitored;
    the weights drawn on the card; learning rate ARCH_MOE_LR. First
    ARCH_MOE_EAGER eager steps on one batch, their parameters kept on the
    host; then the same weights again
    (the same seed) and ARCH_MOE_STEPS steps of the CUDA-graphed train step
    on that batch. Gates: finite losses; each of the first ARCH_MOE_EAGER
    graphed losses within 1e-3 of the eager one and the parameters after
    them within 1e-2 of the eager steps' move (graph_check's bars: two
    graph pools of ~45 GB do not fit one card, so the graphed forward and
    backward are not held against eager ones apart); the loss falls over
    the steps. Printed: ms a step, set-up seconds, peak memory, the tokens
    dropped at capacity at the first and the last weights; ms a step is
    the median graph replay, its loss read."""
    import dataclasses

    import torch

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.train.step import (TrainState, make_optimizer_for,
                                        make_train_step)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(ARCH_MOE), n_layers=ARCH_MOE_LAYERS)
    rt = tmodel.Runtime(torch.bfloat16)
    opt = make_optimizer_for(TrainConfig(
        learning_rate=ARCH_MOE_LR, total_steps=ARCH_MOE_STEPS,
        warmup_steps=2, optimizer="adafactor"), cfg)
    batch = tmodel.batch_to_device(SyntheticLMData(
        cfg, seq_len=ARCH_SEQ, global_batch=ARCH_BATCH, seed=0).batch(0), dev)
    C = tmoe._capacity(ARCH_BATCH * ARCH_SEQ, cfg.moe_top_k, cfg.n_experts,
                       rt.moe_capacity_factor)

    def drops(params):
        """(token, choice) pairs the MoE layer drops at capacity C."""
        got = []
        route = tmoe.route

        def kept(*a, **k):
            out = route(*a, **k)
            got.append(int(tmoe.dropped(out[2], cfg.n_experts, C)))
            return out

        tmoe.route = kept
        try:
            with torch.no_grad():
                tmodel.forward(params, cfg, rt, batch)
        finally:
            tmoe.route = route
        return got

    def run(graph, steps, params, at=None, hold=None):
        """``steps`` train steps on ``batch``: the losses, each step's
        seconds (its loss read), the state, and what ``hold`` returned
        after step ``at``."""
        state = TrainState(params, opt.init(params), 0)
        fn = make_train_step(cfg, rt, opt, microbatches=2, cuda_graph=graph)
        losses, secs, held = [], [], None
        for s in range(steps):
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            if s + 1 == at:
                held = hold(state.params)
        del fn  # the graph and its pool
        gc.collect()
        torch.cuda.empty_cache()
        return losses, secs, state, held

    def distance(params, host):
        """||params - host|| over the model, a 64M-entry slice at a time
        (the graph's pool leaves no room for a whole tensor's copy)."""
        total, chunk = 0.0, 1 << 26
        with torch.no_grad():
            for k, p in params.items():
                a, b = p.reshape(-1), host[k].reshape(-1)
                for i in range(0, a.numel(), chunk):
                    d = a[i:i + chunk] - b[i:i + chunk].to(dev)
                    total += float(torch.linalg.vector_norm(d)) ** 2
        return math.sqrt(total)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=0, device=dev,
                                generator_device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    drops_first = drops(params)
    eager_losses, _, state, _ = run(False, ARCH_MOE_EAGER, params)
    t0 = time.perf_counter()
    eager = {k: p.detach().cpu() for k, p in state.params.items()}
    d2h_s = time.perf_counter() - t0
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    init = tmodel.init_params(cfg, seed=0, device=dev, generator_device=dev)
    moved = distance(init, eager)

    def hold(params):
        t = time.perf_counter()
        return distance(params, eager), time.perf_counter() - t

    losses, secs, state, (diff, compare_s) = run(
        True, ARCH_MOE_STEPS, init, at=ARCH_MOE_EAGER, hold=hold)
    del eager
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    drops_last = drops(state.params)
    replays = sorted(secs[ARCH_MOE_EAGER:])  # after the capture
    rel_loss = max(abs(a - b) / abs(b)
                   for a, b in zip(losses[:ARCH_MOE_EAGER], eager_losses))
    out = {"arch": ARCH_MOE, "reduced": {"n_layers": [
               get_arch(ARCH_MOE).n_layers, ARCH_MOE_LAYERS]},
           "params": n_params, "optimizer": "adafactor", "microbatches": 2,
           "batch": ARCH_BATCH, "seq": ARCH_SEQ,
           "init_s": init_s, "d2h_s": d2h_s, "compare_s": compare_s,
           "eager_losses": eager_losses, "losses": losses,
           "losses_finite": all(math.isfinite(v)
                                for v in losses + eager_losses),
           "graphed_vs_eager": {"max_rel_loss_err": rel_loss,
                                "rel_params_err": diff / moved},
           "step_s": secs,
           "ms_per_step": 1e3 * replays[len(replays) // 2],
           "peak_gb": peak_gb,
           "capacity": C, "dropped_first": drops_first,
           "dropped_last": drops_last,
           "pairs_per_step": ARCH_BATCH * ARCH_SEQ * cfg.moe_top_k,
           "seconds": time.perf_counter() - t_phase}
    del state, init
    gc.collect()
    torch.cuda.empty_cache()
    return out


def arch_phase():
    """Phase ``arch_path``: the reference's other families on the card, a
    process per uncut model (`isolated`): Llama 3.2 1B monitored in batch
    mode and its remat variants, then the reduced models' graphed steps
    (`arch_reduced`), in one process (``--arch-llama``); Mamba2 2.7B in
    stream mode (``--arch-mamba``) and a two-layer DeepSeek-V2
    (``--arch-moe``). Returns the line; raises on a failed gate."""
    t_phase = time.perf_counter()
    line = {"phase": "arch_path",
            "llama": isolated("--arch-llama", "arch_path llama"),
            "mamba": isolated("--arch-mamba", "arch_path mamba"),
            "moe": isolated("--arch-moe", "arch_path moe")}
    line["reduced_models"] = line["llama"].pop("reduced_models")
    line["reduced_models"]["cases"] = ARCH_CASES
    # the one cut of a published configuration: DeepSeek-V2's depth
    line["reduced"] = {ARCH_MOE: line["moe"]["reduced"]}
    line["launches"] = {k: line["llama"]["batch"]["launches"][k]
                        + line["mamba"]["stream"]["launches"][k]
                        for k in line["mamba"]["stream"]["launches"]}
    line["variants"] = {k: {v: line["llama"]["batch"]["variants"][k][v]
                            + line["mamba"]["stream"]["variants"][k][v]
                            for v in ("specialised", "general")}
                        for k in line["mamba"]["stream"]["variants"]}
    line["seconds"] = time.perf_counter() - t_phase
    try:
        check_arch(line)
    finally:
        emit(line)
    return line


def check_arch(line):
    """(b) the batch session's gates as ``session_path``'s; (c) the stream
    session's kernels and wire; (d) graphed = eager and a falling loss."""
    ll = line["llama"]
    for where in ("llama", "mamba"):
        if line[where]["runtime_rows_in_zone"] or \
                line[where]["runtime_rows_on_worker"]:
            raise SmokeFailure(f"arch_path {where}: runtime-probe rows in a "
                               f"detection zone or on the worker")
    if not ll["off"]["losses_finite"]:
        raise SmokeFailure("arch_path llama off: non-finite loss")
    rm = ll["remat"]
    for mode in REMAT_MODES[1:]:
        if not rm[mode]["max_rel_loss_diff"] <= 1e-6:
            raise SmokeFailure(f"arch_path llama remat {mode}: losses "
                               f"differ from none's: {rm[mode]['losses']} "
                               f"vs {rm['none']['losses']}")
    if not rm["full"]["fwd_bwd_peak_gb"] < rm["none"]["fwd_bwd_peak_gb"]:
        raise SmokeFailure(f"arch_path llama remat: full's forward and "
                           f"backward peak {rm['full']['fwd_bwd_peak_gb']} "
                           f"GB not below none's "
                           f"{rm['none']['fwd_bwd_peak_gb']} GB")
    check_arch_session("llama batch", ll["batch"], ("gmm_score", "gmm_best"))
    step = ll["batch"]["rates"]["step"]
    if step is None or not (step["hit"] > 0.5
                            and step["hit"] > 2 * step["false"]):
        raise SmokeFailure(f"arch_path llama batch: STEP detection too "
                           f"weak: {step}")
    check_arch_session("mamba stream", line["mamba"]["stream"],
                       ("gmm_score", "gmm_best", "gmm_stats", "gmm_update"))
    mo = line["moe"]
    g = mo["graphed_vs_eager"]
    if not mo["losses_finite"]:
        raise SmokeFailure(f"arch_path moe: non-finite loss: {mo['losses']}")
    if not (g["max_rel_loss_err"] <= 1e-3 and g["rel_params_err"] <= 1e-2):
        raise SmokeFailure(f"arch_path moe: graphed step differs from "
                           f"eager: {g}, losses {mo['losses'][:4]} vs "
                           f"{mo['eager_losses']}")
    if not mo["losses"][-1] < mo["losses"][0]:
        raise SmokeFailure(f"arch_path moe: the loss did not fall: "
                           f"{mo['losses']}")


MESH_STEPS, MESH_LOSSES = 120, 20


def mesh_phase(reset_counts, read_counts, read_all_variants):
    """``--mesh-path`` (a process of its own): `repro_torch.launch.train`
    at full width (GPT-2 124M, bf16, batch 8, sequence 128, the step
    graphed) over a 1 x 1 mesh (``--data-mesh 1 --model-mesh 1``, a
    process group of one on NCCL) in batch mode with ``--inject-faults``,
    MESH_STEPS steps, after the same run without a mesh, unmonitored (the
    monitor does not touch the model: its losses are the reference). One
    card holds one rank: two ranks cannot share a device in one NCCL
    communicator. Returns the line's numbers."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train

    t0 = time.perf_counter()
    base = ["--arch", "gpt2", "--device", "cuda", "--steps", str(MESH_STEPS),
            "--batch", "8", "--seq", "128", "--inject-faults",
            "--log-every", "0"]
    plain = train.train(train.parser().parse_args(
        base + ["--monitor-spec", json.dumps({"mode": "off"})]))
    want = plain["losses"][:MESH_LOSSES]
    no_mesh_rate = steady_steps_per_s(plain["step_end_s"])
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"mode": "batch", "probe_options": train.LEGACY_PROBE_OPTIONS}
    args = train.parser().parse_args(
        base + ["--data-mesh", "1", "--model-mesh", "1", "--monitor-spec",
                json.dumps(spec)])
    reset_counts()
    with runtime_leaks() as leaks, mesh_mod.process_group("cuda"):
        backend = torch.distributed.get_backend()
        out = train.train(args)
    launches, plain_calls = read_counts()
    report, losses = out["report"], out["losses"]
    got = losses[:MESH_LOSSES]
    col = report.layers.get("collective")
    res = {"steps": MESH_STEPS, "backend": backend, "mesh": out["mesh"],
           "losses": got, "no_mesh_losses": want,
           "losses_bitwise": got == want,
           "max_rel_loss_diff": max(abs(a - b) / abs(b)
                                    for a, b in zip(got, want)),
           "losses_finite": all(math.isfinite(v) for v in losses),
           "steady_steps_per_s": steady_steps_per_s(out["step_end_s"]),
           "no_mesh_off_steady_steps_per_s": no_mesh_rate,
           "collective_schedule": out["collectives"],
           "collective_rows": col.events if col is not None else 0,
           "rates": layer_rates(report, out["injector"], MESH_STEPS),
           "launches": launches, "plain_calls": plain_calls,
           "variants": read_all_variants(),
           "runtime_rows_in_zone": leaks["in_zone"],
           "runtime_rows_on_worker": leaks["on_worker"],
           "seconds": time.perf_counter() - t0}
    del out
    return res


def check_mesh(line):
    """mesh_path's gates: the first MESH_LOSSES losses equal the no-mesh
    run's (bit for bit, or within 1e-6 relative: then ``unmet``); STEP hit
    > 0.5 and > 2x false; the COLLECTIVE schedule read off the step (a
    1 x 1 mesh issues none, so no row), never a made-up one; the batch
    kernels launched, specialised only, no plain call, no runtime row in a
    detection zone."""
    if not line["losses_finite"]:
        raise SmokeFailure("mesh_path: non-finite loss")
    if line["max_rel_loss_diff"] > 1e-6:
        raise SmokeFailure(f"mesh_path: losses differ from the no-mesh "
                           f"run's: {line['losses']} vs "
                           f"{line['no_mesh_losses']}")
    step = line["rates"]["step"]
    if step is None or not (step["hit"] > 0.5
                            and step["hit"] > 2 * step["false"]):
        raise SmokeFailure(f"mesh_path: STEP detection too weak: {step}")
    sched = line["collective_schedule"]
    if sched is None or sched["source"] != "step" \
            or line["collective_rows"] != sched["ops"] * line["steps"]:
        raise SmokeFailure(f"mesh_path: the COLLECTIVE layer is not the "
                           f"step's own: {sched}, "
                           f"{line['collective_rows']} rows")
    if not (line["launches"]["gmm_score"] and line["launches"]["gmm_best"]) \
            or any(line["plain_calls"].values()) \
            or any(v["general"] for v in line["variants"].values()):
        raise SmokeFailure(f"mesh_path: launches {line['launches']}, plain "
                           f"{line['plain_calls']}, variants "
                           f"{line['variants']}")
    if line["runtime_rows_in_zone"] or line["runtime_rows_on_worker"]:
        raise SmokeFailure("mesh_path: runtime-probe rows in a detection "
                           "zone or on the worker")
    return [] if line["losses_bitwise"] else [
        f"losses within 1e-6 relative, not bit for bit "
        f"({line['max_rel_loss_diff']:.3g})"]


# what ``chip_smoke.py FLAG OUT [ARG]`` runs in a process of its own
# (`isolated`; ``--ckpt-run`` is started by ``ckpt_path``'s own process)
CHILDREN = {"--eval-pass-a": eval_pass_a, "--eval-pass-b": eval_pass_b,
            "--serve-path": serve_phase, "--ckpt-path": ckpt_phase,
            "--ckpt-run": ckpt_run, "--obs-path": obs_phase,
            "--arch-reduced": arch_reduced, "--arch-llama": arch_llama,
            "--arch-mamba": arch_mamba, "--arch-moe": arch_moe,
            "--serve-arch-reduced": serve_arch_reduced,
            "--serve-arch-llama": serve_arch_llama,
            "--serve-arch-mamba": serve_arch_mamba,
            "--serve-arch-moe": serve_arch_moe, "--nvml-path": nvml_phase,
            "--mesh-path": mesh_phase}


def build_phase(build, kmod, card):
    """Phase 1: every CUDA source built at once; fails unless ptxas
    reported every specialised kernel (both dtypes; score, best and EM for
    each (D, K)) with no stack frame and no spill bytes."""
    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    kernels = ptxas_summary(logs)
    fixed = {k: v for k, v in kernels.items() if "_fixed<" in k}
    spills = {k: v for k, v in fixed.items()
              if v.get("spill", 0) or v.get("stack", 0)}
    emit({"phase": "build", "seconds": seconds, "sources": sorted(logs),
          "card": card, "instantiations": len(kernels),
          "specialised": len(fixed),
          "max_registers": {base: max((v.get("registers", 0)
                                       for k, v in kernels.items()
                                       if k.startswith(base + "<")),
                                      default=None)
                            for base in ("score_fixed", "score_general",
                                         "em_fixed", "em_general")},
          "ptxas": {k: [v.get("registers"), v.get("stack"), v.get("spill")]
                    for k, v in sorted(kernels.items())}})
    if len(fixed) != 6 * len(kmod.SPECIALISED):
        raise SmokeFailure(f"ptxas reported {len(fixed)} specialised "
                           f"kernels, not 6 x {len(kmod.SPECIALISED)}")
    if spills:
        raise SmokeFailure(f"specialised kernels use local memory "
                           f"(registers, stack, spill bytes): {spills}")


def kernel_check_phase(ops, kmod, smod):
    """Phase 2: every kernel against its plain version; the EM kernels
    bitwise repeatable, eager and from a CUDA graph; U in the EM loop's
    layout and NaN; both sides of the specialised / general boundary."""
    import torch

    t_phase = time.perf_counter()
    worst = {"gmm_score": 0.0, "gmm_best": 0.0}
    cases = 0
    for dtype, shapes in ((torch.float32, SHAPES), (torch.bfloat16,
                                                    BF16_SHAPES)):
        for i, (N, D, K) in enumerate(shapes):
            errs = check_case(ops, N, D, K, dtype, seed=i)
            worst = {k: max(worst[k], errs[k]) for k in worst}
            cases += 1
    check_ties_and_nan(ops)
    em_rel = {"gmm_stats": 0.0, "gmm_update": 0.0}
    for i, (N, D, K, dtype, nvalid) in enumerate(em_cases()):
        errs, rel = check_em_case(ops, N, D, K, dtype, seed=100 + i,
                                  nvalid=nvalid)
        worst.update({k: max(worst.get(k, 0.0), errs[k]) for k in errs})
        em_rel = {k: max(em_rel[k], rel[k]) for k in em_rel}
    layout_cases = check_layout_and_nan(ops)
    boundary = check_boundary(ops, kmod, smod)
    replays = check_em_graph_replay(ops)
    nvalid_zero = check_nvalid_zero(ops)
    emit({"phase": "kernel_check", "cases": cases + 2,
          "em_cases": len(em_cases()), "nvalid_zero_cases": nvalid_zero,
          "max_abs_err": worst,
          "em_max_rel_err": em_rel, "em_bitwise_repeatable": True,
          "transposed_and_nan_u_cases": layout_cases,
          "boundary": boundary, "em_graph_replays_bitwise": replays,
          "seconds": time.perf_counter() - t_phase})


def counters():
    """(reset_counts, read_counts, read_all_variants) over the kernel
    wrappers' launch counts, variants and the plain versions' calls."""
    from repro_torch.kernels import gmm_score as kmod, gmm_stats as smod, ref

    def reset_counts():
        for counts in (kmod.LAUNCHES, smod.LAUNCHES, ref.CALLS):
            for k in counts:
                counts[k] = 0
        for variants in (kmod.VARIANTS, smod.VARIANTS):
            for v in variants.values():
                v.update(specialised=0, general=0)

    def read_counts():
        return {**kmod.LAUNCHES, **smod.LAUNCHES}, dict(ref.CALLS)

    def read_all_variants():
        return {k: dict(v) for counts in (kmod.VARIANTS, smod.VARIANTS)
                for k, v in counts.items()}

    return reset_counts, read_counts, read_all_variants


def main() -> int:
    import torch

    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SmokeFailure("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    watch_device_probes()
    from repro_torch import quickstart
    from repro_torch.core.events import Layer
    from repro_torch.kernels import build, gmm_score as kmod, ops, ref
    from repro_torch.kernels import gmm_stats as smod

    card = nvidia_smi()
    power_limit_w = float(card.split(",")[1].strip().split()[0])

    build_phase(build, kmod, card)
    kernel_check_phase(ops, kmod, smod)

    # the train step's CUDA graph against the eager step
    t_phase = time.perf_counter()
    rel_loss, rel_grad = check_graphed_step()
    rel_step_loss, rel_step_params = check_graphed_train_step()
    emit({"phase": "graph_check", "max_rel_loss_err": rel_loss,
          "max_rel_grad_err": rel_grad,
          "train_step_max_rel_loss_err": rel_step_loss,
          "train_step_rel_params_err": rel_step_params,
          "seconds": time.perf_counter() - t_phase})

    reset_counts, read_counts, read_all_variants = counters()

    def read_variants(path):
        variants = read_all_variants()
        if any(v["general"] for v in variants.values()):
            raise SmokeFailure(f"{path} launched a general kernel: "
                               f"{variants}")
        return variants

    # 3. the main path on the card
    t_phase = time.perf_counter()
    reset_counts()
    out = quickstart.run(device="cuda", peak_w=power_limit_w)
    launches, plain_calls = read_counts()
    variants = read_variants("main_path")
    losses = out["losses"]
    hit, false = out["step_hit_rate"], out["step_false_rate"]
    emit({"phase": "main_path", "steps": out["steps"],
          "batch": out["batch"], "seq": out["seq"],
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "steps_per_s": out["steps_per_s"], "detect_s": out["detect_s"],
          "events": out["n_events"], "step_hit_rate": hit,
          "step_false_rate": false, "actions": len(out["actions"]),
          "step_ms_p10_p50_p90": out["step_ms_p10_p50_p90"],
          "layer_shapes": out["layer_shapes"],
          "rows_per_layer": out["rows_per_layer"],
          "runtime_probe": out["runtime_probe"], "launches": launches,
          "variants": variants, "plain_calls": plain_calls,
          "failed_samples": out["failed_samples"],
          "seconds": time.perf_counter() - t_phase})
    if not all(math.isfinite(float(v)) for v in losses):
        raise SmokeFailure("non-finite training loss")
    if Layer.STEP not in out["results"]:
        raise SmokeFailure("no STEP-layer detection result")
    if not (hit > 0.5 and hit > 2 * false):
        raise SmokeFailure(f"STEP detection too weak: hit {hit}, "
                           f"false {false}")
    if not out["actions"]:
        raise SmokeFailure("the governor returned no action")
    if not (launches["gmm_score"] and launches["gmm_best"]):
        raise SmokeFailure(f"a kernel was not launched: {launches}")
    if any(plain_calls.values()):
        raise SmokeFailure(f"plain versions ran on the main path: "
                           f"{plain_calls}")
    if out["failed_samples"]:
        raise SmokeFailure(f"device probe lost {out['failed_samples']} "
                           "samples")
    if not (out["rows_per_layer"]["operator"] and out["runtime_probe"]["rows"]
            and Layer.OPERATOR in out["results"]):
        raise SmokeFailure(f"main path: no operator or runtime-probe rows: "
                           f"{out['rows_per_layer']}, {out['runtime_probe']}")
    shape = max(out["layer_shapes"].values())

    # 3b. Table I's baselines and the GMM on the main path's STEP features
    table1_phase(out["columns"], out["labels"])
    del out

    # 4. the stream path on the card
    t_phase = time.perf_counter()
    reset_counts()
    st = quickstart.run_stream(device="cuda", peak_w=power_limit_w)
    s_launches, s_plain = read_counts()
    s_variants = read_variants("stream_path")
    emit({**stream_line(st, s_launches, s_plain), "variants": s_variants,
          "seconds": time.perf_counter() - t_phase})
    check_stream(st, s_launches, s_plain)
    del st

    # 5. the training entry point with the session, three modes
    from repro_torch.launch import train
    session = session_phase(train, reset_counts, read_counts, read_variants)

    # 6. the hierarchical fleet plane: 8 full-width nodes in 2 groups
    fleet = fleet_phase(quickstart, reset_counts, read_counts,
                        read_all_variants)

    # 7. the NumPy detector families through the launcher's stream session
    families_phase(train, reset_counts, read_counts,
                   session["modes"]["off"]["steady_steps_per_s"])

    # 7b. the launcher over a 1 x 1 mesh on NCCL, against the same run
    mesh = {"phase": "mesh_path", **isolated("--mesh-path", "mesh_path"),
            "session_path_batch_steady_steps_per_s":
                session["modes"]["batch"]["steady_steps_per_s"]}
    try:
        mesh["unmet"] = check_mesh(mesh)
    finally:
        emit(mesh)

    # 8. the scenario-matrix evaluation harness: the CI gate, then full width
    ev = eval_phase()

    # 8b. the device probe's NVML source: pass B's device cells, real readings
    nv = isolated("--nvml-path", "nvml_path")
    emit(nv)
    check_nvml(nv, power_limit_w)

    # 9. checkpointing: a run, a run stopped by SIGINT, its resume
    ck = isolated("--ckpt-path", "ckpt_path")
    ck_line = ckpt_line(ck)
    try:
        ck_line["unmet"] = check_ckpt(ck_line, ck["runs"])
    finally:
        emit(ck_line)

    # 10. the operator surface: the endpoint scraped, the board written
    ob = isolated("--obs-path", "obs_path")
    ob_line = {"phase": "obs_path", **ob,
               "session_path_stream_steady_steps_per_s":
                   session["modes"]["stream"]["steady_steps_per_s"]}
    emit(ob_line)
    check_obs(ob_line)

    # 11. the serve plane: the graphed slot step, the launcher, the gates
    sv = isolated("--serve-path", "serve_path")

    # 12. the reference's other families and training modes, a process each
    ar = arch_phase()

    # 13. decode and serving of the other families, a process each
    sa = serve_arch_phase()

    # 14. times at each path's largest shape and at scale
    t_phase = time.perf_counter()
    N, D, K = shape
    errs = check_case(ops, N, D, K, torch.float32, seed=99)
    errs.update(check_em_case(ops, *STREAM_FIT_SHAPE, torch.float32,
                              seed=98)[0])
    at_path = measure(ops, kmod, N, D, K, reps=200, library=True)
    at_path.update(measure_em(ops, smod, *STREAM_FIT_SHAPE, reps=200))
    shapes = {"gmm_score": shape, "gmm_best": shape,
              "gmm_stats": STREAM_FIT_SHAPE, "gmm_update": STREAM_FIT_SHAPE}
    paths = {"gmm_score": launches, "gmm_best": launches,
             "gmm_stats": s_launches, "gmm_update": s_launches}
    scaling = {f"N={n} D={d} K={k}": measure(ops, kmod, n, d, k, reps=50)
               for n, d, k in SCALING}
    scaling.update({f"N={n} D={d} K={k}": measure_em(ops, smod, n, d, k,
                                                     reps=50)
                    for n, d, k in EM_SCALING})
    emit({"phase": "kernel_scaling", "card": card, "shapes": scaling,
          "seconds": time.perf_counter() - t_phase})
    if not at_path["gmm_score"]["library_agrees"]:
        raise SmokeFailure(f"gmm_score's library call disagrees with the "
                           f"kernel beyond its tolerance: "
                           f"{at_path['gmm_score']['library_max_abs_err']}")
    for name, res in at_path.items():
        want = {"kernels": 1.0, "memsets": float(name in ("gmm_stats",
                                                          "gmm_update")),
                "memcpys": 0.0}
        if res["nodes"] != want:
            raise SmokeFailure(f"{name}: a wrapper call put {res['nodes']} "
                               f"on the stream, not {want}")

    t_phase = time.perf_counter()
    emit({"phase": "profile", "card": card, **profile_phase(N, D, K),
          "seconds": time.perf_counter() - t_phase})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": paths[name][name],
         "max_abs_err": errs[name], "ms": at_path[name]["ms"],
         "plain_ms": at_path[name]["plain_ms"],
         "bound_ms": at_path[name]["bound_ms"],
         "bound_by": at_path[name]["bound_by"],
         "library_ms": at_path[name]["library_ms"],
         "kernel_only_ms": at_path[name]["kernel_only_ms"],
         "host_ms": at_path[name]["host_ms"], "shape": list(shapes[name]),
         "path": "main_path" if paths[name] is launches else "stream_path",
         "launches_by_path": {"main_path": launches[name],
                              "stream_path": s_launches[name],
                              "fleet_path": fleet["launches"][name],
                              "eval_path": ev["launches"][name],
                              "ckpt_path": ck["launches"].get(name, 0),
                              "obs_path": ob["launches"][name],
                              "serve_path": sv["launches"][name],
                              "arch_path": ar["launches"][name],
                              "serve_arch_path": sa["launches"][name],
                              "mesh_path": mesh["launches"][name]},
         "kernels_per_call": at_path[name]["nodes"]["kernels"],
         "memsets_per_call": at_path[name]["nodes"]["memsets"],
         "variants_by_path": {"main_path": variants[name],
                              "stream_path": s_variants[name],
                              "fleet_path": fleet["variants"][name],
                              "eval_path": ev["variants"][name],
                              "ckpt_path": ck["variants"].get(name),
                              "obs_path": ob["variants"][name],
                              "serve_path": sv["variants"][name],
                              "arch_path": ar["variants"][name],
                              "serve_arch_path": sa["variants"][name],
                              "mesh_path": mesh["variants"][name]}}
        for name in ("gmm_score", "gmm_best", "gmm_stats", "gmm_update")],
        "smoke_seconds": time.perf_counter() - t_smoke})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] and sys.argv[1] in CHILDREN:
            sys.exit(child_main(*sys.argv[1:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
