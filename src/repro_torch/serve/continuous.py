"""Continuous-batching serve engine with per-request accounting (port of
`repro/serve/continuous.py`).

Interleaves prefill and decode over the slot-based KV caches that
`init_decode_caches` already allocates for the fixed-batch `ServeEngine`:
each batch lane is a *slot* a request can join or leave mid-flight, so a
short request finishing never waits for the longest request in its batch
(the convoy effect that caps fixed-batch throughput).

Correctness of mid-flight joins rests on two mechanisms, both inside the
one step (`make_slot_step`):

* **per-slot start masking** — all slots share the engine's absolute decode
  ``index``, so a joining request's lane still holds K/V rows written by the
  slot's previous occupant. `decode_step`'s ``start`` vector masks attention
  to positions ``>= start[slot]``, which on models without positional
  embeddings makes a joined generation bit-exact with a fresh static batch.
  With RoPE a request that joins at ``start = s`` is rotated at absolute
  positions s, s+1, ..., as in the reference: it equals a static batch
  run at those positions, not one started at 0.
* **join-time recurrent reset** — attention caches are position-addressed
  and maskable, but recurrent cache leaves (the reference's SSM ``state``/
  ``conv``) are not: `_reset_joined` zeroes exactly those for joining
  lanes before the step runs (SSM and hybrid models).

On a CUDA device the slot step is captured once in a CUDA graph over the
engine's static caches and replayed every step (`engine.GraphedStep`):
the tokens, the index, the ``start`` vector and the join mask are the
graph's inputs, copied in each step, so a join changes inputs, never the
graph. On the CPU it runs eagerly.

Timestamps come from an injectable clock. `VirtualClock` advances a fixed
``dt`` per engine step, which makes every latency metric (queue wait, TTFT,
TPOT) a deterministic function of scheduling alone — that is what the SLO
eval scenarios and tests run on; wall-clock serving uses the default
``time.perf_counter``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import decode_step, init_decode_caches
from repro_torch.serve import probe as request_probe
from repro_torch.serve.engine import GraphedStep
from repro_torch.serve.request import LoadGenerator, Request, RequestQueue
from repro_torch.serve.scheduler import AdmissionScheduler


class VirtualClock:
    """Deterministic engine clock: ``dt`` virtual seconds per step."""

    def __init__(self, dt: float = 0.02):
        self.dt = float(dt)
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.dt


def _reset_joined(caches, join_mask: torch.Tensor):
    """Zero per-lane recurrent state (``state``/``conv`` leaves, lane axis
    first) for joining slots, in place, wherever they are in the cache
    tree (an SSM's ``layers``, a hybrid's ``layers`` and ``tail``).
    Attention k/v/pos (and MLA's latent) leaves are untouched: stale rows
    there are excluded by the per-slot ``start`` mask instead."""
    if isinstance(caches, dict):
        for name, leaf in caches.items():
            if name in ("state", "conv"):
                keep = ~join_mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
                leaf.mul_(keep.to(leaf.dtype))
            elif not isinstance(leaf, torch.Tensor):
                _reset_joined(leaf, join_mask)
    else:
        for sub in caches:
            _reset_joined(sub, join_mask)
    return caches


def make_slot_step(cfg, rt):
    """Build the slot-aware decode step: ``(params, batch, caches, index,
    start, join_mask) -> (logits, caches)``."""

    def step(params, batch, caches, index, start, join_mask):
        with torch.no_grad():
            caches = _reset_joined(caches, join_mask)
            return decode_step(params, cfg, rt, batch, caches, index,
                               start=start)

    return step


class ContinuousBatchingEngine:
    """Slot-based serving over a shared decode index.

    ``slots`` is the batch width (concurrent requests); ``max_len`` the
    position budget shared by all slots — the admission scheduler guarantees
    a request only joins when its full generation fits, and rewinds the
    index to 0 (epoch reset) when the engine drains idle.
    """

    def __init__(self, cfg, rt, params, slots: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 dtype: torch.dtype = torch.bfloat16):
        if getattr(cfg, "input_mode", "tokens") != "tokens":
            raise ValueError("continuous batching requires token inputs")
        self.cfg, self.rt, self.params = cfg, rt, params
        self.slots, self.max_len = int(slots), int(max_len)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.clock = clock if clock is not None else time.perf_counter
        self.device = next(iter(params.values())).device
        self.caches = init_decode_caches(cfg, self.slots, self.max_len,
                                         dtype=dtype, device=self.device)
        slot_step = make_slot_step(cfg, rt)
        self._step_fn = GraphedStep(
            lambda params, caches, tokens, index, start, join:
            slot_step(params, {"tokens": tokens}, caches, index, start, join))
        self.scheduler = AdmissionScheduler(self.max_len)
        self._reqs: List[Optional[Request]] = [None] * self.slots
        self._rngs: List[Optional[np.random.Generator]] = [None] * self.slots
        self._ppos = np.zeros(self.slots, dtype=np.int64)  # prompt tokens fed
        self._tok = np.zeros((self.slots, 1), dtype=np.int32)
        self._start = np.zeros(self.slots, dtype=np.int32)
        self._join = np.zeros(self.slots, dtype=bool)
        self.index = 0
        self.decode_steps = 0
        self.nonfinite_steps = 0  # steps whose logits held a NaN or an inf
        self.finished: List[Request] = []
        self._occ_sum = 0.0
        self._occ_n = 0

    # -- scheduling ---------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._reqs)

    def admit(self, queue: RequestQueue) -> int:
        """Admit queued requests into free slots (FCFS, capacity-guarded)."""
        if self.scheduler.epoch_reset(queue.peek(), self.index,
                                      self.n_active):
            self.index = 0
            self.scheduler.epoch_resets += 1
        free = [i for i, r in enumerate(self._reqs) if r is None]
        picked = self.scheduler.select(queue, self.index, len(free))
        now = self.clock()
        for slot, req in zip(free, picked):
            req.admit_ts = now
            req.start_index = self.index
            self._reqs[slot] = req
            self._rngs[slot] = np.random.default_rng(
                (self.seed * 7919 + req.req_id) % (2 ** 31))
            self._ppos[slot] = 0
            self._tok[slot, 0] = req.prompt[0]
            self._start[slot] = self.index
            self._join[slot] = True
        return len(picked)

    # -- decode -------------------------------------------------------------

    def _sample(self, slot: int, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        return int(self._rngs[slot].choice(p.shape[0], p=p / p.sum()))

    def step(self, step: int = -1) -> bool:
        """Run one interleaved prefill/decode step; False when idle."""
        active = [i for i, r in enumerate(self._reqs) if r is not None]
        if not active:
            return False
        logits, self.caches = self._step_fn(
            self.params, self.caches, self._tok, self.index, self._start,
            self._join)
        self._join[:] = False
        vocab = self.cfg.vocab_size
        logits_np = logits[:, -1, :vocab].float().cpu().numpy()
        if not np.isfinite(logits_np[active]).all():
            self.nonfinite_steps += 1
        now = self.clock()
        for slot in active:
            req = self._reqs[slot]
            self._ppos[slot] += 1
            if self._ppos[slot] < req.prompt_len:
                # teacher-forced prefill: feed the next prompt token
                self._tok[slot, 0] = req.prompt[self._ppos[slot]]
                continue
            nxt = self._sample(slot, logits_np[slot])
            req.tokens.append(nxt)
            req.tokens_out += 1
            req.stall_s += req.client_stall_s
            deliver = now + req.stall_s
            if req.first_token_ts < 0:
                req.first_token_ts = deliver
            if req.tokens_out >= req.max_new_tokens:
                req.finish_ts = deliver
                self.finished.append(req)
                self._reqs[slot] = None
                self._rngs[slot] = None
                request_probe.publish("request", req.record(step))
            else:
                self._tok[slot, 0] = nxt
        self.index += 1
        self.decode_steps += 1
        self._occ_sum += len(active) / self.slots
        self._occ_n += 1
        return True

    def sample(self, queue: RequestQueue, step: int = -1,
               admitted: int = 0) -> None:
        """Publish the per-step queue-depth/occupancy sample."""
        request_probe.publish("sample", {
            "ts": self.clock(), "step": step, "depth": float(len(queue)),
            "occupancy": self.n_active / self.slots,
            "admitted": float(admitted),
        })

    @property
    def mean_occupancy(self) -> float:
        return self._occ_sum / self._occ_n if self._occ_n else 0.0

    def reset(self) -> None:
        """Return to an empty epoch, keeping the captured step and cache
        buffers (stale cache contents are masked/zeroed on the next join).
        Lets a caller reuse one engine across warmup and measured runs."""
        self._reqs = [None] * self.slots
        self._rngs = [None] * self.slots
        self._ppos[:] = 0
        self._tok[:] = 0
        self._start[:] = 0
        self._join[:] = False
        self.index = 0
        self.decode_steps = 0
        self.nonfinite_steps = 0
        self.finished = []
        self._occ_sum = 0.0
        self._occ_n = 0
        self.scheduler = AdmissionScheduler(self.max_len)

    # -- loops --------------------------------------------------------------

    def tick(self, step: int, load: Optional[LoadGenerator],
             queue: RequestQueue,
             faults_for_step: Optional[Callable[[int], Dict[str, float]]]
             = None) -> None:
        """One scheduling round: arrivals -> admission -> decode -> sample."""
        if load is not None:
            now = self.clock()
            faults = faults_for_step(step) if faults_for_step else None
            for req in load.arrivals(step, now, faults):
                queue.push(req)
        admitted = self.admit(queue)
        self.step(step=step)
        self.sample(queue, step=step, admitted=admitted)
        if isinstance(self.clock, VirtualClock):
            self.clock.advance()

    def run(self, load: LoadGenerator, n_steps: Optional[int] = None,
            queue: Optional[RequestQueue] = None,
            faults_for_step: Optional[Callable[[int], Dict[str, float]]]
            = None,
            on_step: Optional[Callable[[int], None]] = None,
            drain: bool = True, max_steps: int = 100_000) -> RequestQueue:
        """Drive the engine: ``n_steps`` rounds, then (with ``drain``) keep
        stepping until the load is exhausted and all requests finished."""
        queue = queue if queue is not None else RequestQueue()
        s = 0
        while s < max_steps:
            past_horizon = n_steps is not None and s >= n_steps
            idle = not len(queue) and self.n_active == 0
            if past_horizon and (not drain or idle):
                break
            if n_steps is None and load.done and idle:
                break
            # arrivals stop at the horizon; drain only finishes in-flight work
            self.tick(s, None if past_horizon else load, queue,
                      faults_for_step)
            if on_step is not None:
                on_step(s)
            s += 1
        return queue
