"""Request-plane data model: per-request lifecycle accounting, the admission
queue, and a deterministic multi-tenant load generator (port of
`repro/serve/request.py`; only the imports differ).

A `Request` carries the four lifecycle stamps the SLO monitor judges
(enqueue -> admit -> first token -> finish) plus the derived per-request
metrics (queue wait, TTFT, TPOT, end-to-end latency, tokens/s). The
`LoadGenerator` is the serve-path analogue of the chaos injector's fault
schedule: arrivals are a pure function of ``(seed, step)``, so every run of a
scenario sees the same request stream — and the serve-plane fault kinds
(``tenant_flood``, ``heavy_prompt_skew``, ``slow_client_stall``) perturb the
*request mix*, not the probes (the request plane is the layer under test).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle accounting."""

    req_id: int
    tenant: int
    prompt: np.ndarray  # (P,) int32 token ids
    max_new_tokens: int
    enqueue_ts: float
    # per-token client-side delivery delay (slow-client modelling): every
    # generated token's delivery lags compute by this much, cumulatively
    client_stall_s: float = 0.0
    # engine-filled lifecycle stamps (engine clock; -1 = not reached)
    admit_ts: float = -1.0
    first_token_ts: float = -1.0
    finish_ts: float = -1.0
    start_index: int = -1  # absolute cache position of prompt[0]
    tokens_out: int = 0
    stall_s: float = 0.0  # accumulated client-stall folded into delivery
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.admit_ts - self.enqueue_ts)

    @property
    def ttft(self) -> float:
        """Enqueue -> first delivered token (queue wait included: the SLO is
        the client's, and the client cannot see admission)."""
        return max(0.0, self.first_token_ts - self.enqueue_ts)

    @property
    def tpot(self) -> float:
        """Mean inter-token delivery time after the first token."""
        if self.tokens_out <= 1:
            return 0.0
        return max(0.0, (self.finish_ts - self.first_token_ts)
                   / (self.tokens_out - 1))

    @property
    def e2e(self) -> float:
        return max(0.0, self.finish_ts - self.enqueue_ts)

    @property
    def tokens_per_s(self) -> float:
        span = self.finish_ts - self.admit_ts
        return self.tokens_out / span if span > 0 else 0.0

    def record(self, step: int) -> Dict[str, float]:
        """The flat per-request record published to the request probe."""
        return {
            "req_id": self.req_id, "tenant": self.tenant, "step": step,
            "enqueue_ts": self.enqueue_ts, "admit_ts": self.admit_ts,
            "first_token_ts": self.first_token_ts,
            "finish_ts": self.finish_ts,
            "prompt_len": self.prompt_len, "tokens_out": self.tokens_out,
            "queue_wait": self.queue_wait, "ttft": self.ttft,
            "tpot": self.tpot, "e2e": self.e2e, "stall_s": self.stall_s,
        }


class RequestQueue:
    """FIFO admission queue with per-tenant depth accounting."""

    def __init__(self, max_depth: Optional[int] = None):
        self.max_depth = max_depth
        self._q: Deque[Request] = collections.deque()
        self.enqueued = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> bool:
        """Enqueue; returns False (and counts a rejection) when full."""
        if self.max_depth is not None and len(self._q) >= self.max_depth:
            self.rejected += 1
            return False
        self._q.append(req)
        self.enqueued += 1
        return True

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        return self._q.popleft()

    def tenant_depths(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for r in self._q:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out


class LoadGenerator:
    """Deterministic multi-tenant arrival process, indexed by engine step.

    ``arrivals(step, now, faults)`` is a pure function of ``(seed, step,
    faults)``: the base stream draws a Poisson arrival count at ``rate``
    requests per step, a tenant from ``tenants`` (normalised weights), a
    prompt length and a generation budget from their ranges. Serve-plane
    fault kinds perturb the draw:

    * ``tenant_flood``    — the flood tenant (tenant 0) arrives at
                            ``magnitude`` x its base share of the rate.
    * ``heavy_prompt_skew`` — prompt lengths scale by ``magnitude``
                            (clipped to ``prompt_len`` range's cap x mag).
    * ``slow_client_stall`` — new requests carry ``client_stall_s =
                            magnitude`` (seconds of client-side delay per
                            delivered token).
    """

    FLOOD_TENANT = 0

    def __init__(self, rate: float, num_requests: Optional[int] = None,
                 seed: int = 0, tenants: Sequence[float] = (0.5, 0.3, 0.2),
                 prompt_len: Tuple[int, int] = (4, 24),
                 max_new: Tuple[int, int] = (4, 16),
                 vocab_size: int = 256):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.num_requests = num_requests
        self.seed = int(seed)
        w = np.asarray(tenants, dtype=np.float64)
        self.tenants = w / w.sum()
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_new = (int(max_new[0]), int(max_new[1]))
        self.vocab_size = int(vocab_size)
        self.generated = 0

    @property
    def done(self) -> bool:
        return (self.num_requests is not None
                and self.generated >= self.num_requests)

    def _rng(self, step: int) -> np.random.Generator:
        # same per-step mixing constant as the chaos injector: arrivals are
        # reproducible from (seed, step) alone
        return np.random.default_rng(
            (self.seed * 9973 + step * 2654435761) % (2 ** 31))

    def _make(self, rng: np.random.Generator, now: float, tenant: int,
              plen_scale: float, stall_s: float) -> Request:
        lo, hi = self.prompt_len
        plen = int(rng.integers(lo, hi + 1))
        plen = max(1, min(int(round(plen * plen_scale)),
                          int(hi * max(plen_scale, 1.0))))
        prompt = rng.integers(1, self.vocab_size, size=plen,
                              dtype=np.int64).astype(np.int32)
        n_new = int(rng.integers(self.max_new[0], self.max_new[1] + 1))
        req = Request(req_id=self.generated, tenant=tenant, prompt=prompt,
                      max_new_tokens=n_new, enqueue_ts=now,
                      client_stall_s=stall_s)
        self.generated += 1
        return req

    def arrivals(self, step: int, now: float,
                 faults: Optional[Dict[str, float]] = None) -> List[Request]:
        """Requests arriving at ``step`` (stamped ``enqueue_ts = now``)."""
        if self.done:
            return []
        faults = faults or {}
        rng = self._rng(step)
        plen_scale = max(1.0, faults.get("heavy_prompt_skew", 0.0)) \
            if "heavy_prompt_skew" in faults else 1.0
        stall_s = float(faults.get("slow_client_stall", 0.0))
        out: List[Request] = []
        n_base = int(rng.poisson(self.rate))
        for _ in range(n_base):
            tenant = int(rng.choice(len(self.tenants), p=self.tenants))
            out.append(self._make(rng, now, tenant, plen_scale, stall_s))
            if self.done:
                return out
        flood = faults.get("tenant_flood", 0.0)
        if flood > 1.0:
            extra_rate = self.rate * self.tenants[self.FLOOD_TENANT] \
                * (flood - 1.0)
            for _ in range(int(rng.poisson(extra_rate))):
                out.append(self._make(rng, now, self.FLOOD_TENANT,
                                      plen_scale, stall_s))
                if self.done:
                    return out
        return out
