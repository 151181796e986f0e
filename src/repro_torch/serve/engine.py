"""Batched serving engine: prefill/decode step factories + a request loop
with greedy/temperature sampling (port of `repro/serve/engine.py`).

`make_decode_step` is one new token against a KV cache of ``max_len`` (the
reference's serve_step). The reference jit-compiles it and donates the
caches; here the step updates the caches in place, and on a CUDA device
`ServeEngine` replays it as a CUDA graph (`GraphedDecodeStep`), as
`train.step.CudaGraphed` does for training: eager, its few hundred small
launches would be paid for on the host every token.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.model import (Runtime, decode_step, forward,
                                      init_decode_caches)


def make_prefill(cfg: ModelConfig, rt: Runtime) -> Callable:
    """Full-sequence forward returning logits (inference-prefill cell)."""

    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = forward(params, cfg, rt, batch)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig, rt: Runtime) -> Callable:
    """serve_step: (params, token_batch, caches, index) -> (logits, caches)."""

    def step(params, batch, caches, index):
        with torch.no_grad():
            return decode_step(params, cfg, rt, batch, caches, index)

    return step


def cache_leaves(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a cache tree (dicts and lists), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from cache_leaves(tree[k])
    else:
        for v in tree:
            yield from cache_leaves(v)


class GraphedStep:
    """A decode-shaped step ``fn(params, caches, *inputs) -> (logits,
    caches)`` run on the caches' device, captured in one CUDA graph there
    and replayed.

    ``inputs`` come from the host (NumPy arrays, ints, CPU tensors); their
    values change every call, their shapes do not. The caches and the
    parameters are read and written by address, so they must stay the same
    tensors (checked). On the CPU every call runs ``fn`` eagerly. On the
    card the first ``WARMUP`` calls do too, on the caller's stream (lazy
    library set-up must not happen during capture); the next packs its
    inputs into one static int64 buffer on the card, captures ``fn`` over
    views of it, and replays; later calls copy and replay. The inputs reach
    the card in one host-to-device copy a call. On the card the logits
    returned are the graph's own buffer, overwritten by the next replay."""

    WARMUP = 2

    def __init__(self, fn: Callable):
        self.fn = fn
        self.calls = 0
        self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._buf: Optional[torch.Tensor] = None
        self._ptrs: List[int] = []
        self._out = None

    def __call__(self, params, caches, *inputs):
        self.calls += 1
        host = [torch.as_tensor(x) for x in inputs]
        leaves = list(cache_leaves(caches))
        dev = leaves[0].device
        if dev.type != "cuda" or self.calls <= self.WARMUP:
            return self.fn(params, caches, *[h.to(dev) for h in host])
        flat = torch.cat([h.reshape(-1).to(torch.int64) for h in host])
        ptrs = [t.data_ptr() for t in leaves]
        if self.graph is None:
            self._buf = torch.empty_like(flat, device=dev)
            self._buf.copy_(flat)
            self._ptrs = ptrs
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                views, off = [], 0
                for h in host:  # the casts are part of the graph
                    v = self._buf[off:off + h.numel()].view(h.shape)
                    views.append(v != 0 if h.dtype == torch.bool
                                 else v.to(h.dtype))
                    off += h.numel()
                self._out = self.fn(params, caches, *views)
        else:
            if ptrs != self._ptrs:
                raise ValueError("the caches moved since the graph was "
                                 "captured: pass the same cache tensors")
            if flat.shape != self._buf.shape:
                raise ValueError("the step's inputs changed shape since the "
                                 "graph was captured")
            self._buf.copy_(flat)  # pageable: the host may reuse it at once
        self.graph.replay()
        self.replays += 1
        return self._out


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    rt: Runtime
    params: Any
    batch_size: int
    max_len: int
    temperature: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.device = next(iter(self.params.values())).device
        self.caches = init_decode_caches(self.cfg, self.batch_size,
                                         self.max_len, device=self.device)
        step = make_decode_step(self.cfg, self.rt)
        self._graphed = GraphedStep(
            lambda params, caches, tokens, index:
            step(params, self._inputs(tokens), caches, index))
        self.gen = torch.Generator().manual_seed(self.seed)

    def _inputs(self, tokens: torch.Tensor):
        """The step's model inputs: the tokens, or for a model that takes
        embeddings, zero embeddings (B, 1, d_model) in the compute dtype,
        as the reference's engine feeds."""
        if self.cfg.input_mode == "tokens":
            return {"tokens": tokens}
        return {"embeddings": torch.zeros(
            (tokens.shape[0], 1, self.cfg.d_model),
            dtype=self.rt.compute_dtype, device=tokens.device)}

    def _step(self, params, batch, caches, index):
        """serve_step with the reference's signature (what a monitor
        wraps): ``batch["tokens"]`` on the host; a graph replay on the
        card."""
        return self._graphed(params, caches, batch["tokens"], index)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        logits = logits[:, -1, : self.cfg.vocab_size].float().cpu()
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).numpy().astype(np.int32)
        p = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(p, 1, generator=self.gen)[:, 0].numpy() \
            .astype(np.int32)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 step_hook: Optional[Callable] = None) -> np.ndarray:
        """prompts: (B, P) int32 (consumed token-by-token: teacher-forced
        prefill through the decode path, then free-running generation)."""
        B, P = prompts.shape
        assert B == self.batch_size
        out = np.zeros((B, P + n_tokens), np.int32)
        out[:, :P] = prompts
        tok = prompts[:, :1]
        for t in range(P + n_tokens - 1):
            logits, self.caches = self._step(self.params, {"tokens": tok},
                                             self.caches, t)
            nxt = self._sample(logits)
            if t + 1 < P:
                nxt = out[:, t + 1]  # teacher-forced prefill
            else:
                out[:, t + 1] = nxt
            tok = nxt[:, None]
            if step_hook is not None:
                step_hook(t, logits)
        return out
