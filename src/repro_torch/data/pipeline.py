"""Deterministic, shard-aware synthetic data pipeline.

Every batch is a pure function of (seed, step, host) via counter-based Philox
bits — restart/elastic-resharding safe *by construction*: after preemption the
pipeline resumes at any step with zero state, and a different host layout
re-slices the same global batch (the skip-ahead property real pipelines build
grouped checkpoints for).

Token stream: Zipf-distributed ids with short-range Markov structure so small
models show a real (slowly falling) loss curve instead of memorising noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.config import ModelConfig


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.local_batch = self.global_batch // self.n_hosts
        # fixed "unigram" table (same for all hosts/steps)
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        V = self.cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        self.probs = probs / probs.sum()
        self.perm = rng.permutation(V)

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: (seed, step, host) fully determines the stream
        key = (np.uint64(self.seed) << np.uint64(32)) | np.uint64(step)
        return np.random.default_rng(
            np.random.Philox(key=[int(key), self.host_id]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, V = self.local_batch, self.seq_len, self.cfg.vocab_size
        base = rng.choice(V, size=(B, S), p=self.probs)
        # short-range structure: with p=0.3 copy the previous token + 1 (mod V)
        copy = rng.random((B, S)) < 0.3
        toks = base.copy()
        for t in range(1, S):
            toks[:, t] = np.where(copy[:, t], (toks[:, t - 1] + 1) % V,
                                  base[:, t])
        toks = self.perm[toks].astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
        if self.cfg.input_mode == "embeddings":
            # stub modality frontend: deterministic embeddings from token ids
            d = self.cfg.d_model
            emb_rng = self._rng(step ^ 0x7F)
            emb = emb_rng.standard_normal((B, S, d), dtype=np.float32)
            return {"embeddings": emb, "labels": toks}  # predict frame targets
        return {"tokens": toks, "labels": labels}
