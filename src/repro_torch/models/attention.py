"""Full-sequence GQA attention — the ``gqa_forward`` of
`repro/models/attention.py`.

The reference computes it blockwise with an online softmax and a custom VJP
in plain jnp; no Pallas kernel stands behind it, so the port uses plain
PyTorch math and autograd. At the sequence lengths of the monitored workload
(hundreds of tokens) the (S, S) score matrix is small. Scores and softmax
run in float32; the value product runs in the compute dtype.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params

NEG_INF = -1e30


def gqa_forward(params: Params, prefix: str, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model); causal, no sliding window and
    no rotary embedding (`repro_torch.models.model` checks the config)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    q = x @ params[f"{prefix}.q.kernel"].to(x.dtype)
    k = x @ params[f"{prefix}.k.kernel"].to(x.dtype)
    v = x @ params[f"{prefix}.v.kernel"].to(x.dtype)
    q = q.view(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)  # (B, KV, G, S, hd)
    k = k.view(B, S, KV, 1, hd).permute(0, 2, 3, 1, 4)  # (B, KV, 1, S, hd)
    v = v.view(B, S, KV, 1, hd).permute(0, 2, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)).to(torch.float32) / math.sqrt(hd)
    if cfg.causal:
        pos = torch.arange(S, device=x.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype) @ v  # (B, KV, G, S, hd)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    return o @ params[f"{prefix}.out.kernel"].to(x.dtype)
