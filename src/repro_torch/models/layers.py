"""Primitive layers: norms, rotary embeddings, activations, initializers
(port of `repro/models/layers.py`).

Parameters live in one flat dict keyed by the names of
`repro_torch.config.param_shapes` ("layers.0.norm1.scale", ...); a layer
function takes that dict and its own prefix.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initializers (drawn from an explicit generator, on its device)
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape: Tuple[int, ...],
                scale: float = 0.02) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device)


def fanin_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """Scaled init for projection kernels: N(0, 1/fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) / math.sqrt(fan_in)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(params: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm / LayerNorm / non-parametric LayerNorm, computed in fp32."""
    dtype = x.dtype
    x = x.to(torch.float32)
    if cfg.norm_kind == "rmsnorm":
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + eps) * params[f"{prefix}.scale"]
    else:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        x = (x - mean) * torch.rsqrt(var + eps)
        if cfg.norm_kind == "layernorm":
            x = x * params[f"{prefix}.scale"] + params[f"{prefix}.bias"]
    return x.to(dtype)


def rms_norm_gated(scale: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated RMSNorm: RMSNorm(x * silu(gate)) * scale
    (`repro/models/layers.py:57`)."""
    dtype = x.dtype
    x = x.to(torch.float32) * F.silu(gate.to(torch.float32))
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE), `repro/models/layers.py:69-88`
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (...,
    seq). The reference's convention: the head's first and second halves
    are the pair rotated together (not interleaved)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

silu = F.silu

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]
