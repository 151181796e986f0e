"""Primitive layers of the dense path: norms, activations, initializers
(port of the parts of `repro/models/layers.py` GPT-2 uses).

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
# Initializers (drawn on the CPU from an explicit generator)
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape: Tuple[int, ...],
                scale: float = 0.02) -> torch.Tensor:
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def fanin_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """Scaled init for projection kernels: N(0, 1/fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return torch.randn(shape, generator=gen, dtype=torch.float32) \
        / math.sqrt(fan_in)


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


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]
