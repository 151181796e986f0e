"""Dense feed-forward (SwiGLU / GELU-MLP) — port of `repro/models/ffn.py`."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, activation


def ffn_forward(params: Params, prefix: str, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    up = x @ params[f"{prefix}.up.kernel"].to(x.dtype)
    if cfg.glu:
        gate = x @ params[f"{prefix}.gate.kernel"].to(x.dtype)
        h = act(gate) * up
    else:
        h = act(up)
    return h @ params[f"{prefix}.down.kernel"].to(x.dtype)
