"""Dense feed-forward (SwiGLU / GELU-MLP) — port of `repro/models/ffn.py`.
On a mesh whose model axis divides the hidden width, each rank computes
its hidden units (its pieces of the weights) and the ranks' outputs are
summed (Megatron's MLP)."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, activation


def ffn_width(cfg: ModelConfig, prefix: str) -> int:
    """The hidden width of the MLP at ``prefix``: an MoE layer's shared
    experts', else the config's ``d_ff``."""
    if prefix.endswith(".moe.shared"):
        return cfg.d_ff_expert * cfg.n_shared_experts
    return cfg.d_ff


def ffn_forward(params: Params, prefix: str, cfg: ModelConfig,
                x: torch.Tensor, rt=None) -> torch.Tensor:
    tp = rt is not None and rt.model_divides(ffn_width(cfg, prefix))
    if tp:
        x = rt.tp_enter(x)
    act = activation(cfg.act)
    up = x @ params[f"{prefix}.up.kernel"].to(x.dtype)
    if cfg.glu:
        gate = x @ params[f"{prefix}.gate.kernel"].to(x.dtype)
        h = act(gate) * up
    else:
        h = act(up)
    y = h @ params[f"{prefix}.down.kernel"].to(x.dtype)
    return rt.tp_exit(y) if tp else y
