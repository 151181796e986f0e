"""Model FLOPs of a step (port of `repro/roofline.py:67-87`, the function
`model_flops` alone; the roofline analysis comes with a later slice)."""
from __future__ import annotations

from repro_torch.config import ModelConfig, ShapeConfig


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D (train) or 2·N_active·tokens (single forward/decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence + KV-cache attention reads
    tokens = shape.global_batch
    attn_extra = 0.0
    if cfg.n_heads and cfg.attn_kind != "none":
        span = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        n_attn = cfg.n_layers if cfg.attn_every == 0 else (
            cfg.n_layers // cfg.attn_every)
        hd = cfg.head_dim if cfg.attn_kind != "mla" else (
            cfg.kv_lora_rank + cfg.qk_rope_dim)
        heads = cfg.n_heads
        attn_extra = 4.0 * tokens * n_attn * heads * hd * span
    return 2.0 * n_active * tokens + attn_extra
