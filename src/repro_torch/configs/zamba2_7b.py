"""Zamba2 7B — hybrid Mamba2 backbone with a shared (weight-tied) attention block.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64. One shared attention+MLP block is applied every 6
Mamba2 layers (weight-tied across invocations, additive residual — the LoRA
per-invocation deltas of the real model are omitted, as in `repro.configs`).
Hybrid => long_500k decode runs (bounded state; shared-attn KV bounded by
window of the decode step).
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("zamba2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        attn_every=6,
        sliding_window=4096,  # bound the shared block's KV for long-context decode
        rope_theta=10_000.0,
        source="arXiv:2411.15242 (Zamba2)",
    )
