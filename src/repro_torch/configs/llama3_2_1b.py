"""Llama 3.2 1B — small dense Llama-3 decoder.

[hf:meta-llama/Llama-3.2-1B; unverified] 16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256. head_dim=64, RoPE theta 500k, SwiGLU, RMSNorm,
tied embeddings.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("llama3.2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500_000.0,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )
