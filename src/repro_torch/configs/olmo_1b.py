"""OLMo 1B — dense decoder with non-parametric LayerNorm.

[arXiv:2402.00838; hf] 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
OLMo uses non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("olmo-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        rope_theta=10_000.0,
        norm_kind="layernorm_np",
        tie_embeddings=True,
        source="arXiv:2402.00838 (OLMo)",
    )
