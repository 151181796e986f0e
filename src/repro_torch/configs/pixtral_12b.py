"""Pixtral 12B — VLM: Pixtral-ViT frontend (STUB) + Mistral-NeMo-class decoder.

[hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072. Only the transformer BACKBONE is modelled; the vision
tower is a stub — input_specs() provides precomputed patch/text embeddings
(batch, seq, d_model). head_dim=128.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
        input_mode="embeddings",
        source="hf:mistralai/Pixtral-12B-2409",
    )
