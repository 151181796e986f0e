"""SmolLM 135M — tiny Llama-architecture dense decoder.

[hf:HuggingFaceTB/SmolLM-135M; hf] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("smollm-135m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        rope_theta=10_000.0,
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
