"""Mamba2 2.7B — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060; unverified] 64L d_model=2560 d_ff=0 vocab=50280,
ssm_state=128, headdim=64, expand=2. Attention-free => long_500k decode runs
with O(1)/token state.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("mamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        use_rope=False,
        glu=False,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        tie_embeddings=True,
        source="arXiv:2405.21060 (Mamba-2 / SSD)",
    )
