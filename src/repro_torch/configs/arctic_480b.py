"""Snowflake Arctic 480B — dense-MoE hybrid: 128-expert top-2 MoE residual to a dense FFN.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 in parallel with the dense FFN
(dense_residual=True). head_dim=128.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        rope_theta=10_000.0,
        n_experts=128,
        moe_top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
        source="hf:Snowflake/snowflake-arctic-base",
    )
