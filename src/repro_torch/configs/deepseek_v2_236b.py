"""DeepSeek-V2 236B — MLA attention + fine-grained MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf] 60L d_model=5120 128H (kv=128 latent) vocab=102400.
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
MoE: 160 routed experts top-6 + 2 shared experts, d_ff_expert=1536; first layer
is dense with d_ff=12288 (paper). Full-span attention (MLA compresses the cache
but not the span) => long_500k skipped.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # dense first layer (paper); experts use d_ff_expert
        vocab_size=102400,
        attn_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        n_experts=160,
        n_shared_experts=2,
        moe_top_k=6,
        d_ff_expert=1536,
        first_dense_layers=1,
        source="arXiv:2405.04434 (DeepSeek-V2)",
    )
