"""GPT-2 (124M) — the paper's monitored workload (eACGM §V evaluates on GPT-2 training).

[Radford et al. 2019] 12L d_model=768 12H d_ff=3072 vocab=50257. Used by the
benchmarks/examples as the monitored training job, mirroring the paper's setup.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("gpt2")
def config() -> ModelConfig:
    return ModelConfig(
        name="gpt2",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=50257,
        use_rope=False,  # learned positions in the original; stubbed as no-pos
        norm_kind="layernorm",
        act="gelu",
        glu=False,
        tie_embeddings=True,
        source="GPT-2 (Radford et al., 2019) — paper's monitored workload",
    )
