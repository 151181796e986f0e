"""H2O-Danube3 4B — Llama/Mistral-mix dense decoder with sliding-window attention.

[arXiv:2401.16818 (danube series); unverified] 24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000. Mistral-style SWA (window 4096) with rolling-buffer KV
cache => sub-quadratic long-context decode (long_500k runs).
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("h2o-danube-3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=500_000.0,
        source="arXiv:2401.16818 (H2O-Danube); SWA per Mistral arXiv:2310.06825",
    )
