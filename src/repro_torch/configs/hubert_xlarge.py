"""HuBERT X-Large — encoder-only audio transformer backbone.

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
The convolutional waveform frontend is a STUB: input_specs() provides precomputed
frame embeddings (batch, seq, d_model); the head predicts 504 cluster targets.
Encoder-only => bidirectional attention, no decode step.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        use_rope=False,
        norm_kind="layernorm",
        act="gelu",
        glu=False,
        input_mode="embeddings",
        source="arXiv:2106.07447 (HuBERT); wav2vec2 arch arXiv:2006.11477",
    )
