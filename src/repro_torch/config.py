"""Configuration system of the PyTorch port (mirrors the JAX package's
``repro.config``).

Frozen dataclasses describing models, input shapes, training and serving.
Every assigned architecture lives in ``repro_torch/configs/<id>.py`` and registers
itself via :func:`register_arch`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (public-literature values)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention ---
    attn_kind: str = "gqa"  # gqa | mla | none
    causal: bool = True
    sliding_window: int = 0  # 0 -> full attention
    use_rope: bool = True
    rope_theta: float = 500_000.0
    qk_norm: bool = False

    # --- MLA (DeepSeek-V2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- norms / ffn ---
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np (non-parametric)
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated FFN (SwiGLU/GeGLU)
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0  # leading dense layers (DeepSeek-V2: 1)
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (Zamba2) ---
    attn_every: int = 0  # shared attention block every N layers (0 = never)

    # --- inputs ---
    input_mode: str = "tokens"  # tokens | embeddings (stub modality frontend)

    # --- source provenance ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # ---- derived properties -------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none" and self.attn_every == 0

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is supported (bounded per-token state)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder" and self.causal

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    # ---- analytic parameter count (embedding included) ----------------------
    def param_count(self) -> int:
        return sum(math.prod(s) for s in param_shapes(self).values())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        total = 0
        for name, shape in param_shapes(self).items():
            n = math.prod(shape)
            if ".experts." in name:
                n = n * self.moe_top_k // max(self.n_experts, 1)
            total += n
        return total


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 128 (Megatron-style) so the vocab axis is
    shardable over the model mesh axis; padded columns are masked in the loss."""
    return (cfg.vocab_size + 127) // 128 * 128


# ---------------------------------------------------------------------------
# Input-shape configuration (assigned shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Train / serve configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor
    schedule: str = "cosine"
    remat: str = "full"  # none | full | dots
    microbatches: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_allreduce_dtype: str = "bfloat16"  # gradient compression (bf16 vs fp32)
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _ARCH_REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    if name not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401

    return sorted(_ARCH_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs — same family, tiny dims, runnable on CPU
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Scale an architecture down for CPU smoke tests, preserving its family."""
    n_heads = min(cfg.n_heads, 4) or 0
    n_kv = 0
    if cfg.n_heads:
        ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        n_kv = max(n_heads // min(ratio, n_heads), 1)
    d_model = 64
    changes: Dict[str, Any] = dict(
        n_layers=4 if cfg.attn_every else 2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=(d_model // n_heads) if n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        sliding_window=32 if cfg.sliding_window else 0,
    )
    if cfg.attn_kind == "mla":
        changes.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                       qk_rope_dim=8, v_head_dim=16)
    if cfg.n_experts:
        changes.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                       d_ff_expert=64,
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16, ssm_conv=4)
    if cfg.attn_every:
        changes.update(attn_every=2)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Analytic parameter shapes (mirrors models/params.py init exactly;
# kept here so configs can report sizes without building arrays)
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat {name: shape} for every parameter of the model.

    Must stay in sync with repro_torch.models.model.init_params (tested).
    """
    d = cfg.d_model
    pv = padded_vocab(cfg)
    shapes: Dict[str, Tuple[int, ...]] = {}
    if cfg.input_mode == "tokens":
        shapes["embed.table"] = (pv, d)
    # final norm + lm head
    if cfg.norm_kind != "layernorm_np":
        shapes["final_norm.scale"] = (d,)
        if cfg.norm_kind == "layernorm":
            shapes["final_norm.bias"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head.kernel"] = (d, pv)

    def norm(prefix: str):
        if cfg.norm_kind != "layernorm_np":
            shapes[f"{prefix}.scale"] = (d,)
            if cfg.norm_kind == "layernorm":
                shapes[f"{prefix}.bias"] = (d,)

    def attention(prefix: str):
        hd = cfg.head_dim
        if cfg.attn_kind == "mla":
            shapes[f"{prefix}.q_down.kernel"] = (d, cfg.q_lora_rank)
            shapes[f"{prefix}.q_norm.scale"] = (cfg.q_lora_rank,)
            shapes[f"{prefix}.q_up.kernel"] = (
                cfg.q_lora_rank, cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim))
            shapes[f"{prefix}.kv_down.kernel"] = (d, cfg.kv_lora_rank + cfg.qk_rope_dim)
            shapes[f"{prefix}.kv_norm.scale"] = (cfg.kv_lora_rank,)
            shapes[f"{prefix}.kv_up.kernel"] = (
                cfg.kv_lora_rank, cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim))
            shapes[f"{prefix}.out.kernel"] = (cfg.n_heads * cfg.v_head_dim, d)
        else:
            shapes[f"{prefix}.q.kernel"] = (d, cfg.n_heads * hd)
            shapes[f"{prefix}.k.kernel"] = (d, cfg.n_kv_heads * hd)
            shapes[f"{prefix}.v.kernel"] = (d, cfg.n_kv_heads * hd)
            shapes[f"{prefix}.out.kernel"] = (cfg.n_heads * hd, d)

    def dense_ffn(prefix: str, d_ff: int):
        if cfg.glu:
            shapes[f"{prefix}.gate.kernel"] = (d, d_ff)
        shapes[f"{prefix}.up.kernel"] = (d, d_ff)
        shapes[f"{prefix}.down.kernel"] = (d_ff, d)

    def moe_ffn(prefix: str):
        e, dff = cfg.n_experts, cfg.d_ff_expert
        shapes[f"{prefix}.router.kernel"] = (d, e)
        if cfg.glu:
            shapes[f"{prefix}.experts.gate"] = (e, d, dff)
        shapes[f"{prefix}.experts.up"] = (e, d, dff)
        shapes[f"{prefix}.experts.down"] = (e, dff, d)
        if cfg.n_shared_experts:
            dense_ffn(f"{prefix}.shared", dff * cfg.n_shared_experts)

    def ssm(prefix: str):
        di, ng, st = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
        nh = cfg.ssm_nheads
        conv_dim = di + 2 * ng * st
        shapes[f"{prefix}.in_proj.kernel"] = (d, 2 * di + 2 * ng * st + nh)
        shapes[f"{prefix}.conv.kernel"] = (cfg.ssm_conv, conv_dim)
        shapes[f"{prefix}.A_log"] = (nh,)
        shapes[f"{prefix}.D"] = (nh,)
        shapes[f"{prefix}.dt_bias"] = (nh,)
        shapes[f"{prefix}.norm.scale"] = (di,)
        shapes[f"{prefix}.out_proj.kernel"] = (di, d)

    # --- per-layer blocks ---
    if cfg.family in ("ssm", "hybrid"):
        for i in range(cfg.n_layers):
            p = f"layers.{i}"
            norm(f"{p}.norm1")
            ssm(f"{p}.mixer")
        if cfg.attn_every:
            # single shared (weight-tied) attention + MLP block
            norm("shared.norm1")
            attention("shared.attn")
            norm("shared.norm2")
            dense_ffn("shared.ffn", cfg.d_ff)
    else:
        for i in range(cfg.n_layers):
            p = f"layers.{i}"
            norm(f"{p}.norm1")
            attention(f"{p}.attn")
            norm(f"{p}.norm2")
            is_moe = cfg.n_experts > 0 and i >= cfg.first_dense_layers
            if is_moe:
                moe_ffn(f"{p}.moe")
                if cfg.dense_residual:
                    dense_ffn(f"{p}.ffn", cfg.d_ff)
            else:
                dense_ffn(f"{p}.ffn", cfg.d_ff)
    return shapes


# ---------------------------------------------------------------------------
# How the reference stacks each parameter (its ``init_params`` pytree)
# ---------------------------------------------------------------------------


def hybrid_structure(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, n_tail) for hybrid layer stacks."""
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


Stacking = Tuple[str, Tuple[int, ...], Tuple[int, ...]]


def stack_layout(cfg: ModelConfig) -> Dict[str, Stacking]:
    """name -> (the reference's leaf, this layer's index into the leaf's
    stacked axes, those axes' sizes) for every `param_shapes` name.

    The reference's ``init_params`` stacks layers on leading axes (its
    ``vmap`` init and ``scan`` forward), not all alike: a transformer's
    ``layers`` is (n_layers - first_dense_layers, ...) after a *list*
    ``head_layers`` of unstacked leading dense layers; an SSM's ``layers``
    is (n_layers, ...); a hybrid's is (n_groups, group_size, ...) with the
    remainder in ``tail`` (n_tail, ...) and an unstacked ``shared`` block.
    Leaves outside the layers are unstacked: (name, (), ()). Weight decay
    and Adafactor's factoring follow the stacked leaf's rank, and
    Adafactor's moments and update clipping span the whole stacked leaf
    (`repro_torch.optim.optimizers`); `repro_torch.models.convert` maps
    the reference's trees onto these names."""
    out: Dict[str, Stacking] = {}
    fd = cfg.first_dense_layers if cfg.n_experts else 0
    hybrid = cfg.family in ("ssm", "hybrid") and cfg.attn_every
    if hybrid:
        n_groups, g, n_tail = hybrid_structure(cfg)
    for name in param_shapes(cfg):
        if not name.startswith("layers."):
            out[name] = (name, (), ())
            continue
        _, i, rest = name.split(".", 2)
        i = int(i)
        if cfg.family in ("ssm", "hybrid") and not hybrid:
            out[name] = (f"layers.{rest}", (i,), (cfg.n_layers,))
        elif hybrid and i < n_groups * g:
            out[name] = (f"layers.{rest}", (i // g, i % g), (n_groups, g))
        elif hybrid:
            out[name] = (f"tail.{rest}", (i - n_groups * g,), (n_tail,))
        elif i < fd:
            out[name] = (f"head_layers.{i}.{rest}", (), ())
        else:
            out[name] = (f"layers.{rest}", (i - fd,), (cfg.n_layers - fd,))
    return out
