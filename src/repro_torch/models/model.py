"""Model composition for the dense family: init, forward, loss — the dense
branch of `repro/models/model.py`.

Parameters are one flat dict of float32 leaf tensors keyed by
`repro_torch.config.param_shapes` names. Kernels keep the reference's
``(d_in, d_out)`` layout and apply as ``x @ W``; the layer stack is a
Python loop over ``layers.{i}`` (the reference stacks layers on a leading
axis and scans them). The embedding is padded to `padded_vocab` and tied to
the head; padded logit columns are masked out of the loss. Weights are cast
to the compute dtype where they are used, so gradients reach the float32
masters.

Decode (`init_decode_caches`, `decode_step`) is one token a step against
per-layer KV caches that the step updates in place, with the reference's
per-slot ``start`` masking for continuous batching. MoE, SSM, hybrid and
MLA models come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, padded_vocab, param_shapes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import (Params, apply_norm, fanin_init,
                                       normal_init)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs (the reference's also carries the device mesh)."""

    compute_dtype: torch.dtype = torch.bfloat16


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the ported dense GPT-2 path."""
    unsupported = {
        "family": cfg.family != "dense",
        "attn_kind": cfg.attn_kind != "gqa",
        "use_rope": cfg.use_rope,
        "sliding_window": bool(cfg.sliding_window),
        "n_experts": bool(cfg.n_experts),
        "input_mode": cfg.input_mode != "tokens",
        "tie_embeddings": not cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (dense tied-"
            "embedding GQA without RoPE only)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random float32 parameters from a CPU generator seeded with ``seed``
    (the reference's distributions; `jax.random` bits cannot be
    reproduced, so parity tests load the reference's weights instead)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".scale"):
            t = torch.ones(shape)
        elif name.endswith(".bias"):
            t = torch.zeros(shape)
        elif name == "embed.table":
            t = normal_init(gen, shape)
        else:
            t = fanin_init(gen, shape)
        params[name] = t.to(dev).requires_grad_()
    return params


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _tf_block(params: Params, prefix: str, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    x = x + attn.gqa_forward(params, f"{prefix}.attn", cfg, h)
    h = apply_norm(params, f"{prefix}.norm2", cfg, x)
    return x + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)


def forward(params: Params, cfg: ModelConfig, rt: Runtime,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V_padded), aux_loss)."""
    table = params["embed.table"]
    # F.embedding, not indexing: at up to 3072 tokens its CUDA backward is a
    # single kernel with no host sync, so the step can be captured in a graph
    x = F.embedding(batch["tokens"].long(), table.to(rt.compute_dtype))
    for i in range(cfg.n_layers):
        x = _tf_block(params, f"layers.{i}", cfg, x)
    x = apply_norm(params, "final_norm", cfg, x)
    logits = x @ table.to(x.dtype).T
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

Caches = Dict[str, List[attn.Cache]]


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = None) -> Caches:
    """One KV cache per layer (the reference stacks them on a layer axis)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [attn.init_kv_cache(cfg, batch, max_len, dtype, dev)
                       for _ in range(cfg.n_layers)]}


def _tf_block_decode(params: Params, prefix: str, cfg: ModelConfig,
                     x: torch.Tensor, cache: attn.Cache,
                     index: Union[int, torch.Tensor],
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    x = x + attn.attention_decode(params, f"{prefix}.attn", cfg, h, cache,
                                  index, start=start)
    h = apply_norm(params, f"{prefix}.norm2", cfg, x)
    return x + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)


def decode_step(params: Params, cfg: ModelConfig, rt: Runtime,
                batch: Dict[str, torch.Tensor], caches: Caches,
                index: Union[int, torch.Tensor],
                start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One token step. batch: {"tokens": (B, 1)}. Returns (logits
    (B, 1, V_padded), caches), the caches updated in place.

    ``start``: optional (B,) — each sequence's first valid absolute
    position. Continuous-batching serving passes it so a request that
    joined the running batch mid-flight never attends to cache rows written
    by the slot's previous occupant (see `attention.gqa_decode`)."""
    table = params["embed.table"]
    x = F.embedding(batch["tokens"].long(), table.to(rt.compute_dtype))
    for i in range(cfg.n_layers):
        x = _tf_block_decode(params, f"layers.{i}", cfg, x,
                             caches["layers"][i], index, start=start)
    x = apply_norm(params, "final_norm", cfg, x)
    return x @ table.to(x.dtype).T, caches


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(params: Params, cfg: ModelConfig, rt: Runtime,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy; ignores labels < 0."""
    logits, aux = forward(params, cfg, rt, batch)
    labels = batch["labels"].long()
    pv = padded_vocab(cfg)
    logits = logits.to(torch.float32)
    if pv != cfg.vocab_size:  # mask padded vocab columns out of the lse
        col = torch.arange(pv, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (lse - ll) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + cfg.router_aux_coef * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": torch.sum(mask)}


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> int64 tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in batch.items()}
