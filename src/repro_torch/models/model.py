"""Model composition: init, forward, loss for every family of
`repro/models/model.py` (dense, moe with dense residual and leading dense
layers, ssm, hybrid, encoder, vlm backbone; `:94-150, 175-316`), and
decode for every family but the encoder (`:328-459`).

Parameters are one flat dict of float32 leaf tensors keyed by
`repro_torch.config.param_shapes` names. Kernels keep the reference's
``(d_in, d_out)`` layout and apply as ``x @ W``; the layer stack is a
Python loop over ``layers.{i}`` (the reference stacks layers on leading
axes and scans them: `repro_torch.config.stack_layout`). The embedding is
padded to `padded_vocab`, tied to the head unless the config has an
``lm_head``; padded logit columns are masked out of the loss. A config with
``input_mode="embeddings"`` takes (B, S, d_model) frame embeddings in
place of tokens. Weights are cast to the compute dtype where they are
used, so gradients reach the float32 masters.

Decode (`init_decode_caches`, `decode_step`) is one token a step against
per-layer caches that the step updates in place (KV rows, a sliding
window's ring, MLA's latent rows, an SSM's conv window and state), with
the reference's per-slot ``start`` masking for continuous batching.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import (ModelConfig, hybrid_structure, padded_vocab,
                                param_shapes)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, apply_norm, fanin_init,
                                       normal_init)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs (the reference's also carries the device mesh and
    its sharding levers)."""

    compute_dtype: torch.dtype = torch.bfloat16
    moe_capacity_factor: float = 1.25


def check_decode_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration without a decode step: an encoder (nor
    has the reference one)."""
    if not cfg.has_decode:
        raise NotImplementedError(f"{cfg.name} is an encoder: it has no "
                                  "decode step (nor has the reference)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                generator_device: DeviceLike = "cpu") -> Params:
    """Random float32 parameters from a generator seeded with ``seed``,
    drawn on ``generator_device`` (the CPU unless asked: the same weights on
    every device; the reference's distributions, but `jax.random` bits
    cannot be reproduced, so parity tests load the reference's weights
    instead)."""
    dev = resolve_device(device)
    gdev = torch.device(generator_device)
    gen = torch.Generator(device=gdev).manual_seed(seed)
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        t = (ssm_mod.init_ssm_leaf(gen, name.split(".mixer.", 1)[1], shape)
             if ".mixer." in name else None)
        if t is None and name.endswith(".scale"):
            t = torch.ones(shape, device=gdev)
        elif t is None and name.endswith(".bias"):
            t = torch.zeros(shape, device=gdev)
        elif t is None:
            t = (normal_init if name == "embed.table" else fanin_init)(
                gen, shape)
        params[name] = t.to(dev).requires_grad_()
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _tf_block(params: Params, prefix: str, cfg: ModelConfig, rt: Runtime,
              x: torch.Tensor, is_moe: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    x = x + attn.attention_forward(params, f"{prefix}.attn", cfg, h)
    h = apply_norm(params, f"{prefix}.norm2", cfg, x)
    if not is_moe:
        return x + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h), None
    y, aux = moe_mod.moe_forward(params, f"{prefix}.moe", cfg, rt, h)
    if cfg.dense_residual:
        y = y + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)
    return x + y, aux


def _mamba_block(params: Params, prefix: str, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    return x + ssm_mod.ssd_forward(params, f"{prefix}.mixer", cfg, h)


def _shared_attn_block(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """Zamba2's shared attention + MLP block (weight-tied across
    invocations)."""
    h = apply_norm(params, "shared.norm1", cfg, x)
    x = x + attn.attention_forward(params, "shared.attn", cfg, h)
    h = apply_norm(params, "shared.norm2", cfg, x)
    return x + ffn_mod.ffn_forward(params, "shared.ffn", cfg, h)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(params: Params, cfg: ModelConfig, rt: Runtime,
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.input_mode != "tokens":
        return batch["embeddings"].to(rt.compute_dtype)
    # F.embedding, not indexing: at up to 3072 tokens its CUDA backward is a
    # single kernel with no host sync, so the step can be captured in a graph
    return F.embedding(batch["tokens"].long(),
                       params["embed.table"].to(rt.compute_dtype))


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params, "final_norm", cfg, x)
    if cfg.tie_embeddings:
        return x @ params["embed.table"].to(x.dtype).T
    return x @ params["lm_head.kernel"].to(x.dtype)


def forward(params: Params, cfg: ModelConfig, rt: Runtime,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V_padded), aux_loss): the
    MoE layers' summed load-balance loss (zero without experts)."""
    x = _embed(params, cfg, rt, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        if cfg.attn_every:
            n_groups, g, n_tail = hybrid_structure(cfg)
            for gi in range(n_groups):
                for j in range(g):
                    x = _mamba_block(params, f"layers.{gi * g + j}", cfg, x)
                x = _shared_attn_block(params, cfg, x)
            for t in range(n_tail):
                x = _mamba_block(params, f"layers.{n_groups * g + t}", cfg,
                                 x)
        else:
            for i in range(cfg.n_layers):
                x = _mamba_block(params, f"layers.{i}", cfg, x)
    else:
        fd = cfg.first_dense_layers if cfg.n_experts else 0
        for i in range(cfg.n_layers):
            x, a = _tf_block(params, f"layers.{i}", cfg, rt, x,
                             is_moe=bool(cfg.n_experts) and i >= fd)
            if a is not None:
                aux = aux + a
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

# {"layers": [...], ...}: one cache dict per layer in a list per group of
# layers (the reference stacks them on leading axes)
Caches = Dict[str, List[Dict[str, torch.Tensor]]]


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = None) -> Caches:
    """The model's decode caches (`repro/models/model.py:328-357`), KV
    caches in ``dtype``, SSM caches in float32. Dense and MoE: ``layers``
    (the layers after the leading dense ones) and ``head_layers`` (those);
    SSM: ``layers``; hybrid: ``layers`` (every grouped mixer, layer by
    layer), ``tail`` (the mixers after the last group) and ``shared`` (the
    shared attention's KV cache, one per group)."""
    check_decode_supported(cfg)
    dev = resolve_device(device)

    def kv(n):
        return [attn.init_kv_cache(cfg, batch, max_len, dtype, dev)
                for _ in range(n)]

    def ssm(n):
        return [ssm_mod.init_ssm_cache(cfg, batch, device=dev)
                for _ in range(n)]

    if cfg.family in ("ssm", "hybrid"):
        if not cfg.attn_every:
            return {"layers": ssm(cfg.n_layers)}
        n_groups, g, n_tail = hybrid_structure(cfg)
        caches = {"layers": ssm(n_groups * g), "shared": kv(n_groups)}
        if n_tail:
            caches["tail"] = ssm(n_tail)
        return caches
    fd = cfg.first_dense_layers if cfg.n_experts else 0
    caches = {"layers": kv(cfg.n_layers - fd)}
    if fd:
        caches["head_layers"] = kv(fd)
    return caches


def _tf_block_decode(params: Params, prefix: str, cfg: ModelConfig,
                     rt: Runtime, x: torch.Tensor, cache: attn.Cache,
                     index: Union[int, torch.Tensor],
                     start: Optional[torch.Tensor] = None,
                     is_moe: bool = False) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    x = x + attn.attention_decode(params, f"{prefix}.attn", cfg, h, cache,
                                  index, start=start)
    h = apply_norm(params, f"{prefix}.norm2", cfg, x)
    if not is_moe:
        return x + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)
    y, _ = moe_mod.moe_forward(params, f"{prefix}.moe", cfg, rt, h)
    if cfg.dense_residual:
        y = y + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)
    return x + y


def _mamba_block_decode(params: Params, prefix: str, cfg: ModelConfig,
                        x: torch.Tensor, cache: ssm_mod.SSMCache
                        ) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    return x + ssm_mod.ssd_decode(params, f"{prefix}.mixer", cfg, h, cache)


def decode_step(params: Params, cfg: ModelConfig, rt: Runtime,
                batch: Dict[str, torch.Tensor], caches: Caches,
                index: Union[int, torch.Tensor],
                start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One token step (`repro/models/model.py:383-459`). batch:
    {"tokens": (B, 1)} or {"embeddings": (B, 1, d_model)}. Returns (logits
    (B, 1, V_padded), caches), the caches updated in place.

    ``start``: optional (B,) — each sequence's first valid absolute
    position. Continuous-batching serving passes it so a request that
    joined the running batch mid-flight never attends to cache rows written
    by the slot's previous occupant (see `attention.gqa_decode`)."""
    x = _embed(params, cfg, rt, batch)
    if cfg.family in ("ssm", "hybrid"):
        layers = caches["layers"]
        if cfg.attn_every:
            n_groups, g, n_tail = hybrid_structure(cfg)
            for gi in range(n_groups):
                for j in range(g):
                    i = gi * g + j
                    x = _mamba_block_decode(params, f"layers.{i}", cfg, x,
                                            layers[i])
                h = apply_norm(params, "shared.norm1", cfg, x)
                x = x + attn.attention_decode(
                    params, "shared.attn", cfg, h, caches["shared"][gi],
                    index, start=start)
                h = apply_norm(params, "shared.norm2", cfg, x)
                x = x + ffn_mod.ffn_forward(params, "shared.ffn", cfg, h)
            for t in range(n_tail):
                x = _mamba_block_decode(params, f"layers.{n_groups * g + t}",
                                        cfg, x, caches["tail"][t])
        else:
            for i in range(cfg.n_layers):
                x = _mamba_block_decode(params, f"layers.{i}", cfg, x,
                                        layers[i])
    else:
        fd = cfg.first_dense_layers if cfg.n_experts else 0
        for i in range(cfg.n_layers):
            cache = (caches["head_layers"][i] if i < fd
                     else caches["layers"][i - fd])
            x = _tf_block_decode(params, f"layers.{i}", cfg, rt, x, cache,
                                 index, start=start,
                                 is_moe=bool(cfg.n_experts) and i >= fd)
    return _head(params, cfg, x), caches


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
    """Host numpy batch -> tensors on ``device``: token ids and labels as
    int64, frame embeddings as float32."""
    return {k: (torch.as_tensor(v, device=device).float()
                if np.issubdtype(np.asarray(v).dtype, np.floating)
                else torch.as_tensor(v, device=device).long())
            for k, v in batch.items()}
