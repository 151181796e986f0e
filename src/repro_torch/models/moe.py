"""Mixture-of-Experts FFN with capacity-based dispatch — the local path of
`repro/models/moe.py` (``init_moe``, ``_expert_ffn``, ``_dispatch``,
``_combine``, ``_capacity``, ``moe_forward``; `:41-115, 194-235`).

Tokens are sorted by expert (a stable sort, so the tokens an expert keeps
at capacity are the reference's), scattered into (E, C, d) capacity slots,
run through every expert as one batched product, and combined back with
their routing weights; a token past its expert's capacity is dropped from
that expert. Every shape is static and nothing reads a value back to the
host, so the step stays capturable in a CUDA graph; no two rows are added
by atomics, forward or backward, so a step gives the same numbers on every
run (and eager and graphed runs of it the same routing). The reference's
``shard_map`` paths (expert parallelism over a mesh, `:117-191`) wait for
the mesh slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.layers import Params, activation


def _expert_ffn(params: Params, prefix: str, cfg: ModelConfig,
                xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, d) -> (E, C, d), one (batched) product per expert."""
    act = activation(cfg.act)
    up = torch.bmm(xs, params[f"{prefix}.up"].to(xs.dtype))
    if cfg.glu:
        gate = torch.bmm(xs, params[f"{prefix}.gate"].to(xs.dtype))
        h = act(gate) * up
    else:
        h = act(up)
    return torch.bmm(h, params[f"{prefix}.down"].to(xs.dtype))


def _dispatch(x: torch.Tensor, top_idx: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, ...]:
    """Scatter tokens into per-expert capacity slots.

    x: (T, d); top_idx: (T, k). Returns (buf (E, C, d), slot (T*k,), keep
    (T*k,), token_of (T*k,), order (T*k,)) where slot indexes
    buf.reshape(E*C, d) (E*C: dropped) and order is the expert-sorted
    permutation of the flat (token, choice) pairs."""
    T, k = top_idx.shape
    flat = top_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    token_of = order // k
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - offsets[sorted_e]
    keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos,
                       torch.full_like(pos, E * C))  # E*C = drop bucket
    # each (token, choice) pair's row, in sorted order: a gather through the
    # permutation (its backward adds no two rows into one), the k copies of
    # a token summed by the expand's backward
    pairs = x.unsqueeze(1).expand(T, k, x.shape[-1]).reshape(T * k, -1)
    buf = x.new_zeros(E * C + 1, x.shape[-1]).index_copy(0, slot,
                                                          pairs[order])
    return buf[:E * C].reshape(E, C, -1), slot, keep, token_of, order


def _combine(ys: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             top_w: torch.Tensor, order: torch.Tensor, T: int
             ) -> torch.Tensor:
    """Inverse of `_dispatch` with routing weights applied. ys: (E, C, d).
    (The reference's also takes ``token_of``, which the scatter-add needs
    and the permutation here does not.)"""
    d = ys.shape[-1]
    flat_w = top_w.reshape(-1)[order]  # weights in sorted order
    rows = torch.cat([ys.reshape(-1, d), ys.new_zeros(1, d)])[slot]
    rows = rows * torch.where(keep, flat_w, torch.zeros_like(flat_w)).to(
        rows.dtype)[:, None]
    # back to (token, choice) order through the permutation, then each
    # token's k rows summed: no atomic adds, so the sum is the same on
    # every run (the reference's scatter-add sums in sorted order)
    k = slot.shape[0] // T
    pairs = rows.new_zeros(T * k, d).index_copy(0, order, rows)
    return pairs.view(T, k, d).sum(dim=1)


def _capacity(T_loc: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(T_loc * k / E * cf))
    return max(8, (c + 7) // 8 * 8)


def route(params: Params, prefix: str, cfg: ModelConfig, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router on (T, d) tokens: (gates (T, E), top_w (T, k) renormalised,
    top_idx (T, k), the Switch load-balance aux loss), in float32."""
    logits = xf.to(torch.float32) @ params[f"{prefix}.router.kernel"]
    gates = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(gates, cfg.moe_top_k, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # Switch/GShard load-balance aux loss: E * sum_e f_e * P_e
    E = cfg.n_experts
    density = torch.zeros(E, dtype=torch.float32, device=xf.device) \
        .index_add_(0, top_idx.reshape(-1),
                    torch.ones(top_idx.numel(), device=xf.device)) \
        / top_idx.numel()
    aux = E * torch.sum(density * torch.mean(gates, dim=0))
    return gates, top_w, top_idx, aux


def moe_forward(params: Params, prefix: str, cfg: ModelConfig, rt,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y, aux_loss). ``rt``: `model.Runtime` (its
    ``moe_capacity_factor``)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    _, top_w, top_idx, aux = route(params, prefix, cfg, xf)
    C = _capacity(T, cfg.moe_top_k, cfg.n_experts, rt.moe_capacity_factor)
    buf, slot, keep, _, order = _dispatch(xf, top_idx, cfg.n_experts, C)
    ys = _expert_ffn(params, f"{prefix}.experts", cfg, buf)
    y = _combine(ys, slot, keep, top_w.to(x.dtype), order, T)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + ffn_forward(params, f"{prefix}.shared", cfg, x)
    return y, aux


def dropped(top_idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """How many (token, choice) pairs `_dispatch` drops at capacity ``C``
    (a device scalar)."""
    counts = torch.zeros(E, dtype=torch.long, device=top_idx.device) \
        .scatter_add_(0, top_idx.reshape(-1).long(),
                      torch.ones(top_idx.numel(), dtype=torch.long,
                                 device=top_idx.device))
    return torch.clamp(counts - C, min=0).sum()

