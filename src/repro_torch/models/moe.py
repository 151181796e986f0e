"""Mixture-of-Experts FFN with capacity-based dispatch — port of
`repro/models/moe.py` (``_expert_ffn``, ``_dispatch``, ``_combine``,
``_capacity``, ``moe_forward``, and the sharded paths of `:117-191`).

Tokens are sorted by expert (a stable sort, so the tokens an expert keeps
at capacity are the reference's), scattered into (E, C, d) capacity slots,
run through every expert as one batched product, and combined back with
their routing weights; a token past its expert's capacity is dropped from
that expert. Every shape is static and nothing reads a value back to the
host, so the step stays capturable in a CUDA graph; no two rows are added
by atomics, forward or backward, so a step gives the same numbers on every
run (and eager and graphed runs of it the same routing).

On a mesh (`dispatch_plan`, line by line the reference's
``moe_dispatch_compute``) the experts split over the model axis, each rank
holding E / M of them, and the reference's ``shard_map`` bodies run on
each rank's tokens: ``_moe_sharded_a2a`` when the tokens split over the
batch and model axes (an all-to-all over the model group sends each
expert's slots to the rank holding it, and the outputs back),
``_moe_sharded_replicated`` when they cannot split over the model axis
(each rank runs its experts on every token; the ranks' outputs are
summed). Experts that do not divide the model axis, and the ``dp``
strategy, run the local path on the global token stream.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.layers import Params, activation
from repro_torch.models.sharding import (P, all_reduce_, all_to_all,
                                         entry_axes, sum_fwd)


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


def _split_axes(rt) -> List:
    """The mesh axes (of size > 1) that this rank's tokens are a piece
    of."""
    if rt is None or rt.mesh is None:
        return []
    return [rt.axes[a] for a in entry_axes(rt.batch_spec(rt.global_batch))
            if rt.axes[a].size > 1]


def route(params: Params, prefix: str, cfg: ModelConfig, xf: torch.Tensor,
          rt=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router on (T, d) tokens: (gates (T, E), top_w (T, k) renormalised,
    top_idx (T, k), the Switch load-balance aux loss), in float32. On a
    mesh the aux loss is the global token stream's: the expert densities
    and mean gates are summed over the batch's pieces."""
    logits = xf.to(torch.float32) @ params[f"{prefix}.router.kernel"]
    gates = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(gates, cfg.moe_top_k, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # Switch/GShard load-balance aux loss: E * sum_e f_e * P_e
    E = cfg.n_experts
    counts = torch.zeros(E, dtype=torch.float32, device=xf.device) \
        .index_add_(0, top_idx.reshape(-1),
                    torch.ones(top_idx.numel(), device=xf.device))
    axes = _split_axes(rt)
    if not axes:
        density, p_mean = counts / top_idx.numel(), torch.mean(gates, dim=0)
    else:
        g_sum = torch.sum(gates, dim=0)
        for ax in axes:
            counts, g_sum = all_reduce_(counts, ax), sum_fwd(g_sum, ax)
        n = math.prod(ax.size for ax in axes)
        density = counts / (top_idx.numel() * n)
        p_mean = g_sum / (gates.shape[0] * n)
    aux = E * torch.sum(density * p_mean)
    return gates, top_w, top_idx, aux


def _moe_local(x, top_idx, top_w, params: Params, prefix: str,
               cfg: ModelConfig, C: int) -> torch.Tensor:
    """Fully local MoE on (T, d) tokens."""
    buf, slot, keep, _, order = _dispatch(x, top_idx, cfg.n_experts, C)
    ys = _expert_ffn(params, f"{prefix}.experts", cfg, buf)
    return _combine(ys, slot, keep, top_w, order, x.shape[0])


def _moe_sharded_a2a(x, top_idx, top_w, params: Params, prefix: str,
                     cfg: ModelConfig, C: int, rt) -> torch.Tensor:
    """This rank's tokens, split over every axis incl. model; an
    all_to_all over the model group moves each expert's slots to the rank
    holding it and the outputs back (`repro/models/moe.py:117-127`)."""
    ax = rt.axes[rt.model_axis]
    E, M = cfg.n_experts, ax.size
    buf, slot, keep, _, order = _dispatch(x, top_idx, E, C)
    d = buf.shape[-1]
    # (E, C, d) -> (E_loc, M*C, d): expert shards move to their owners,
    # the slots concatenated in the sending ranks' order
    buf = all_to_all(buf, ax).view(M, E // M, C, d).transpose(0, 1) \
        .reshape(E // M, M * C, d)
    ys = _expert_ffn(params, f"{prefix}.experts", cfg, buf)
    ys = ys.view(E // M, M, C, d).transpose(0, 1).reshape(E, C, d)
    ys = all_to_all(ys, ax)
    return _combine(ys, slot, keep, top_w, order, x.shape[0])


def _moe_sharded_replicated(x, top_idx, top_w, params: Params, prefix: str,
                            cfg: ModelConfig, C: int, rt) -> torch.Tensor:
    """Tokens whole over the model axis (decode-sized streams); each rank
    runs its E / M experts and the ranks' outputs are summed — the
    all-reduce variant of expert parallelism
    (`repro/models/moe.py:130-145`)."""
    ax = rt.axes[rt.model_axis]
    E = cfg.n_experts
    e_loc = params[f"{prefix}.experts.up"].shape[0]
    x, top_w = rt.tp_enter(x), rt.tp_enter(top_w)
    buf, slot, keep, _, order = _dispatch(x, top_idx, E, C)
    lo = ax.rank * e_loc
    ys_loc = _expert_ffn(params, f"{prefix}.experts", cfg,
                         buf[lo:lo + e_loc])
    # the local experts' outputs in the full (E, C, d) layout
    ys = torch.cat([ys_loc.new_zeros(lo, *ys_loc.shape[1:]), ys_loc,
                    ys_loc.new_zeros(E - lo - e_loc, *ys_loc.shape[1:])])
    y = _combine(ys, slot, keep, top_w, order, x.shape[0])
    return rt.tp_exit(y)


def dispatch_plan(cfg: ModelConfig, rt, T: int):
    """(how the MoE of T global tokens runs, the spec entry of each rank's
    tokens): ``"local"`` without a mesh; ``"global"`` (the local path on
    every token) under ``dp`` or when the experts do not divide the model
    axis; ``"a2a"`` when the tokens split over the batch and model axes;
    ``"replicated"`` otherwise (`repro/models/moe.py:148-191`)."""
    if rt is None or rt.mesh is None:
        return "local", None
    sizes = rt.mesh_shape
    n_model = sizes[rt.model_axis]
    if rt.strategy == "dp" or cfg.n_experts % n_model != 0:
        return "global", None
    batch_axes = rt.batch_axes
    n_batch = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    token_axes = batch_axes if (batch_axes and T % n_batch == 0) else ()
    if token_axes and T % (n_batch * n_model) == 0:
        return "a2a", token_axes + (rt.model_axis,)
    return "replicated", token_axes or None


def moe_dispatch_compute(xf: torch.Tensor, top_idx: torch.Tensor,
                         top_w: torch.Tensor, params: Params, prefix: str,
                         cfg: ModelConfig, rt, T: int) -> torch.Tensor:
    """xf: this rank's (T_loc, d) tokens of a global stream of T."""
    kind, tok = dispatch_plan(cfg, rt, T)
    cf, k, E = rt.moe_capacity_factor, cfg.moe_top_k, cfg.n_experts
    if kind == "local":
        return _moe_local(xf, top_idx, top_w, params, prefix, cfg,
                          _capacity(T, k, E, cf))
    # the tokens as they lie: the batch's pieces, flattened
    src = P(rt.batch_spec(rt.global_batch), None)
    dst = P(tok, None)
    xs, idx, ws = (rt.shard(t, dst, src) for t in (xf, top_idx, top_w))
    n_tok = math.prod(rt.mesh_shape[a] for a in entry_axes(tok))
    C = _capacity(T // n_tok, k, E, cf)
    if kind == "global":
        y = _moe_local(xs, idx, ws, params, prefix, cfg, C)
    else:
        body = _moe_sharded_a2a if kind == "a2a" else _moe_sharded_replicated
        y = body(xs, idx, ws, params, prefix, cfg, C, rt)
    # back to the activation layout (the reference's output pin,
    # `repro/models/moe.py:221-234`)
    return rt.shard(y, src, dst)


def moe_forward(params: Params, prefix: str, cfg: ModelConfig, rt,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y, aux_loss). ``rt``: `model.Runtime` (its
    ``moe_capacity_factor`` and mesh)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    _, top_w, top_idx, aux = route(params, prefix, cfg, xf, rt)
    T = (rt.global_batch or B) * S if rt.mesh is not None else B * S
    y = moe_dispatch_compute(xf, top_idx, top_w.to(x.dtype), params, prefix,
                             cfg, rt, T).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + ffn_forward(params, f"{prefix}.shared", cfg, x, rt=rt)
    return y, aux


def dropped(top_idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """How many (token, choice) pairs `_dispatch` drops at capacity ``C``
    (a device scalar)."""
    counts = torch.zeros(E, dtype=torch.long, device=top_idx.device) \
        .scatter_add_(0, top_idx.reshape(-1).long(),
                      torch.ones(top_idx.numel(), dtype=torch.long,
                                 device=top_idx.device))
    return torch.clamp(counts - C, min=0).sum()

