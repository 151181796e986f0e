"""Attention — GQA (with RoPE, sliding windows and bidirectional masks) and
MLA full-sequence forwards, and the decode of both against their caches
(``init_kv_cache``, ``gqa_decode`` with RoPE and the sliding window's
rolling cache, MLA's weight-absorbed ``mla_decode``, ``attention_decode``)
of `repro/models/attention.py`.

The reference computes the full-sequence forward blockwise with an online
softmax and a custom VJP in plain jnp, and its decode step in plain jnp too;
no Pallas kernel stands behind either, so the port uses plain PyTorch math
and autograd. At the sequence lengths of the monitored workload (hundreds of
tokens) the (S, S) score matrix is small. Scores, softmax and the value
product accumulate in float32 in both, as the reference's do.

Decode writes the step's cache rows in place (``index_copy_`` at a
device-side ``index``, or its ring slot), and computes RoPE's angles and
the masks from that device ``index`` too, so one decode step can be
captured in a CUDA graph over static cache buffers and replayed at every
position.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, apply_rope
from repro_torch.models.sharding import P

NEG_INF = -1e30


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over (n, m, k) x (n, k, p) bf16 (or fp16) operands, summed
    and returned in float32: on a CUDA device with the operands as they are
    (`aten::bmm.dtype`, on the tensor cores), elsewhere upcast."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """``a.to(dtype) @ b.to(dtype)`` with a float32 result, differentiable:
    autograd has no formula for `aten::bmm.dtype`, so the backward runs the
    same product, the incoming gradient cast to ``dtype`` as the reference's
    VJP casts ``ds`` to the operands' dtype (`repro/models/attention.py`
    ``_flash_vjp_bwd``), and each gradient returned in its input's dtype."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        a16, b16 = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(a16, b16)
        ctx.dtypes = (a.dtype, b.dtype)
        return _mm_f32(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(a16.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g16, b16.transpose(1, 2)).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            gb = _mm_f32(a16.transpose(1, 2), g16).to(ctx.dtypes[1])
        return ga, gb, None


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Batched ``a @ b`` (n, m, k) x (n, k, p) -> (n, m, p) float32, with
    both operands in ``dtype``: the reference's ``einsum(...,
    preferred_element_type=float32)`` on ``dtype`` inputs."""
    if dtype == torch.float32:
        return torch.bmm(a.float(), b.float())
    return _MatmulF32.apply(a, b, dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention, the reference's ``blocked_attention``
    (`repro/models/attention.py:68-193`) without its blocking: q (B, Sq, H,
    Dk), k (B, Sk, KV, Dk), v (B, Sk, KV, Dv) -> (B, Sq, H, Dv) in q's
    dtype, query i at position ``q_offset + i``. Scores are scaled by
    1/sqrt(Dk); ``causal`` keeps keys at or before the query, ``window`` >
    0 only the ``window`` latest of those (Mistral's sliding window), and
    neither keeps every key (an encoder)."""
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    # (B*KV, G*Sq, Dk) queries against (B*KV, Sk, Dk) keys and (.., Dv)
    q = q.reshape(B, Sq, KV, G, Dk).permute(0, 2, 3, 1, 4).reshape(
        B * KV, G * Sq, Dk)
    k = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, Dk)
    v = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, Dv)
    s = matmul_f32(q, k.transpose(1, 2), q.dtype) / math.sqrt(Dk)
    if causal or window:
        pos = torch.arange(Sk, device=q.device)
        qpos = pos[q_offset:q_offset + Sq]
        blocked = (pos[None, :] > qpos[:, None]) if causal else None
        if window:
            far = qpos[:, None] - pos[None, :] >= window
            blocked = far if blocked is None else blocked | far
        s = s.view(B * KV, G, Sq, Sk).masked_fill(blocked, NEG_INF).view(
            B * KV, G * Sq, Sk)
    p = torch.softmax(s, dim=-1)
    o = matmul_f32(p, v, v.dtype)  # (B*KV, G*Sq, Dv)
    return o.view(B, KV, G, Sq, Dv).permute(0, 3, 1, 2, 4).reshape(
        B, Sq, H, Dv).to(q.dtype)


def attention_mode(cfg: ModelConfig, rt, B: int, S: int) -> Optional[str]:
    """How attention splits over the model axis: ``"heads"`` (its heads
    divide it), ``"seq"`` (its query rows do: `_seq_shard_spec`), or None
    (whole on each rank; also without a mesh)."""
    if rt is None or rt.mesh is None:
        return None
    if rt.model_divides(cfg.n_heads):
        return "heads"
    if _seq_shard_spec(rt, cfg, B, S) is not None:
        return "seq"
    return None


def _seq_shard_spec(rt, cfg: ModelConfig, B: int, S: int):
    """The queries' spec when attention splits its rows over the model
    axis (`repro/models/attention.py:232-241`): its heads do not divide
    the axis and its rows do. None otherwise."""
    if (rt is None or rt.mesh is None or not rt.attn_seq_shard
            or rt.strategy != "tp" or S <= 1):
        return None
    msize = rt.mesh_shape.get(rt.model_axis, 1)
    if cfg.n_heads % msize == 0 or S % msize != 0:
        return None
    return P(rt.batch_spec(B), rt.model_axis, None, None)


def _global_batch(rt, B: int) -> int:
    return (rt.global_batch or B) if rt is not None else B


def _local_heads(rt, x: torch.Tensor, H_loc: int, H: int,
                 KV: int) -> torch.Tensor:
    """A whole (B, S, KV, hd) key or value -> the heads this rank's H_loc
    query heads read, one per query head (its kv heads did not split)."""
    rank = rt.axes[rt.model_axis].rank
    idx = (rank * H_loc + torch.arange(H_loc, device=x.device)) // (H // KV)
    return x.index_select(2, idx)


def gqa_forward(params: Params, prefix: str, cfg: ModelConfig,
                x: torch.Tensor, rt=None) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model): GQA with the config's RoPE,
    causality and sliding window (`repro/models/attention.py:197-224`).
    On a mesh each rank computes its heads (the weights are its pieces)
    or, when they do not split, its query rows (`attention_mode`)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Bg = _global_batch(rt, B)
    mode = attention_mode(cfg, rt, Bg, S)
    wq, wk = params[f"{prefix}.q.kernel"], params[f"{prefix}.k.kernel"]
    wv = params[f"{prefix}.v.kernel"]
    H_loc, KV_loc = wq.shape[-1] // hd, wk.shape[-1] // hd
    xq = xkv = x
    if mode == "heads":
        xq = xkv = rt.tp_enter(x)
    elif mode == "seq":
        # keys and values serve every query row: each rank's gradient of
        # them is its rows' part
        xkv = rt.tp_enter(x)
    q = (xq @ wq.to(x.dtype)).view(B, S, H_loc, hd)
    k = (xkv @ wk.to(x.dtype)).view(B, S, KV_loc, hd)
    v = (xkv @ wv.to(x.dtype)).view(B, S, KV_loc, hd)
    if cfg.use_rope:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if mode == "heads" and KV_loc == KV and H_loc != H:
        k, v = (_local_heads(rt, t, H_loc, H, KV) for t in (k, v))
    q_offset = 0
    seq_shard = _seq_shard_spec(rt, cfg, Bg, S) if mode == "seq" else None
    if seq_shard is not None:
        # heads don't divide the model axis: shard attention over the QUERY
        # sequence instead (K/V whole on every model rank)
        whole = rt.activation_spec(Bg, (None, None, None))
        q = rt.shard(q, seq_shard, whole)
        q_offset = rt.axes[rt.model_axis].rank * q.shape[1]
    o = attend(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
               q_offset=q_offset)
    if seq_shard is not None:
        o = rt.shard(o, whole, seq_shard)
    y = o.reshape(B, S, H_loc * hd) @ params[f"{prefix}.out.kernel"].to(
        x.dtype)
    return rt.tp_exit(y) if mode == "heads" else y


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True) + eps)
    return (x * scale).to(dt)


def mla_forward(params: Params, prefix: str, cfg: ModelConfig,
                x: torch.Tensor, rt=None) -> torch.Tensor:
    """DeepSeek-V2's multi-head latent attention, materialised per head as
    the reference's full-sequence path does (`repro/models/attention.py:
    248-280`): queries and keys of nope + rope dims (the rope part of the
    key shared by all heads), values of ``v_head_dim``. On a mesh whose
    model axis the heads divide, each rank computes its heads."""
    B, S, _ = x.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    pos = torch.arange(S, device=x.device)
    heads = attention_mode(cfg, rt, _global_batch(rt, B), S) == "heads"
    if heads:
        x = rt.tp_enter(x)

    def w(name):
        return params[f"{prefix}.{name}"].to(x.dtype)

    cq = _rms(x @ w("q_down.kernel"), params[f"{prefix}.q_norm.scale"])
    q = (cq @ w("q_up.kernel")).view(B, S, -1, dn + dr)
    H = q.shape[2]
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], pos,
                                            cfg.rope_theta)
    ckv = x @ w("kv_down.kernel")
    c_kv = _rms(ckv[..., :r], params[f"{prefix}.kv_norm.scale"])
    k_rope = apply_rope(ckv[..., None, r:], pos, cfg.rope_theta)  # (B,S,1,dr)
    kv = (c_kv @ w("kv_up.kernel")).view(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attend(q, k, v, causal=cfg.causal)
    y = o.reshape(B, S, H * dv) @ w("out.kernel")
    return rt.tp_exit(y) if heads else y


def attention_forward(params: Params, prefix: str, cfg: ModelConfig,
                      x: torch.Tensor, rt=None) -> torch.Tensor:
    if cfg.attn_kind == "mla":
        return mla_forward(params, prefix, cfg, x, rt=rt)
    return gqa_forward(params, prefix, cfg, x, rt=rt)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

Cache = Dict[str, torch.Tensor]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> Cache:
    """One attention layer's cache (`repro/models/attention.py:294-307`).
    GQA: K and V rows (B, slots, KV, hd) and the absolute position each
    slot holds (-1 = never written); under a sliding window of W the
    cache is a ring of ``slots = min(W, max_len)``, else ``max_len``
    rows. MLA: the latent ``c_kv`` (B, max_len, kv_lora_rank) and the
    shared rope key ``k_rope`` (B, max_len, qk_rope_dim)."""
    if cfg.attn_kind == "mla":
        return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                      dtype=dtype, device=device)}
    W = cfg.sliding_window or 0
    slots = min(W, max_len) if W else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device)}


def _index_tensor(index: Union[int, torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """The decode position as a (1,) int64 device tensor (a graphed step
    passes its static index buffer; eager callers may pass an int). Every
    position-dependent quantity of a decode step (RoPE's angles, the ring
    slot, the masks) is computed from it on the device, so a captured
    step replays at any position."""
    if isinstance(index, torch.Tensor):
        return index.reshape(1).to(torch.int64)
    return torch.tensor([int(index)], dtype=torch.int64, device=device)


def ring_slot(cfg: ModelConfig, idx: torch.Tensor, slots: int
              ) -> torch.Tensor:
    """The cache row position ``idx`` is written to: ``idx % slots`` in a
    sliding window's ring, ``idx`` itself otherwise."""
    return torch.remainder(idx, slots) if cfg.sliding_window else idx


def gqa_decode(params: Params, prefix: str, cfg: ModelConfig,
               x: torch.Tensor, cache: Cache,
               index: Union[int, torch.Tensor],
               start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, 1, d_model); ``index``: the absolute position. Writes the
    step's K/V into ``cache`` in place and returns (B, 1, d_model)
    (`repro/models/attention.py:310-351`).

    With RoPE, q and k are rotated at ``index`` before k is written (keys
    are cached rotated). Under a sliding window the row goes to ring slot
    ``index % slots`` and a slot is attended to while ``index - pos < W``.
    ``start``: optional (B,) per-sequence first valid absolute position.
    Continuous-batching serving reuses cache rows across requests; a
    sequence that joined the batch at position ``start[b]`` must not attend
    to rows written by the slot's previous occupant (positions < start[b]).
    Scores and the value product accumulate in float32 (`matmul_f32`, the
    reference's ``preferred_element_type``)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    idx = _index_tensor(index, x.device)
    q = (x @ params[f"{prefix}.q.kernel"].to(x.dtype)).view(B, 1, H, hd)
    k = (x @ params[f"{prefix}.k.kernel"].to(x.dtype)).view(B, 1, KV, hd)
    v = (x @ params[f"{prefix}.v.kernel"].to(x.dtype)).view(B, 1, KV, hd)
    if cfg.use_rope:  # rotate at write time
        q = apply_rope(q, idx, cfg.rope_theta)
        k = apply_rope(k, idx, cfg.rope_theta)
    k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
    S = k_cache.shape[1]
    slot = ring_slot(cfg, idx, S)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    pos.index_copy_(0, slot, idx.to(pos.dtype))
    kt = k_cache.permute(0, 2, 3, 1).reshape(B * KV, hd, S)
    s = (matmul_f32(q.reshape(B * KV, G, hd), kt,
                    torch.promote_types(q.dtype, k_cache.dtype))
         / math.sqrt(hd)).view(B, KV, G, S)
    at = idx.to(pos.dtype)
    valid = (pos >= 0) & (pos <= at)  # (S,)
    if cfg.sliding_window:
        valid = valid & (at - pos < cfg.sliding_window)
    if start is None:
        s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    else:
        valid = valid[None, :] & (pos[None, :] >= start.to(pos.dtype)[:, None])
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)  # (B, KV, G, S)
    vc = v_cache.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    o = matmul_f32(p.reshape(B * KV, G, S), vc, v_cache.dtype)
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return o @ params[f"{prefix}.out.kernel"].to(x.dtype)


def mla_decode(params: Params, prefix: str, cfg: ModelConfig,
               x: torch.Tensor, cache: Cache,
               index: Union[int, torch.Tensor],
               start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-absorbed MLA decode (DeepSeek-V2's absorption,
    `repro/models/attention.py:354-395`): scores and values against the
    latent cache, no per-head K or V materialised. The query's nope part is
    taken into the latent space through W_uk (``q_lat``, in x's dtype);
    the score is ``q_lat . c_kv + q_rope . k_rope``, two products summed in
    float32; the latent output ``p . c_kv`` (float32) goes back out through
    W_uv in x's dtype. ``start`` as in `gqa_decode`."""
    B = x.shape[0]
    H, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    idx = _index_tensor(index, x.device)

    def w(name):
        return params[f"{prefix}.{name}"].to(x.dtype)

    cq = _rms(x @ w("q_down.kernel"), params[f"{prefix}.q_norm.scale"])
    q = (cq @ w("q_up.kernel")).view(B, 1, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], idx, cfg.rope_theta)
    ckv = x @ w("kv_down.kernel")
    c_kv = _rms(ckv[..., :r], params[f"{prefix}.kv_norm.scale"])  # (B,1,r)
    k_rope = apply_rope(ckv[..., None, r:], idx,
                        cfg.rope_theta)[:, :, 0]  # (B,1,dr)
    ckv_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    ckv_cache.index_copy_(1, idx, c_kv.to(ckv_cache.dtype))
    kr_cache.index_copy_(1, idx, k_rope.to(kr_cache.dtype))

    w_kv = params[f"{prefix}.kv_up.kernel"].view(r, H, dn + dv)
    w_uk = w_kv[..., :dn].permute(1, 2, 0).to(x.dtype)  # (H, dn, r)
    w_uv = w_kv[..., dn:].permute(1, 0, 2).to(x.dtype)  # (H, r, dv)
    # absorb W_uk into the query: q_lat (B, H, r)
    q_lat = torch.bmm(q_nope.reshape(B, H, dn).transpose(0, 1),
                      w_uk).transpose(0, 1)
    S = ckv_cache.shape[1]
    s = (matmul_f32(q_lat, ckv_cache.transpose(1, 2),
                    torch.promote_types(q_lat.dtype, ckv_cache.dtype))
         + matmul_f32(q_rope.reshape(B, H, dr), kr_cache.transpose(1, 2),
                      torch.promote_types(q_rope.dtype, kr_cache.dtype)))
    s = s / math.sqrt(dn + dr)  # (B, H, S)
    rows = torch.arange(S, device=x.device)
    valid = rows <= idx
    if start is None:
        s = s.masked_fill(~valid[None, None, :], NEG_INF)
    else:
        valid = valid[None, :] & (rows[None, :] >= start.to(rows.dtype)[:, None])
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = matmul_f32(p, ckv_cache, ckv_cache.dtype)  # (B, H, r)
    o = torch.bmm(o_lat.to(x.dtype).transpose(0, 1), w_uv)  # (H, B, dv)
    return o.transpose(0, 1).reshape(B, 1, H * dv) @ w("out.kernel")


def attention_decode(params: Params, prefix: str, cfg: ModelConfig,
                     x: torch.Tensor, cache: Cache,
                     index: Union[int, torch.Tensor],
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decode attention of ``cfg.attn_kind``."""
    if cfg.attn_kind == "mla":
        return mla_decode(params, prefix, cfg, x, cache, index, start=start)
    return gqa_decode(params, prefix, cfg, x, cache, index, start=start)
