"""Mamba-2 (SSD — state-space duality) mixer, the chunked full-sequence
forward of `repro/models/ssm.py` (``init_ssm``, ``_causal_conv``,
``_split_proj``, ``_segsum``, ``ssd_forward``; `:21-158`).

Per-head scalar A, per-token dt (softplus), B/C shared across the heads of
a group, a depthwise causal conv over (x, B, C), gated RMSNorm and the D
skip. Within a chunk the output is a masked quadratic attention form;
across chunks the state is carried by the reference's combine
``(d1, s1) . (d2, s2) = (d1 d2, s1 d2 + s2)``, here a loop over the chunks
in order where the reference runs ``associative_scan``: the same terms,
summed in another order (float32 agreement to ~1e-6 relative). The
reference's ``preferred_element_type=float32`` products on bf16 operands
are float32 products of the upcast operands here (a bf16 x bf16 product is
exact in float32). Decode (``init_ssm_cache``, ``ssd_decode``, `:161-200`)
is the O(1) per-token recurrence over a per-lane conv window and state,
updated in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, rms_norm_gated


def init_ssm_leaf(gen: torch.Generator, leaf: str,
                  shape: Tuple[int, ...]) -> Optional[torch.Tensor]:
    """A mixer leaf with a distribution of its own (``init_ssm``): ``A_log``,
    ``dt_bias``, ``D``, ``conv.kernel``, drawn from ``gen``; None for the
    projections and the norm scale, which `model.init_params` draws as any
    kernel and scale."""
    def uniform():
        return torch.rand(shape, generator=gen, device=gen.device)

    if leaf == "A_log":  # A in [1, 16) as in the reference implementation
        return torch.log(1.0 + 15.0 * uniform())
    if leaf == "dt_bias":  # inverse softplus of dt ~ U[1e-3, 1e-1] in log
        dt = torch.exp(uniform() * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if leaf == "D":
        return torch.ones(shape, device=gen.device)
    if leaf == "conv.kernel":
        return 0.1 * torch.randn(shape, generator=gen,
                                 device=gen.device)
    return None


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1D conv. x: (B, S, C); kernel: (K, C)."""
    K, S = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):  # sum_k kernel[k] * x[t - K + 1 + k]
        out = out + xp[:, k:k + S, :] * kernel[k].to(x.dtype)
    return out


def _split_proj(cfg: ModelConfig, proj: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    di, ng, st = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * ng * st],
            proj[..., 2 * di + 2 * ng * st:])


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., t, s] = sum_{r=s+1..t} a[..., r] for t >= s, -inf above the
    diagonal. a: (..., L) -> (..., L, L)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_forward(params: Params, prefix: str, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model)."""
    B, S, _ = x.shape
    di, ng, st, nh, hd = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                          cfg.ssm_nheads, cfg.ssm_headdim)
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} must divide into chunks of {L}")
    nc = S // L
    f32 = torch.float32

    def p(name):
        return params[f"{prefix}.{name}"]

    proj = x @ p("in_proj.kernel").to(x.dtype)
    z, xBC, dt = _split_proj(cfg, proj)
    xBC = F.silu(_causal_conv(xBC, p("conv.kernel")))
    xs = xBC[..., :di].reshape(B, nc, L, nh, hd)
    Bm = xBC[..., di:di + ng * st].reshape(B, nc, L, ng, st).to(f32)
    Cm = xBC[..., di + ng * st:].reshape(B, nc, L, ng, st).to(f32)

    A = -torch.exp(p("A_log").to(f32))  # (nh,)
    dt = F.softplus(dt.to(f32) + p("dt_bias")).reshape(B, nc, L, nh)
    a = dt * A  # log-decay per step, <= 0

    # ---- intra-chunk (attention form) ----
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cm, Bm)  # (B,nc,g,L,L)
    Lmat = torch.exp(_segsum(a.permute(0, 1, 3, 2)))  # (B,nc,nh,L,L)
    hpg = nh // ng  # heads per group
    w = cb.repeat_interleave(hpg, dim=2) * Lmat \
        * dt.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchls,bcshp->bclhp", w.to(x.dtype).to(f32),
                     xs.to(f32))

    # ---- chunk states ----
    cums = torch.cumsum(a, dim=2)  # (B,nc,L,nh)
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)
    dtx = (dt * decay_to_end)[..., None] * xs.to(f32)  # (B,nc,L,nh,hd)
    Bh = Bm.repeat_interleave(hpg, dim=3)  # (B,nc,L,nh,st)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh, dtx)

    # ---- inter-chunk recurrence, chunk by chunk ----
    chunk_decay = torch.exp(cums[:, :, -1, :])  # (B,nc,nh)
    state = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(state)  # the state entering chunk c
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,nh,hd,st)

    # ---- inter-chunk contribution ----
    decay_in = torch.exp(cums)  # from the chunk's start to t
    Ch = Cm.repeat_interleave(hpg, dim=3)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states) \
        * decay_in[..., None]

    y = (y + y_inter).to(x.dtype)
    y = y + p("D").to(x.dtype)[:, None] * xs
    y = rms_norm_gated(p("norm.scale"), y.reshape(B, S, di), z)
    return y @ p("out_proj.kernel").to(x.dtype)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

SSMCache = Dict[str, torch.Tensor]


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None) -> SSMCache:
    """One mixer's decode cache: the conv window's last ``ssm_conv - 1``
    inputs (B, K-1, conv_dim) and the state (B, nh, hd, st), both float32
    as the reference's."""
    di, ng, st = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = di + 2 * ng * st
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, st),
                                 dtype=torch.float32, device=device)}


def ssd_decode(params: Params, prefix: str, cfg: ModelConfig,
               x: torch.Tensor, cache: SSMCache) -> torch.Tensor:
    """x: (B, 1, d_model) -> (B, 1, d_model): one token through the mixer,
    ``cache`` updated in place. The conv window is the cached inputs (cast
    to x's dtype) and this token's, contracted with the kernel (exact
    products summed in float32, rounded once to x's dtype, as the
    reference's ``einsum``); the window moves on by one. The state decays
    by ``exp(dt A)`` and takes ``dt x B`` in float32; the output reads it
    through C, adds the D skip, then the gated RMSNorm."""
    B = x.shape[0]
    di, ng, st, nh, hd = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                          cfg.ssm_nheads, cfg.ssm_headdim)
    f32 = torch.float32

    def p(name):
        return params[f"{prefix}.{name}"]

    proj = x @ p("in_proj.kernel").to(x.dtype)
    z, xBC, dt = _split_proj(cfg, proj)  # (B, 1, .)
    conv = cache["conv"]
    conv_in = torch.cat([conv.to(x.dtype), xBC], dim=1)  # (B, K, conv_dim)
    kernel = p("conv.kernel").to(x.dtype)
    xBC_t = (conv_in.to(f32) * kernel.to(f32)).sum(dim=1).to(x.dtype)
    xBC_t = F.silu(xBC_t)  # (B, conv_dim)
    conv.copy_(conv_in[:, 1:])

    xt = xBC_t[:, :di].reshape(B, nh, hd)
    Bt = xBC_t[:, di:di + ng * st].reshape(B, ng, st)
    Ct = xBC_t[:, di + ng * st:].reshape(B, ng, st)
    A = -torch.exp(p("A_log").to(f32))
    dtt = F.softplus(dt[:, 0].to(f32) + p("dt_bias"))  # (B, nh)
    decay = torch.exp(dtt * A)
    hpg = nh // ng
    Bh = Bt.to(f32).repeat_interleave(hpg, dim=1)  # (B, nh, st)
    Ch = Ct.to(f32).repeat_interleave(hpg, dim=1)
    inject = (dtt[..., None] * xt.to(f32))[..., None] * Bh[:, :, None, :]
    state = cache["state"]
    state.mul_(decay[..., None, None]).add_(inject)  # (B, nh, hd, st)
    y = torch.matmul(state, Ch[..., None])[..., 0].to(x.dtype)  # (B,nh,hd)
    y = y + p("D").to(x.dtype)[:, None] * xt
    y = rms_norm_gated(p("norm.scale"), y.reshape(B, 1, di), z)
    return y @ p("out_proj.kernel").to(x.dtype)
