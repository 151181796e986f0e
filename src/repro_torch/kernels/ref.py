"""Plain PyTorch versions of the GMM kernels (port of `repro/kernels/ref.py`).

They are the CPU path of `repro_torch.kernels.ops` and the yardstick the CUDA
kernels are held against. Each keeps a count of its calls (``CALLS``), so a
run on the card can show that its main path never took them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

LOG2PI = float(math.log(2.0 * math.pi))

CALLS: Dict[str, int] = {"gmm_score_ref": 0, "gmm_best_ref": 0,
                         "gmm_stats_ref": 0, "gmm_update_ref": 0}


def gmm_score_ref(X: torch.Tensor, means: torch.Tensor,
                  prec_chol: torch.Tensor) -> torch.Tensor:
    """Per-component Gaussian log densities.

    X: (N, D); means: (K, D); prec_chol: (K, D, D) with Sigma^-1 = U U^T.
    Returns (N, K) float32: log N(x | mu_k, Sigma_k).
    """
    CALLS["gmm_score_ref"] += 1
    return _log_prob(X, means, prec_chol)


def gmm_best_ref(X: torch.Tensor, means: torch.Tensor,
                 prec_chol: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max-component log density, argmax component) — Definition-1 scoring.
    Ties go to the first index and a NaN density wins, as in `jnp.argmax`."""
    CALLS["gmm_best_ref"] += 1
    log_p = _log_prob(X, means, prec_chol)
    return (torch.amax(log_p, dim=1),
            torch.argmax(log_p, dim=1).to(torch.int32))


def _log_prob(X, means, prec_chol):
    X = X.to(torch.float32)
    U = prec_chol.to(torch.float32)
    D = X.shape[-1]
    # z_{nkd} = (x_n - mu_k) @ U_k, formed as x U - mu U like the kernel
    xu = torch.einsum("nd,kde->nke", X, U)
    mu_u = torch.einsum("kd,kde->ke", means.to(torch.float32), U)
    z = xu - mu_u[None]
    quad = torch.sum(z * z, dim=-1)  # (N, K)
    logdet = torch.sum(torch.log(torch.abs(
        torch.diagonal(U, dim1=-2, dim2=-1))), dim=-1)  # (K,)
    return -0.5 * (D * LOG2PI + quad) + logdet[None, :]


def gmm_stats_ref(X: torch.Tensor, log_weights: torch.Tensor,
                  means: torch.Tensor, prec_chol: torch.Tensor,
                  nvalid: Optional[int] = None):
    """Fused E-step sufficient statistics (single pass over X).

    Returns (nk (K,), sx (K, D), sxx (K, D, D), ll_sum ()) where resp is the
    posterior responsibility matrix softmax_k(log_w + log_p). Rows at index
    >= ``nvalid`` are padding and contribute nothing (the kernel's
    bucketed-shape contract).
    """
    CALLS["gmm_stats_ref"] += 1
    return _stats(X, log_weights, means, prec_chol, nvalid)


def gmm_update_ref(X: torch.Tensor, log_weights: torch.Tensor,
                   means: torch.Tensor, prec_chol: torch.Tensor,
                   nvalid: Optional[int] = None):
    """One fused EM iteration: E-step stats + M-step mean/covariance.

    Returns (nk (K,), means_new (K, D), cov_new (K, D, D), ll_sum ()); nk
    is returned without the 1e-10 that regularises the M-step's division.
    The caller re-parameterises cov (Cholesky) and renormalises weights.
    """
    CALLS["gmm_update_ref"] += 1
    nk, sx, sxx, ll = _stats(X, log_weights, means, prec_chol, nvalid)
    denom = nk + 1e-10
    mu = sx / denom[:, None]
    cov = sxx / denom[:, None, None] - torch.einsum("kd,ke->kde", mu, mu)
    return nk, mu, cov, ll


def _stats(X, log_weights, means, prec_chol, nvalid):
    X = X.to(torch.float32)
    log_p = _log_prob(X, means, prec_chol)  # (N, K)
    log_r = log_weights[None, :].to(torch.float32) + log_p
    m = torch.amax(log_r, dim=1, keepdim=True)
    norm = m + torch.log(torch.sum(torch.exp(log_r - m), dim=1, keepdim=True))
    resp = torch.exp(log_r - norm)  # (N, K)
    if nvalid is not None:
        # as the reference kernel masks them: padding responsibilities are
        # multiplied by 0 (a NaN row stays NaN), padding norms are selected
        # away (XLA turns the reference's same-shape multiply by the
        # converted mask into a select), so ll never sees a padding row
        valid = torch.arange(X.shape[0], device=X.device) < nvalid
        resp = resp * valid[:, None].to(torch.float32)
        norm = torch.where(valid[:, None], norm, 0.0)
    nk = torch.sum(resp, dim=0)
    sx = resp.T @ X  # (K, D)
    sxx = torch.einsum("nk,nd,ne->kde", resp, X, X)
    return nk, sx, sxx, torch.sum(norm)
