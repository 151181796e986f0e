"""Plain PyTorch versions of the GMM kernels (port of `repro/kernels/ref.py`).

They are the CPU path of `repro_torch.kernels.ops` and the yardstick the CUDA
kernels are held against. Each keeps a count of its calls (``CALLS``), so a
run on the card can show that its main path never took them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

LOG2PI = float(math.log(2.0 * math.pi))

CALLS: Dict[str, int] = {"gmm_score_ref": 0, "gmm_best_ref": 0}


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
