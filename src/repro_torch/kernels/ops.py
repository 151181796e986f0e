"""Dispatch for the GMM kernels: the CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors (port of `repro/kernels/ops.py`).

The choice follows the tensor's device alone. A CUDA tensor launches the
kernel or raises; nothing falls back to the plain version when a build or a
launch fails. ``backend="plain"`` forces the plain version on any device —
only the tests and `chip_smoke.py`'s comparisons use it.

``gmm_stats`` and ``gmm_update`` take an optional ``nvalid`` row count:
callers that pad N to a power-of-two bucket (`repro_torch.detect.cache`)
pass the true row count, and both versions mask the padding identically.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.gmm_score import gmm_best_cuda, gmm_score_cuda
from repro_torch.kernels.gmm_stats import gmm_stats_cuda, gmm_update_cuda

BACKENDS = ("auto", "plain")


def _plain(X, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    return backend == "plain" or X.device.type == "cpu"


def gmm_score(X, means, prec_chol, *, backend: str = "auto"):
    """(N, D) -> (N, K) per-component log densities."""
    if _plain(X, backend):
        return ref.gmm_score_ref(X, means, prec_chol)
    return gmm_score_cuda(X, means, prec_chol)


def gmm_best(X, means, prec_chol, *, backend: str = "auto"):
    """(N, D) -> (best log density (N,), first-index argmax (N,) int32)."""
    if _plain(X, backend):
        return ref.gmm_best_ref(X, means, prec_chol)
    return gmm_best_cuda(X, means, prec_chol)


def gmm_stats(X, log_weights, means, prec_chol, *, nvalid=None,
              backend: str = "auto"):
    """E-step sufficient statistics (nk, sx, sxx, ll_sum); rows at index
    >= ``nvalid`` are padding."""
    if _plain(X, backend):
        return ref.gmm_stats_ref(X, log_weights, means, prec_chol, nvalid)
    return gmm_stats_cuda(X, log_weights, means, prec_chol, nvalid=nvalid)


def gmm_update(X, log_weights, means, prec_chol, *, nvalid=None,
               backend: str = "auto"):
    """One fused EM iteration: (nk, means_new, cov_new, ll_sum) in a single
    pass over X; the caller only re-parameterises cov and renormalises the
    weights. Rows at index >= ``nvalid`` are padding."""
    if _plain(X, backend):
        return ref.gmm_update_ref(X, log_weights, means, prec_chol, nvalid)
    return gmm_update_cuda(X, log_weights, means, prec_chol, nvalid=nvalid)
