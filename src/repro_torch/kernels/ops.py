"""Dispatch for the GMM kernels: the CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors (port of `repro/kernels/ops.py`).

The choice follows the tensor's device alone. A CUDA tensor launches the
kernel or raises; nothing falls back to the plain version when a build or a
launch fails. ``backend="plain"`` forces the plain version on any device —
only the tests and `chip_smoke.py`'s comparisons use it.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.gmm_score import gmm_best_cuda, gmm_score_cuda

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
