"""Hand-written CUDA GMM scoring kernels (``csrc/gmm_score.cu``) and their
wrappers: the port of `repro/kernels/gmm_score.py`.

``gmm_score_cuda`` replaces ``gmm_score_pallas`` (log densities, (N, K)) and
``gmm_best_cuda`` replaces ``gmm_best_pallas`` (fused Definition-1 scoring:
best density and first-index argmax, (N,) each). They take CUDA tensors only
and raise on anything else; `repro_torch.kernels.ops` sends CPU tensors to
the plain versions in `ref.py`. The source says what bounds the kernels on
the card and how their design answers it.

Each wrapper adds one to ``LAUNCHES`` where it launches its kernel, and
nowhere else, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "gmm_score.cu"
MAX_D = 32
MAX_K = 16
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"gmm_score": 0, "gmm_best": 0}

_P = ctypes.c_void_p
_ARGTYPES = {
    # X, x_dtype, U, mu_u, logdet, out, N, D, K, stream
    "gmm_score_launch": [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64,
                         ctypes.c_int, ctypes.c_int, _P],
    # X, x_dtype, U, mu_u, logdet, best, arg, N, D, K, stream
    "gmm_best_launch": [_P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_int, _P],
}


def _fn(name: str):
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _prepare(X: torch.Tensor, means: torch.Tensor, prec_chol: torch.Tensor):
    """Check the inputs and compute mu_k U_k and log|det U_k| with torch
    before the launch (the Pallas wrapper's `_common`)."""
    if X.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {X.device}")
    if X.dtype not in _X_DTYPES:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be (N, D), got shape {tuple(X.shape)}")
    N, D = X.shape
    K = means.shape[0]
    if not (1 <= D <= MAX_D and 1 <= K <= MAX_K):
        raise ValueError(f"kernel takes D <= {MAX_D} and K <= {MAX_K}, "
                         f"got D={D}, K={K}")
    if tuple(means.shape) != (K, D) or tuple(prec_chol.shape) != (K, D, D):
        raise ValueError(f"means {tuple(means.shape)} / prec_chol "
                         f"{tuple(prec_chol.shape)} do not match X (N, {D})")
    for name, t in (("means", means), ("prec_chol", prec_chol)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    U = prec_chol.to(torch.float32).contiguous()
    mu_u = torch.einsum("kd,kde->ke", means.to(torch.float32), U).contiguous()
    logdet = torch.sum(torch.log(torch.abs(
        torch.diagonal(U, dim1=-2, dim2=-1))), dim=-1).contiguous()
    return U, mu_u, logdet, N, D, K


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def gmm_score_cuda(X: torch.Tensor, means: torch.Tensor,
                   prec_chol: torch.Tensor) -> torch.Tensor:
    """(N, D) x (K, D) x (K, D, D) -> (N, K) float32 log densities."""
    U, mu_u, logdet, N, D, K = _prepare(X, means, prec_chol)
    out = torch.empty((N, K), dtype=torch.float32, device=X.device)
    if N == 0:  # an empty window: a 0-block grid is a launch error
        return out
    with torch.cuda.device(X.device):  # the launch goes to the current card
        rc = _fn("gmm_score_launch")(
            X.data_ptr(), _X_DTYPES[X.dtype], U.data_ptr(), mu_u.data_ptr(),
            logdet.data_ptr(), out.data_ptr(), N, D, K, _stream(X.device))
    _check(rc, "gmm_score")
    LAUNCHES["gmm_score"] += 1
    return out


def gmm_best_cuda(X: torch.Tensor, means: torch.Tensor,
                  prec_chol: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Definition-1 scoring: (best log density (N,) float32, first-index
    argmax (N,) int32)."""
    U, mu_u, logdet, N, D, K = _prepare(X, means, prec_chol)
    best = torch.empty((N,), dtype=torch.float32, device=X.device)
    arg = torch.empty((N,), dtype=torch.int32, device=X.device)
    if N == 0:
        return best, arg
    with torch.cuda.device(X.device):
        rc = _fn("gmm_best_launch")(
            X.data_ptr(), _X_DTYPES[X.dtype], U.data_ptr(), mu_u.data_ptr(),
            logdet.data_ptr(), best.data_ptr(), arg.data_ptr(), N, D, K,
            _stream(X.device))
    _check(rc, "gmm_best")
    LAUNCHES["gmm_best"] += 1
    return best, arg
