"""Hand-written CUDA GMM scoring kernels (``csrc/gmm_score.cu``) and their
wrappers: the port of `repro/kernels/gmm_score.py`.

``gmm_score_cuda`` replaces ``gmm_score_pallas`` (log densities, (N, K)) and
``gmm_best_cuda`` replaces ``gmm_best_pallas`` (fused Definition-1 scoring:
best density and first-index argmax, (N,) each). They take CUDA tensors only
and raise on anything else; `repro_torch.kernels.ops` sends CPU tensors to
the plain versions in `ref.py`. The source says what bounds the kernels on
the card and how their design answers it.

A wrapper call is one kernel launch and no other device work: the kernel
forms mu_k U_k and log|det U_k| itself and reads means and U through their
strides, so the transposed U that the EM loop hands over is not copied.
Shapes in ``SPECIALISED`` launch the kernel specialised on (D, K), any other
shape the general one.

Each wrapper adds one to ``LAUNCHES`` where it launches its kernel, and
nowhere else, and one to the variant it launched in ``VARIANTS``, so a run
can show which kernels its main path went through, and which variants.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "gmm_score.cu"
MAX_D = 32
MAX_K = 16
# (D, K) with a specialised kernel: GMM_FIXED_SHAPES in csrc/gmm_common.cuh.
# D = 3 (latency features), D = 4 (device, collective), K <= 4 components.
SPECIALISED = frozenset((D, K) for D in (2, 3, 4) for K in (1, 2, 3, 4))
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"gmm_score": 0, "gmm_best": 0}
VARIANTS: Dict[str, Dict[str, int]] = {
    name: {"specialised": 0, "general": 0} for name in LAUNCHES}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# means, its 2 strides, U, its 3 strides
_PARAMS = [_P, _I64, _I64, _P, _I64, _I64, _I64]
_ARGTYPES = {
    # X, x_dtype, params, out, N, D, K, specialised, stream
    "gmm_score_launch": [_P, _I, *_PARAMS, _P, _I64, _I, _I, _I, _P],
    # X, x_dtype, params, best, arg, N, D, K, specialised, stream
    "gmm_best_launch": [_P, _I, *_PARAMS, _P, _P, _I64, _I, _I, _I, _P],
}


def _fn(name: str):
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def variant(D: int, K: int) -> str:
    """The kernel a (D, K) launches: "specialised" or "general"."""
    return "specialised" if (D, K) in SPECIALISED else "general"


def param_views(means: torch.Tensor, prec_chol: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """means and U as float32 in the caller's layout: a float32 tensor is
    returned as it is (strides and all), so nothing runs on the device."""
    return means.to(torch.float32), prec_chol.to(torch.float32)


def param_args(means: torch.Tensor, U: torch.Tensor) -> List[int]:
    """The launchers' parameter arguments: pointer and strides (elements)."""
    return [means.data_ptr(), *means.stride(), U.data_ptr(), *U.stride()]


def _prepare(X: torch.Tensor, means: torch.Tensor, prec_chol: torch.Tensor):
    """Check the inputs; returns (means, U, N, D, K) with means and U as
    `param_views` gives them. Launches nothing."""
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
    means, U = param_views(means, prec_chol)
    return means, U, N, D, K


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, X: torch.Tensor, means: torch.Tensor,
            U: torch.Tensor, outs: List[torch.Tensor]) -> None:
    N, D = X.shape
    K = means.shape[0]
    with torch.cuda.device(X.device):  # the launch goes to the current card
        rc = _fn(f"{name}_launch")(
            X.data_ptr(), _X_DTYPES[X.dtype], *param_args(means, U),
            *(o.data_ptr() for o in outs), N, D, K,
            int((D, K) in SPECIALISED), _stream(X.device))
    _check(rc, name)
    LAUNCHES[name] += 1
    VARIANTS[name][variant(D, K)] += 1


def gmm_score_cuda(X: torch.Tensor, means: torch.Tensor,
                   prec_chol: torch.Tensor) -> torch.Tensor:
    """(N, D) x (K, D) x (K, D, D) -> (N, K) float32 log densities."""
    means, U, N, D, K = _prepare(X, means, prec_chol)
    out = torch.empty((N, K), dtype=torch.float32, device=X.device)
    if N == 0:  # an empty window: a 0-block grid is a launch error
        return out
    _launch("gmm_score", X, means, U, [out])
    return out


def gmm_best_cuda(X: torch.Tensor, means: torch.Tensor,
                  prec_chol: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Definition-1 scoring: (best log density (N,) float32, first-index
    argmax (N,) int32)."""
    means, U, N, D, K = _prepare(X, means, prec_chol)
    best = torch.empty((N,), dtype=torch.float32, device=X.device)
    arg = torch.empty((N,), dtype=torch.int32, device=X.device)
    if N == 0:
        return best, arg
    _launch("gmm_best", X, means, U, [best, arg])
    return best, arg
