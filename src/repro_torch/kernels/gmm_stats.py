"""Hand-written CUDA GMM E-step kernels (``csrc/gmm_stats.cu``) and their
wrappers: the port of `repro/kernels/gmm_stats.py`.

``gmm_stats_cuda`` replaces ``gmm_stats_pallas`` (one pass over X gives the
E-step sufficient statistics nk, sx, sxx and the summed log-likelihood) and
``gmm_update_cuda`` replaces ``gmm_update_pallas`` (the same pass with the
M-step fused in: nk, the new means and covariances, the log-likelihood).
Both take ``nvalid``, a row count at run time: rows at index >= nvalid are
padding and are never read, so one kernel serves every window size of a
power-of-two bucket (`repro_torch.detect.cache`).

They take CUDA tensors only and raise on anything else;
`repro_torch.kernels.ops` sends CPU tensors to the plain versions in
`ref.py`. Each wrapper call is two launches (per-block partial sums, then
their reduction in a fixed order), allocates its outputs and workspace
with torch, and adds one to ``LAUNCHES`` where it launches, and nowhere
else. The source says what bounds the kernels on the card and how their
design answers it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gmm_score import (_X_DTYPES, _check, _prepare,
                                           _stream)

SOURCE = "gmm_stats.cu"
THREADS = 256  # rows of a tile: kThreads in the source
MAX_BLOCKS = 1024
WORK_FLOATS = 1 << 22  # the workspace stays under 16 MB at any shape

LAUNCHES: Dict[str, int] = {"gmm_stats": 0, "gmm_update": 0}

_P = ctypes.c_void_p
# X, x_dtype, log_w, U, mu_u, logdet, out0..out3, work, N, nvalid, D, K, nb,
# stream
_ARGS = [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P]

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _fn(name: str):
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    return fn


def n_entries(D: int, K: int) -> int:
    """Length of one block's partial vector: nk, sx, sxx and ll."""
    return K + K * D + K * D * D + 1


def grid_blocks(N: int, D: int, K: int) -> int:
    """Blocks of the first pass: one per tile of THREADS rows, at most
    MAX_BLOCKS, and few enough that the partials fit in WORK_FLOATS. A
    function of the shape alone, never of the device or of nvalid, so the
    order of every sum, and with it the result, is fixed by the input."""
    cap = max(1, min(MAX_BLOCKS, WORK_FLOATS // n_entries(D, K)))
    return max(1, min(-(-N // THREADS), cap))


def _launch(name: str, X: torch.Tensor, log_weights: torch.Tensor,
            means: torch.Tensor, prec_chol: torch.Tensor,
            nvalid: Optional[int]) -> Outputs:
    U, mu_u, logdet, N, D, K = _prepare(X, means, prec_chol)
    if tuple(log_weights.shape) != (K,):
        raise ValueError(f"log_weights {tuple(log_weights.shape)} does not "
                         f"match K={K}")
    if log_weights.device != X.device:
        raise ValueError(f"log_weights is on {log_weights.device}, X on "
                         f"{X.device}")
    nvalid = N if nvalid is None else int(nvalid)
    if nvalid < 0:
        raise ValueError(f"nvalid must be >= 0, got {nvalid}")
    log_w = log_weights.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=X.device)
    outs = (torch.empty((K,), **f32), torch.empty((K, D), **f32),
            torch.empty((K, D, D), **f32), torch.empty((), **f32))
    nb = grid_blocks(N, D, K)
    work = torch.empty((nb, n_entries(D, K)), **f32)
    # N = 0 or nvalid = 0 still launches one block, which writes zeros
    with torch.cuda.device(X.device):  # the launch goes to the current card
        rc = _fn(f"{name}_launch")(
            X.data_ptr(), _X_DTYPES[X.dtype], log_w.data_ptr(), U.data_ptr(),
            mu_u.data_ptr(), logdet.data_ptr(),
            *(o.data_ptr() for o in outs), work.data_ptr(), N, nvalid, D, K,
            nb, _stream(X.device))
    _check(rc, name)
    LAUNCHES[name] += 1
    return outs


def gmm_stats_cuda(X: torch.Tensor, log_weights: torch.Tensor,
                   means: torch.Tensor, prec_chol: torch.Tensor, *,
                   nvalid: Optional[int] = None) -> Outputs:
    """One-pass E-step stats: (nk (K,), sx (K, D), sxx (K, D, D), ll ())
    float32 over the first ``nvalid`` rows of X (all rows if None)."""
    return _launch("gmm_stats", X, log_weights, means, prec_chol, nvalid)


def gmm_update_cuda(X: torch.Tensor, log_weights: torch.Tensor,
                    means: torch.Tensor, prec_chol: torch.Tensor, *,
                    nvalid: Optional[int] = None) -> Outputs:
    """Fused EM iteration: (nk (K,), means (K, D), cov (K, D, D), ll ())
    float32; nk comes without the M-step's 1e-10."""
    return _launch("gmm_update", X, log_weights, means, prec_chol, nvalid)
