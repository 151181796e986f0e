"""Gaussian Mixture Model + EM (paper Algorithm 1) and the Definition-1
anomaly criterion (Algorithm 2) on PyTorch (port of `repro/core/gmm.py`).

Full-covariance GMM, log-domain throughout, Cholesky-parameterised. The
per-event densities and the EM passes go through `repro_torch.kernels.ops`:
the CUDA kernels on the card, their plain PyTorch versions for CPU tensors.
The batch half (``fit_gmm``, ``GMM``) runs EM in torch ops around the
``gmm_score`` kernel; the streaming half (``fit_gmm_streaming``,
``SuffStats``, ``stats_from_batch``) is one ``gmm_update`` or ``gmm_stats``
launch per pass over the data.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

LOG2PI = float(math.log(2.0 * math.pi))


class GMMParams(NamedTuple):
    log_weights: torch.Tensor  # (K,)
    means: torch.Tensor  # (K, D)
    prec_chol: torch.Tensor  # (K, D, D): U with Sigma^-1 = U @ U.T (U = inv(L).T)

    @property
    def n_components(self) -> int:
        return self.means.shape[0]


def _prec_chol_from_cov(cov: torch.Tensor, reg: float) -> torch.Tensor:
    """cov: (K, D, D) -> upper-ish factor U st Sigma^-1 = U U^T.

    A covariance that is not positive definite yields an all-NaN factor, as
    `jnp.linalg.cholesky` gives: `GMM.fit`'s reg escalation reads the NaN.
    (`torch.linalg.cholesky` would raise, so the error flag of
    `cholesky_ex` is turned into NaN instead.)"""
    D = cov.shape[-1]
    eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
    L, info = torch.linalg.cholesky_ex(cov + reg * eye)  # (K, D, D) lower
    L = torch.where((info != 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    L_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return L_inv.transpose(-1, -2)  # U = L^-T, Sigma^-1 = U U^T


def _init_params(X: torch.Tensor, seed: int, K: int, reg: float,
                 params0: Optional[GMMParams]) -> GMMParams:
    """Shared EM init: validate + float32-cast a warm start, or draw the
    cold init (random distinct points as means, shared data covariance).

    The cold init draws its rows from a numpy generator seeded with
    ``seed``; it cannot reproduce `jax.random.choice`, so parity with the
    reference goes through ``params0``."""
    if params0 is not None:
        if params0.n_components != K:
            raise ValueError(f"params0 has {params0.n_components} components, "
                             f"expected {K}")
        return GMMParams(*(torch.as_tensor(p, dtype=torch.float32,
                                           device=X.device) for p in params0))
    N, D = X.shape
    idx = np.random.default_rng(seed).choice(N, K, replace=False)
    means = X[torch.as_tensor(idx, device=X.device)]
    eye = torch.eye(D, dtype=X.dtype, device=X.device)
    data_cov = torch.cov(X.T).reshape(D, D) + 1e-3 * eye
    prec = _prec_chol_from_cov(data_cov.expand(K, D, D), reg)
    log_w = torch.full((K,), -math.log(K), dtype=X.dtype, device=X.device)
    return GMMParams(log_w, means, prec)


def component_log_prob(X: torch.Tensor, params: GMMParams) -> torch.Tensor:
    """log N(x | mu_k, Sigma_k) for all k — the Definition-1 density.

    X: (N, D) -> (N, K). The ``gmm_score`` kernel on the card."""
    return ops.gmm_score(X, params.means, params.prec_chol)


def _logsumexp(a: torch.Tensor, dim: int) -> torch.Tensor:
    m = torch.amax(a, dim=dim, keepdim=True)
    return (m + torch.log(torch.sum(torch.exp(a - m), dim=dim, keepdim=True))
            ).squeeze(dim)


def fit_gmm(X: torch.Tensor, seed: int = 0, *, n_components: int,
            n_iters: int = 50, reg: float = 1e-6,
            params0: Optional[GMMParams] = None
            ) -> Tuple[GMMParams, torch.Tensor]:
    """EM fit (Algorithm 1). X: (N, D) on the device that runs the fit.
    Returns (params, ll_trace (n_iters,)).

    ``params0`` warm-starts EM from an earlier fit instead of the random
    init. The loop never reads a value back to the host, so the EM
    iterations queue on the device without a sync."""
    N, D = X.shape
    K = n_components
    X = X.to(torch.float32)
    params = _init_params(X, seed, K, reg, params0)
    lls = []
    for _ in range(n_iters):
        # E-step
        log_p = component_log_prob(X, params)  # (N, K)
        log_r = params.log_weights[None, :] + log_p
        norm = _logsumexp(log_r, dim=1)  # (N,)
        lls.append(torch.mean(norm))
        resp = torch.exp(log_r - norm[:, None])  # (N, K)
        # M-step (sufficient statistics)
        nk = torch.sum(resp, dim=0) + 1e-10  # (K,)
        means = (resp.T @ X) / nk[:, None]  # (K, D)
        diff = X[None, :, :] - means[:, None, :]  # (K, N, D)
        cov = torch.einsum("kn,knd,kne->kde", resp.T, diff, diff) \
            / nk[:, None, None]
        params = GMMParams(torch.log(nk / N), means,
                           _prec_chol_from_cov(cov, reg))
    ll_trace = torch.stack(lls) if lls else X.new_zeros((0,))
    return params, ll_trace


def score_samples(X: torch.Tensor, params: GMMParams
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-component log density + argmax component (Algorithm 2 lines 5-6),
    through the fused ``gmm_best`` kernel on the card."""
    return ops.gmm_best(X.to(torch.float32), params.means, params.prec_chol)


def total_log_likelihood(X: torch.Tensor, params: GMMParams) -> torch.Tensor:
    log_p = component_log_prob(X.to(torch.float32), params)
    return torch.mean(_logsumexp(params.log_weights[None] + log_p, dim=1))


def detect_anomalies(X: torch.Tensor, params: GMMParams,
                     log_delta: float) -> torch.Tensor:
    """Definition 1: flag x_i anomalous iff p(x_i | theta_{k*}) < delta."""
    best, _ = score_samples(X, params)
    return best < log_delta


@dataclasses.dataclass
class GMM:
    """Convenience stateful wrapper used by the detector stack. Takes and
    returns numpy arrays; fits and scores on ``device`` (default ``cuda``)."""

    n_components: int = 4
    n_iters: int = 60
    reg: float = 1e-6
    seed: int = 0
    n_init: int = 2
    params: Optional[GMMParams] = None
    ll: float = float("-inf")
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _tensor(self, X: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X), dtype=torch.float32,
                               device=self.device)

    def fit(self, X: np.ndarray) -> "GMM":
        X = self._tensor(X)
        best_ll, best_params = -np.inf, None
        for i in range(self.n_init):
            for reg in (self.reg, 1e-3, 1e-1):  # escalate on degeneracy
                params, _ = fit_gmm(X, self.seed + i,
                                    n_components=self.n_components,
                                    n_iters=self.n_iters, reg=reg)
                ll = float(total_log_likelihood(X, params))  # one sync a fit
                if np.isfinite(ll):
                    break
            if np.isfinite(ll) and ll > best_ll:
                best_ll, best_params = ll, params
        if best_params is None:  # pathological window: single component
            params, _ = fit_gmm(X, self.seed, n_components=1, n_iters=10,
                                reg=1.0)
            best_params, best_ll = params, float(total_log_likelihood(X,
                                                                      params))
        self.params, self.ll = best_params, float(best_ll)
        return self

    def score(self, X: np.ndarray) -> np.ndarray:
        best, _ = score_samples(self._tensor(X), self.params)
        return best.cpu().numpy()

    def responsibilities(self, X: np.ndarray) -> np.ndarray:
        log_p = component_log_prob(self._tensor(X), self.params)
        log_r = self.params.log_weights[None] + log_p
        return torch.exp(log_r - _logsumexp(log_r, 1)[:, None]).cpu().numpy()


# ---------------------------------------------------------------------------
# Streaming EM: one fused pass over X per iteration (the gmm_update kernel);
# the (N, K) responsibility matrix never exists
# ---------------------------------------------------------------------------


def fit_gmm_streaming(X: torch.Tensor, seed: int = 0, *, n_components: int,
                      n_iters: int = 50, reg: float = 1e-6,
                      params0: Optional[GMMParams] = None
                      ) -> Tuple[GMMParams, torch.Tensor]:
    """EM where each iteration is a single fused pass over X
    (``kernels.ops.gmm_update``: E-step stats + M-step mean/cov in one
    kernel call). X: (N, D) on the device that runs the fit.

    Mathematically identical to fit_gmm (same E/M updates); memory is
    O(K D^2) instead of O(N K). ``params0`` warm-starts EM from a previous
    window's fit. Returns (params, ll_trace (n_iters,)), the trace being the
    mean log-likelihood per row of each iteration. The reference reads every
    iteration's ll back to the host; here the trace stays on the device and
    is stacked after the loop, so the iterations queue without a sync."""
    N, D = X.shape
    K = n_components
    X = X.to(torch.float32)
    log_w, means, prec = _init_params(X, seed, K, reg, params0)
    lls = []
    for _ in range(n_iters):
        nk, means, cov, ll = ops.gmm_update(X, log_w, means, prec)
        prec = _prec_chol_from_cov(cov, reg)
        log_w = torch.log((nk + 1e-10) / N)
        lls.append(ll / N)
    ll_trace = torch.stack(lls) if lls else X.new_zeros((0,))
    return GMMParams(log_w, means, prec), ll_trace


# ---------------------------------------------------------------------------
# Incremental (stepwise) EM: fold fresh rows into persistent per-sample
# sufficient statistics instead of refitting on a bootstrap of the window
# ---------------------------------------------------------------------------


class SuffStats(NamedTuple):
    """Per-sample averaged EM sufficient statistics: ``nk`` sums to 1 over
    components, ``sx``/``sxx`` are responsibility-weighted first/second
    moments divided by the batch size. Averaged (not summed) so batches of
    different sizes fold with a simple convex combination."""

    nk: torch.Tensor  # (K,)
    sx: torch.Tensor  # (K, D)
    sxx: torch.Tensor  # (K, D, D)


def stats_from_batch(X: torch.Tensor, params: GMMParams, *,
                     nvalid: Optional[int] = None
                     ) -> Tuple[SuffStats, float]:
    """One fused E-step pass over a batch -> (per-sample stats, mean ll).

    ``nvalid`` supports bucketed shapes: X may be zero-padded to a fixed
    power-of-two row count, with only the first ``nvalid`` rows real. The
    mean ll is read back to the host (one sync), as the reference does."""
    n = X.shape[0] if nvalid is None else int(nvalid)
    nk, sx, sxx, ll = ops.gmm_stats(X.to(torch.float32), params.log_weights,
                                    params.means, params.prec_chol,
                                    nvalid=nvalid)
    n = max(n, 1)
    return SuffStats(nk / n, sx / n, sxx / n), float(ll) / n


def fold_stats(old: SuffStats, new: SuffStats, rho: float) -> SuffStats:
    """Stepwise-EM fold (Cappé & Moulines): s <- (1-rho) s + rho s_new."""
    rho = float(rho)
    return SuffStats(*((1.0 - rho) * o + rho * n
                       for o, n in zip(old, new)))


def params_from_stats(stats: SuffStats, reg: float = 1e-6) -> GMMParams:
    """M-step from folded per-sample statistics (tiny: O(K D^2) + a (K,D,D)
    Cholesky — the only non-kernel work of an incremental refit)."""
    nk = stats.nk.to(torch.float32) + 1e-10
    means = stats.sx.to(torch.float32) / nk[:, None]
    cov = (stats.sxx.to(torch.float32) / nk[:, None, None]
           - torch.einsum("kd,ke->kde", means, means))
    log_w = torch.log(nk / torch.sum(nk))
    return GMMParams(log_w, means, _prec_chol_from_cov(cov, reg))
