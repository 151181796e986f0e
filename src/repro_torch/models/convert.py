"""Carry the JAX package's weights, GMM fits and streaming-detector state
into the port.

`params_from_jax` takes the reference's ``init_params`` pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's flat
parameter dict, so both packages compute the same function. The reference
stacks the layers on a leading axis (its ``vmap`` init and ``scan``
forward); here they are unstacked into ``layers.{i}.*``. Both packages keep
kernels as ``(d_in, d_out)`` and apply them as ``x @ W``, so no kernel is
transposed. `layer_state_from_numpy` turns one layer's state of the
reference's ``OnlineGMMDetector`` into the port's, so that both detectors
can go on from the same fitted model. Nothing here imports JAX: the inputs
are plain arrays, or objects whose fields are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig, param_shapes
from repro_torch.core.gmm import GMMParams, SuffStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Params
from repro_torch.models.model import check_supported
from repro_torch.stream.online import _LayerState


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out[prefix] = np.asarray(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Params:
    """The reference's (dense) parameter pytree -> the port's flat dict of
    float32 leaf tensors that require grad."""
    check_supported(cfg)
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    out: Dict[str, np.ndarray] = {}
    for name, arr in flat.items():
        if name.startswith("layers."):  # (n_layers, ...) stacked by vmap
            rest = name[len("layers."):]
            for i in range(arr.shape[0]):
                out[f"layers.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    want = param_shapes(cfg)
    if set(out) != set(want):
        raise ValueError(f"parameter names differ from {cfg.name}'s: "
                         f"missing {sorted(set(want) - set(out))}, "
                         f"extra {sorted(set(out) - set(want))}")
    for name, shape in want.items():
        if tuple(out[name].shape) != tuple(shape):
            raise ValueError(f"{name}: shape {out[name].shape}, "
                             f"expected {shape}")
    return {name: torch.tensor(out[name], dtype=torch.float32,
                               device=dev).requires_grad_()
            for name in want}


def gmm_params_from_numpy(params, device: DeviceLike = None) -> GMMParams:
    """The port's GMMParams from a reference fit (or any (log_weights,
    means, prec_chol) triple of array-likes)."""
    dev = resolve_device(device)
    return GMMParams(*(torch.tensor(np.asarray(p), dtype=torch.float32,
                                    device=dev) for p in params))


def suff_stats_from_numpy(stats, device: DeviceLike = None) -> SuffStats:
    """The port's SuffStats from the reference's (or any (nk, sx, sxx)
    triple of array-likes)."""
    dev = resolve_device(device)
    return SuffStats(*(torch.tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev) for a in stats))


def layer_state_from_numpy(state, device: DeviceLike = None) -> _LayerState:
    """One layer's state of the reference's ``OnlineGMMDetector`` (its
    ``_LayerState``: params, stats, medians, mean/std, log_delta, ll_fit and
    the counters) as the port's, with the GMM on ``device``."""
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(_LayerState)}
    fields["params"] = gmm_params_from_numpy(state.params, device)
    if state.stats is not None:
        fields["stats"] = suff_stats_from_numpy(state.stats, device)
    fields["medians"] = {str(k): float(v) for k, v in state.medians.items()}
    fields["mean"] = np.array(state.mean)
    fields["std"] = np.array(state.std)
    for name in ("global_median", "log_delta", "ll_fit", "last_ts"):
        fields[name] = float(fields[name])
    return _LayerState(**fields)
