"""Carry the JAX package's weights, GMM fits and streaming-detector state
into the port.

`params_from_jax` takes the reference's ``init_params`` pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's flat
parameter dict, so both packages compute the same function. The reference
stacks the layers on leading axes (its ``vmap`` init and ``scan``
forward), each family its own way (`repro_torch.config.stack_layout`:
a list ``head_layers``, ``layers`` by layer or by (group, layer), ``tail``,
an unstacked ``shared``); here they are unstacked into ``layers.{i}.*``.
Both packages keep
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

from repro_torch.config import ModelConfig, param_shapes, stack_layout
from repro_torch.core.gmm import GMMParams, SuffStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Params
from repro_torch.stream.online import _LayerState


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out[prefix] = np.asarray(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Params:
    """The reference's parameter pytree -> the port's flat dict of float32
    leaf tensors that require grad."""
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    want = param_shapes(cfg)
    layout = stack_layout(cfg)
    leaves = {leaf for leaf, _, _ in layout.values()}
    if leaves != set(flat):
        raise ValueError(f"parameter names differ from {cfg.name}'s: "
                         f"missing {sorted(leaves - set(flat))}, "
                         f"extra {sorted(set(flat) - leaves)}")
    out: Dict[str, np.ndarray] = {}
    for name, (leaf, idx, stacked) in layout.items():
        arr = flat[leaf]
        if tuple(arr.shape) != tuple(stacked) + tuple(want[name]):
            raise ValueError(f"{leaf}: shape {arr.shape}, expected "
                             f"{tuple(stacked) + tuple(want[name])}")
        out[name] = arr[idx] if idx else arr
    return {name: torch.tensor(np.asarray(out[name]), dtype=torch.float32,
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
