"""Carry the JAX package's weights and GMM fits into the port.

`params_from_jax` takes the reference's ``init_params`` pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's flat
parameter dict, so both packages compute the same function. The reference
stacks the layers on a leading axis (its ``vmap`` init and ``scan``
forward); here they are unstacked into ``layers.{i}.*``. Both packages keep
kernels as ``(d_in, d_out)`` and apply them as ``x @ W``, so no kernel is
transposed. Nothing here imports JAX: the inputs are plain arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig, param_shapes
from repro_torch.core.gmm import GMMParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Params
from repro_torch.models.model import check_supported


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
