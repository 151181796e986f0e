"""AdamW with global-norm gradient clipping — port of the ``adamw`` of
`repro/optim/optimizers.py` (Adafactor comes with a later slice).

Same minimal interface as the reference, on flat dicts of tensors:
    opt = adamw(schedule, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)   # apply: p + u
The step count is a host int, so no update reads a value off the device.
The moments are updated in place (one copy of them in device memory).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``grads`` scaled to a global L2 norm of at most ``max_norm``, and the
    norm before clipping (a device scalar: no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return torch._foreach_mul(grads, scale), norm


def _decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to matrices and, as in the reference, to every
    per-layer tensor: the reference stacks layers on a leading axis, so its
    per-layer norm scales and biases are 2-D and decayed too (the final
    norm is not)."""
    return p.dim() >= 2 or name.startswith("layers.")


def adamw(lr_fn: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params: Tensors):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"step": 0, "mu": zeros,
                "nu": {k: z.clone() for k, z in zeros.items()},
                "grad_norm": 0.0, "lr": 0.0}

    def update(grads: Tensors, state, params: Tensors):
        # multi-tensor (foreach) arithmetic: a handful of launches for the
        # whole model instead of a dozen per parameter; the moments are
        # updated in place
        keys = list(params)
        g, gnorm = _clip_by_global_norm(
            [grads[k].to(torch.float32) for k in keys], grad_clip)
        step = state["step"] + 1
        lr = lr_fn(step)
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        denom = torch._foreach_div(nu, 1 - b2 ** step)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(mu, 1 - b1 ** step)
        torch._foreach_div_(u, denom)
        decay = [i for i, k in enumerate(keys) if _decays(k, params[k])]
        torch._foreach_add_([u[i] for i in decay],
                            [params[keys[i]].detach().to(torch.float32)
                             for i in decay], alpha=weight_decay)
        torch._foreach_mul_(u, -lr)
        updates = {k: x.to(params[k].dtype) for k, x in zip(keys, u)}
        return updates, {"step": step, "mu": state["mu"], "nu": state["nu"],
                         "grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn: Callable[[int], float],
                   weight_decay: float = 0.1,
                   grad_clip: float = 1.0) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, weight_decay=weight_decay, grad_clip=grad_clip)
    raise ValueError(f"optimizer {name!r} not ported yet (adamw only)")
