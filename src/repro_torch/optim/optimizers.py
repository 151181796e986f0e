"""AdamW and Adafactor with global-norm gradient clipping — port of
`repro/optim/optimizers.py`.

On flat dicts of tensors, where the reference's ``update`` returns the
updates, the port applies them in place:
    opt = adamw(schedule, layout=stack_layout(cfg))
    state = opt.init(params)
    sc = opt.scalars(state["step"] + 1)        # the step's host floats
    gnorm = opt.step_(grads, state, params, sc)   # params += updates
    state = opt.advance(state, state["step"] + 1, sc, gnorm)
The step count is a host int, so no update reads a value off the device.
The moments are updated in place (one copy of them in device memory), and
``step_`` works piece by piece with the gradients clipped in their own
buffers, so no second model-sized copy of the gradients or the updates is
ever held. A CUDA graph captures ``step_`` with the scalars (learning rate,
bias corrections, Adafactor's ``beta2``) in 0-dim device tensors, which the
caller fills before each replay (`train.step.make_train_step`); the eager
step passes the host floats, and both give the same numbers bit for bit.

The reference applies both optimizers to its *stacked* leaves (layers on
leading axes: `repro_torch.config.stack_layout`). What depends on a leaf's
rank follows the stacked rank here too: weight decay (rank >= 2, so a
stacked per-layer norm scale is decayed and a ``head_layers`` one is not)
and Adafactor's factoring; Adafactor's factored moments of stacked
per-layer vectors and its update clipping span the whole stacked leaf, so
the per-layer tensors are grouped as the reference stacks them.

On a mesh each rank holds its pieces of the parameters, gradients and
moments (the moments follow the parameters' specs, a factored moment the
spec less its reduced dim: the reference's ``opt_state_pspecs``), and a
`Shards` object makes every reduction span the pieces: the global norm,
Adafactor's row and column means and its update RMS.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
# name -> (the reference's leaf, index into its stacked axes, their sizes)
Layout = Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...]]]
# tensors a piece of ``step_`` works on at once (bounds its temporaries)
STEP_CHUNK_BYTES = 1 << 30


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    # step -> its host scalars
    scalars: Callable[[int], Dict[str, float]]
    # (grads, state, params, scalars) -> grad norm: the update applied to
    # the parameters in place, the grads clipped in place
    step_: Callable[..., torch.Tensor]
    # (state, step, scalars, grad norm) -> the new state
    advance: Callable[..., Any]


class Shards:
    """How each parameter is split over a mesh: ``specs`` (name -> spec),
    ``axes`` (`repro_torch.models.sharding.Axis` by name). Reductions over
    a split dim are summed over the ranks holding its pieces."""

    def __init__(self, specs: Dict[str, Any], axes: Dict[str, Any]):
        from repro_torch.models.sharding import entry_axes

        self.axes = axes
        self.dims = {k: {d: [axes[a] for a in entry_axes(e)
                             if axes[a].size > 1]
                         for d, e in enumerate(spec)}
                     for k, spec in specs.items()}
        self.split = {k: [ax for d in dims.values() for ax in d]
                      for k, dims in self.dims.items()}
        # ranks holding the same piece (its copies)
        self.copies = {k: math.prod(ax.size for ax in axes.values())
                       // math.prod(ax.size for ax in self.split[k])
                       for k in specs}

    def sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        from repro_torch.models.sharding import all_reduce_

        for ax in axes:
            x = all_reduce_(x, ax)
        return x

    def mean(self, x: torch.Tensor, key: str, dim: int,
             param_dim: Optional[int]) -> torch.Tensor:
        """``torch.mean(x, dim)`` where that dim of ``x`` is parameter
        ``key``'s ``param_dim`` (None: a stacking dim, never split)."""
        axes = self.dims[key].get(param_dim, []) \
            if param_dim is not None else []
        if not axes:
            return torch.mean(x, dim=dim)
        n = x.shape[dim] * math.prod(ax.size for ax in axes)
        return self.sum_over(torch.sum(x, dim=dim), axes) / n

    def norm(self, keys: List[str], grads: List[torch.Tensor]
             ) -> torch.Tensor:
        """The global L2 norm of the pieces ``grads`` of ``keys``."""
        norms = torch.stack(torch._foreach_norm(grads))
        sq = torch.sum(norms * norms / torch.tensor(
            [float(self.copies[k]) for k in keys], device=norms.device))
        return torch.sqrt(self.sum_over(sq, self.axes.values()))


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The gradients' global L2 norm (a device scalar: no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that scales gradients of global norm ``norm`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip_(grads: Tensors, max_norm: float,
           shards: Optional[Shards] = None) -> torch.Tensor:
    """``grads`` scaled in place to a global L2 norm of at most
    ``max_norm``; the norm before clipping."""
    keys, gs = list(grads), list(grads.values())
    norm = (shards.norm(keys, gs) if shards is not None
            else _global_norm(gs))
    torch._foreach_mul_(gs, _clip_scale(norm, max_norm))
    return norm


def stacked_rank(params: Tensors, layout: Layout) -> Dict[str, int]:
    """Each parameter's rank as the reference's stacked leaf."""
    return {k: p.dim() + len(layout[k][2]) for k, p in params.items()}


def _chunks(keys: List[str], params: Tensors) -> List[List[str]]:
    out, cur, size = [], [], 0
    for k in keys:
        nbytes = params[k].numel() * 4
        if cur and size + nbytes > STEP_CHUNK_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(k)
        size += nbytes
    return out + [cur] if cur else out


def adamw(lr_fn: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0, *, layout: Layout,
          shards: Optional[Shards] = None) -> Optimizer:
    def init(params: Tensors):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"step": 0, "mu": zeros,
                "nu": {k: z.clone() for k, z in zeros.items()},
                "grad_norm": 0.0, "lr": 0.0}

    def scalars(step: int) -> Dict[str, float]:
        return {"lr": lr_fn(step), "bc1": 1 - b1 ** step,
                "bc2": 1 - b2 ** step}

    def updates_of(keys: List[str], g: List[torch.Tensor], state,
                   params: Tensors, sc, decays) -> List[torch.Tensor]:
        """The updates of ``keys`` from their clipped gradients ``g``; the
        moments of ``keys`` are updated in place."""
        # multi-tensor (foreach) arithmetic: a handful of launches for the
        # whole model instead of a dozen per parameter
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        denom = torch._foreach_div(nu, sc["bc2"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(mu, sc["bc1"])
        torch._foreach_div_(u, denom)
        decay = [i for i, k in enumerate(keys) if decays[k]]
        if decay:
            torch._foreach_add_([u[i] for i in decay],
                                [params[keys[i]].detach().to(torch.float32)
                                 for i in decay], alpha=weight_decay)
        torch._foreach_mul_(u, -sc["lr"])
        return u

    def step_(grads: Tensors, state, params: Tensors, sc) -> torch.Tensor:
        """The update with the step's scalars ``sc`` (host floats, or 0-dim
        tensors holding them) added to ``params``; the moments are updated
        in place. Returns the gradients' global norm before clipping."""
        keys = list(params)
        gnorm = _clip_({k: grads[k] for k in keys}, grad_clip, shards)
        decays = {k: r >= 2 for k, r in stacked_rank(params, layout).items()}
        with torch.no_grad():
            for part in _chunks(keys, params):
                u = updates_of(part, [grads[k] for k in part], state, params,
                               sc, decays)
                torch._foreach_add_([params[k] for k in part], u)
        return gnorm

    def advance(state, step: int, sc: Dict[str, float], gnorm):
        return {"step": step, "mu": state["mu"], "nu": state["nu"],
                "grad_norm": gnorm, "lr": sc["lr"]}

    return Optimizer(init, scalars, step_, advance)


def adafactor(lr_fn: Callable[[int], float], eps: float = 1e-30,
              clip_threshold: float = 1.0, decay_rate: float = 0.8,
              weight_decay: float = 0.0, grad_clip: float = 1.0, *,
              layout: Layout, shards: Optional[Shards] = None) -> Optimizer:
    """Shazeer & Stern 2018, no-momentum variant, as the reference's
    (`repro/optim/optimizers.py:70-126`): a stacked leaf of rank >= 2 keeps
    factored (row, col) second moments over its last two axes, a vector the
    full ones; the update's RMS is clipped to ``clip_threshold`` over the
    whole stacked leaf. The moments live in the reference's stacked shapes
    (``m[leaf]``); a layer reads and updates its slice in place."""

    def groups(params: Tensors):
        """leaf -> (stacked sizes, the leaf's members in stacking order)."""
        out: Dict[str, Tuple[Tuple[int, ...], List[Tuple[str, Tuple]]]] = {}
        for k in params:
            leaf, idx, stacked = layout[k]
            out.setdefault(leaf, (stacked, []))[1].append((k, idx))
        for stacked, members in out.values():
            members.sort(key=lambda m: m[1])
        return out

    def init(params: Tensors):
        m = {}
        for leaf, (stacked, members) in groups(params).items():
            p = params[members[0][0]]
            shape = tuple(stacked) + tuple(p.shape)
            kw = {"dtype": torch.float32, "device": p.device}
            if len(shape) >= 2:
                m[leaf] = {"vr": torch.zeros(shape[:-1], **kw),
                           "vc": torch.zeros(shape[:-2] + shape[-1:], **kw)}
            else:
                m[leaf] = {"v": torch.zeros(shape, **kw)}
        return {"step": 0, "m": m, "grad_norm": 0.0, "lr": 0.0}

    def scalars(step: int) -> Dict[str, float]:
        # 1 - beta2 is a scalar of its own: taken from a float32 beta2 it
        # would round otherwise than from the host's, and the graphed step
        # would part from the eager one
        rate = step ** (-decay_rate)
        return {"lr": lr_fn(step), "beta2": 1.0 - rate, "1-beta2": rate}

    def mean(x, key, dim, param_dim):
        if shards is None:
            return torch.mean(x, dim=dim)
        return shards.mean(x, key, dim, param_dim)

    def factored_u(g, vr, vc, sc, key, dims):
        """One factored leaf (or one layer's slice of it): its moments
        updated in place, and g over their root. ``dims``: the parameter
        dims of g's last two (None: a stacking dim)."""
        g2 = g * g + eps
        vr.mul_(sc["beta2"]).add_(mean(g2, key, -1, dims[1])
                                  * sc["1-beta2"])
        vc.mul_(sc["beta2"]).add_(mean(g2, key, -2, dims[0])
                                  * sc["1-beta2"])
        del g2
        denom = torch.clamp(mean(vr, key, -1, dims[0])[..., None],
                            min=eps)[..., None]
        u = g / torch.sqrt(vr[..., None] / denom)
        return u.div_(torch.sqrt(vc[..., None, :]))

    def leaf_updates(stacked, members, g: List[torch.Tensor], mom,
                     ps: List[torch.Tensor], sc) -> List[torch.Tensor]:
        """The updates of one stacked leaf's members, in their order."""
        r = g[0].dim()
        key = members[0][0]
        if len(stacked) + r < 2:  # an unstacked vector: full moments
            g2 = g[0] * g[0] + eps
            mom["v"].mul_(sc["beta2"]).add_(g2 * sc["1-beta2"])
            us = [g[0] / torch.sqrt(mom["v"])]
        elif r >= 2:  # per-layer matrices: each layer's slice on its own
            us = [factored_u(gi, mom["vr"][idx] if idx else mom["vr"],
                             mom["vc"][idx] if idx else mom["vc"], sc,
                             key, (r - 2, r - 1))
                  for gi, (_, idx) in zip(g, members)]
        else:  # stacked per-layer vectors: factored across the layers
            stacked_g = torch.stack(g).reshape(tuple(stacked) + g[0].shape)
            u = factored_u(stacked_g, mom["vr"], mom["vc"], sc, key,
                           (None, 0))
            us = list(u.reshape(len(g), -1).unbind(0))
        # update clipping: RMS(u) <= clip_threshold over the stacked leaf
        n = sum(u.numel() for u in us)
        norms = torch.stack(torch._foreach_norm(us))
        sq = torch.sum(norms * norms)
        if shards is not None and shards.split[key]:
            n *= math.prod(ax.size for ax in shards.split[key])
            sq = shards.sum_over(sq, shards.split[key])
        rms = torch.sqrt(sq / n)
        torch._foreach_div_(us, torch.clamp(rms / clip_threshold, min=1.0))
        if weight_decay and len(stacked) + r >= 2:
            torch._foreach_add_(us, [p.detach().to(torch.float32)
                                     for p in ps], alpha=weight_decay)
        torch._foreach_mul_(us, -sc["lr"])
        return us

    def each_leaf(grads: Tensors, state, params: Tensors, sc):
        for leaf, (stacked, members) in groups(params).items():
            keys = [k for k, _ in members]
            yield keys, leaf_updates(stacked, members,
                                     [grads[k] for k in keys],
                                     state["m"][leaf],
                                     [params[k] for k in keys], sc)

    def step_(grads: Tensors, state, params: Tensors, sc) -> torch.Tensor:
        gnorm = _clip_({k: grads[k] for k in params}, grad_clip, shards)
        with torch.no_grad():
            for ks, us in each_leaf(grads, state, params, sc):
                torch._foreach_add_([params[k] for k in ks], us)
        return gnorm

    def advance(state, step: int, sc: Dict[str, float], gnorm):
        return {"step": step, "m": state["m"], "grad_norm": gnorm,
                "lr": sc["lr"]}

    return Optimizer(init, scalars, step_, advance)


def moments(opt_state) -> List[torch.Tensor]:
    """The optimizer state's moment tensors (AdamW's ``mu``/``nu``,
    Adafactor's ``m``), in a fixed order."""
    out: List[torch.Tensor] = []

    def walk(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k])
        elif isinstance(tree, torch.Tensor):
            out.append(tree)

    for key in ("mu", "nu", "m"):
        if key in opt_state:
            walk(opt_state[key])
    return out


def make_optimizer(name: str, lr_fn: Callable[[int], float],
                   weight_decay: float = 0.1, grad_clip: float = 1.0, *,
                   layout: Layout, shards: Optional[Shards] = None
                   ) -> Optimizer:
    """``layout``: `repro_torch.config.stack_layout` of the model;
    ``shards``: how its parameters split over a mesh (None: whole)."""
    if name == "adamw":
        return adamw(lr_fn, weight_decay=weight_decay, grad_clip=grad_clip,
                     layout=layout, shards=shards)
    if name == "adafactor":
        return adafactor(lr_fn, weight_decay=weight_decay,
                         grad_clip=grad_clip, layout=layout, shards=shards)
    raise ValueError(f"unknown optimizer {name}")
