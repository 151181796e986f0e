"""Training step factory: loss + grad + optimizer, with microbatch gradient
accumulation (port of `repro/train/step.py`; the reference's
``mixed_precision`` runtime lever, bf16 forward weights over float32
masters, is what the port's forward does anyway: weights are cast to the
compute dtype where they are used).

The reference jit-compiles the whole step into one executable. Run eagerly
on the card, GPT-2's forward, backward and optimizer are nearly two
thousand small launches, each paid for on the host, so the step time would
be the host's and would wander with its load. On a CUDA device the whole
step — forward, backward and the optimizer's update — is therefore
captured once in a CUDA graph (`CudaGraphed`) and replayed every step. The
optimizer's host-side schedule (learning rate, bias corrections) reaches
the graph through 0-dim device tensors filled before each replay, so the
host's part of a step is those fills, the batch's copy and one graph
launch, and a host stall while the card runs the step lengthens the step
only if it lasts past the step's end.

On a mesh (``rt.mesh``) the state holds each rank's pieces, laid out by
`param_partition_specs` (`init_train_state`; moments as their parameters, a
factored Adafactor moment less its reduced dim: the reference's
``opt_state_pspecs``), the step takes the global batch, the gradients are
summed over the batch's pieces inside the backward (so inside the step's
graph), and the optimizer updates each rank's pieces with its reductions
spanning the mesh (`optim.optimizers.Shards`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import (ModelConfig, TrainConfig, param_shapes,
                                stack_layout)
from repro_torch.device import DeviceLike
from repro_torch.models.layers import Params
from repro_torch.models.model import (Runtime, batch_to_device, init_params,
                                      loss_fn, param_partition_specs)
from repro_torch.models.sharding import P, distribute
from repro_torch.optim import Optimizer, make_optimizer, make_schedule
from repro_torch.optim.optimizers import Shards, moments

Batch = Dict[str, torch.Tensor]
# (loss, metrics, grads in the order of params) — all detached
LossAndGrads = Tuple[torch.Tensor, Dict[str, torch.Tensor],
                     Tuple[torch.Tensor, ...]]


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


def init_train_state(cfg: ModelConfig, opt: Optimizer, seed: int = 0,
                     device: DeviceLike = None,
                     generator_device: DeviceLike = "cpu",
                     rt: Optional[Runtime] = None) -> TrainState:
    """The initial state; on ``rt``'s mesh, this rank's pieces of it (every
    rank draws the same whole parameters from ``seed``)."""
    params = init_params(cfg, seed=seed, device=device,
                         generator_device=generator_device)
    if rt is not None and rt.mesh is not None:
        specs = param_partition_specs(cfg, rt, param_shapes(cfg))
        params = {k: distribute(p, specs[k], rt.mesh).requires_grad_()
                  for k, p in params.items()}
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def mesh_shards(cfg: ModelConfig, rt: Optional[Runtime]
                ) -> Optional[Shards]:
    """How the parameters split over ``rt``'s mesh, for the optimizer's
    reductions; None without a mesh or on a mesh of one rank (whose
    reductions are the local ones, bit for bit)."""
    if rt is None or rt.mesh is None or rt.mesh.size() == 1:
        return None
    return Shards(param_partition_specs(cfg, rt, param_shapes(cfg)),
                  rt.axes)


def make_optimizer_for(cfg_t: TrainConfig, cfg: ModelConfig,
                       rt: Optional[Runtime] = None) -> Optimizer:
    """``cfg``: the model, whose stacking (`stack_layout`) decides weight
    decay and Adafactor's factoring as the reference's stacked leaves do;
    ``rt``: its runtime, whose mesh the optimizer's reductions span."""
    sched = make_schedule(cfg_t.schedule, cfg_t.learning_rate,
                          cfg_t.warmup_steps, cfg_t.total_steps)
    return make_optimizer(cfg_t.optimizer, sched,
                          weight_decay=cfg_t.weight_decay,
                          grad_clip=cfg_t.grad_clip,
                          layout=stack_layout(cfg),
                          shards=mesh_shards(cfg, rt))


def state_specs(cfg: ModelConfig, rt: Runtime, state: TrainState
                ) -> TrainState:
    """The specs of a train state's tensors, in its structure (None for
    its numbers): the parameters' `param_partition_specs`, AdamW's moments
    the same, Adafactor's factored moments their stacked leaf's spec less
    the reduced dim (`repro/launch/specs.py:63-80`)."""
    pspecs = param_partition_specs(cfg, rt, param_shapes(cfg))
    opt = state.opt_state
    ospecs: Dict[str, Any] = {k: None for k in opt}
    for key in ("mu", "nu"):
        if key in opt:
            ospecs[key] = dict(pspecs)
    if "m" in opt:
        leaf_spec = {}
        for name, (leaf, _, stacked) in stack_layout(cfg).items():
            rank = len(param_shapes(cfg)[name])
            spec = tuple(pspecs[name]) + (None,) * (rank - len(pspecs[name]))
            leaf_spec[leaf] = (None,) * len(stacked) + spec
        ospecs["m"] = {}
        for leaf, mom in opt["m"].items():
            e = leaf_spec[leaf]
            ospecs["m"][leaf] = ({"v": P(*e)} if "v" in mom else
                                 {"vr": P(*e[:-1]),
                                  "vc": P(*(e[:-2] + e[-1:]))})
    return TrainState(params=pspecs, opt_state=ospecs, step=None)


def make_loss_and_grads(cfg: ModelConfig, rt: Runtime, microbatches: int = 1,
                        grad_dtype: torch.dtype = torch.bfloat16
                        ) -> Callable[[Params, Batch], LossAndGrads]:
    """fn(params, batch) -> (loss, metrics, grads): forward and backward,
    over ``microbatches`` slices of the batch (module docstring)."""

    def single(params: Params, batch: Batch) -> LossAndGrads:
        loss, metrics = loss_fn(params, cfg, rt, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def accumulated(params: Params, batch: Batch) -> LossAndGrads:
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} does not split into "
                             f"{microbatches} microbatches")
        plist = list(params.values())
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in plist]

        def add_to(a):
            # each parameter's gradient is added to the accumulator as soon
            # as the backward has it, and freed: no microbatch's whole set
            # of gradients is ever held beside the accumulator
            def hook(p):
                with torch.no_grad():
                    a.add_(p.grad.to(grad_dtype))
                p.grad = None
            return hook

        for p in plist:
            p.grad = None
        hooks = [p.register_post_accumulate_grad_hook(add_to(a))
                 for p, a in zip(plist, acc)]
        loss_sum = None
        try:
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
                loss, metrics = loss_fn(params, cfg, rt, mb)
                torch.autograd.backward(loss, inputs=plist)
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
        with torch.no_grad():
            torch._foreach_div_(acc, float(microbatches))
        return (loss_sum / microbatches,
                {k: v.detach() for k, v in metrics.items()}, tuple(acc))

    return single if microbatches == 1 else accumulated


class CudaGraphed:
    """``fn(params, batch) -> (loss, metrics, grads)`` captured in a CUDA
    graph and replayed: `make_loss_and_grads`'s function, or the whole train
    step (`make_train_step`, which returns no grads).

    The first ``WARMUP`` calls run eagerly on the caller's stream (lazy
    library set-up must not happen during capture); the next call copies
    its batch into static buffers, captures, and replays. Later calls copy
    the batch in and replay. The graph reads the parameters by address, so
    the caller must update them in place, and every batch must have the
    first one's shapes: both are checked. Grads are the graph's own buffers, overwritten
    by the next replay; loss and metrics are returned as copies."""

    WARMUP = 2

    def __init__(self, fn: Callable[[Params, Batch], LossAndGrads]):
        self.fn = fn
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._batch: Batch = {}
        self._ptrs: List[int] = []
        self._out: Optional[LossAndGrads] = None

    def __call__(self, params: Params, batch: Batch) -> LossAndGrads:
        if next(iter(params.values())).device.type != "cuda":
            raise ValueError("CudaGraphed runs on CUDA tensors only")
        self.calls += 1
        if self.calls <= self.WARMUP:
            # on the caller's stream: kernels on a second stream move the
            # graph's later replays between two levels ~5% apart
            # (scripts/step_levels.py)
            return self.fn(params, batch)
        ptrs = [p.data_ptr() for p in params.values()]
        if self.graph is None:
            self._batch = {k: v.clone() for k, v in batch.items()}
            self._ptrs = ptrs
            self.graph = torch.cuda.CUDAGraph()
            # thread-local: a detection sweep that touches CUDA from another
            # thread during the capture must not invalidate it
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self._out = self.fn(params, self._batch)
        else:
            if ptrs != self._ptrs:
                raise ValueError("parameters moved since the graph was "
                                 "captured: update them in place")
            for k, v in batch.items():
                if v.shape != self._batch[k].shape:
                    raise ValueError(f"batch[{k!r}] has shape "
                                     f"{tuple(v.shape)}; the graph was "
                                     f"captured at "
                                     f"{tuple(self._batch[k].shape)}")
                self._batch[k].copy_(v)
        self.graph.replay()
        loss, metrics, grads = self._out
        return loss.clone(), {k: v.clone() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, rt: Runtime, opt: Optimizer,
                    microbatches: int = 1, cuda_graph: bool = True
                    ) -> Callable:
    """Returns step(state, batch) -> (state, metrics). ``batch`` holds numpy
    arrays or tensors; it is moved to the parameters' device.

    On a CUDA device the forward, backward and update run as one CUDA graph
    unless ``cuda_graph=False``. The parameters and the optimizer's moments
    are updated in place (`Optimizer.step_`) to keep one copy of them; the
    returned state holds the same tensors. Metrics stay on the device:
    reading one is the caller's sync. On a mesh ``batch`` is the global
    batch and the state this rank's pieces (`init_train_state`)."""
    loss_and_grads = make_loss_and_grads(cfg, rt, microbatches)
    # what the graphed step reads by address: the optimizer state's moments
    # and the step's scalars (0-dim tensors, filled before each call)
    live: Dict[str, Any] = {}

    def update(params: Params, grads, opt_state, sc) -> torch.Tensor:
        with torch.no_grad():
            return opt.step_(dict(zip(params, grads)), opt_state, params, sc)

    def whole_step(params: Params, batch: Batch) -> LossAndGrads:
        loss, metrics, grads = loss_and_grads(params, batch)
        gnorm = update(params, grads, live["opt_state"], live["scalars"])
        return loss, {**metrics, "grad_norm": gnorm}, ()

    graphed = CudaGraphed(whole_step) if cuda_graph else None

    def addresses(opt_state) -> List[int]:
        return [t.data_ptr() for t in moments(opt_state)]

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        device = next(iter(params.values())).device
        if isinstance(next(iter(batch.values())), np.ndarray):
            batch = batch_to_device(batch, device)
        n = state.opt_state["step"] + 1
        sc = opt.scalars(n)
        if graphed is not None and device.type == "cuda":
            if not live:
                live["scalars"] = {k: torch.zeros((), device=device)
                                   for k in sc}
                live["moments"] = addresses(state.opt_state)
            elif addresses(state.opt_state) != live["moments"]:
                raise ValueError("the optimizer's moments moved since the "
                                 "first step, and the graphed step reads "
                                 "them by address: update them in place")
            for k, v in sc.items():
                live["scalars"][k].fill_(v)
            live["opt_state"] = state.opt_state
            loss, metrics, _ = graphed(params, batch)
            gnorm = metrics.pop("grad_norm")
        else:
            loss, metrics, grads = loss_and_grads(params, batch)
            gnorm = update(params, grads, state.opt_state, sc)
        opt_state = opt.advance(state.opt_state, n, sc, gnorm)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        out = {"loss": loss, "grad_norm": opt_state["grad_norm"],
               "lr": opt_state["lr"], **metrics}
        return new_state, out

    step.mesh = rt.mesh  # what the monitor reads the collectives of
    return step
