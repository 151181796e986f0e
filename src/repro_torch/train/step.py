"""Training step factory: loss + grad + optimizer (port of
`repro/train/step.py` with ``microbatches=1``; gradient accumulation and
mixed-precision masters come with a later slice).

The reference jit-compiles the whole step into one executable. Run eagerly
on the card, GPT-2's forward, backward and optimizer are nearly two
thousand small launches, each paid for on the host, so the step time would
be the host's and would wander with its load. On a CUDA device the forward and backward
are therefore captured once in a CUDA graph (`CudaGraphed`) and replayed
every step; the optimizer runs eagerly after the replay, so its host-side
schedule (learning rate, bias corrections) needs no graph support.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike
from repro_torch.models.layers import Params
from repro_torch.models.model import (Runtime, batch_to_device, init_params,
                                      loss_fn)
from repro_torch.optim import Optimizer, make_optimizer, make_schedule

Batch = Dict[str, torch.Tensor]
# (loss, metrics, grads in the order of params) — all detached
LossAndGrads = Tuple[torch.Tensor, Dict[str, torch.Tensor],
                     Tuple[torch.Tensor, ...]]


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


def init_train_state(cfg: ModelConfig, opt: Optimizer, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    params = init_params(cfg, seed=seed, device=device)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def make_optimizer_for(cfg_t: TrainConfig) -> Optimizer:
    sched = make_schedule(cfg_t.schedule, cfg_t.learning_rate,
                          cfg_t.warmup_steps, cfg_t.total_steps)
    return make_optimizer(cfg_t.optimizer, sched,
                          weight_decay=cfg_t.weight_decay,
                          grad_clip=cfg_t.grad_clip)


def make_loss_and_grads(cfg: ModelConfig, rt: Runtime
                        ) -> Callable[[Params, Batch], LossAndGrads]:
    """fn(params, batch) -> (loss, metrics, grads): forward and backward."""

    def loss_and_grads(params: Params, batch: Batch) -> LossAndGrads:
        loss, metrics = loss_fn(params, cfg, rt, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    return loss_and_grads


class CudaGraphed:
    """``loss_and_grads`` captured in a CUDA graph and replayed.

    The first ``WARMUP`` calls run eagerly on a side stream (lazy library
    set-up must not happen during capture); the next call copies its batch
    into static buffers, captures, and replays. Later calls copy the batch
    in and replay. The graph reads the parameters by address, so the caller
    must update them in place, and every batch must have the first one's
    shapes: both are checked. Grads are the graph's own buffers, overwritten
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
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self.fn(params, batch)
            torch.cuda.current_stream().wait_stream(side)
            return out
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

    On a CUDA device the forward and backward run as a CUDA graph unless
    ``cuda_graph=False``. The parameters are updated in place (``p += u``
    under ``no_grad``) to keep one copy of the weights; the returned state
    holds the same tensors. Metrics stay on the device: reading one is the
    caller's sync."""
    if microbatches != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    loss_and_grads = make_loss_and_grads(cfg, rt)
    graphed = CudaGraphed(loss_and_grads) if cuda_graph else None

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        device = next(iter(params.values())).device
        if isinstance(next(iter(batch.values())), np.ndarray):
            batch = batch_to_device(batch, device)
        run = graphed if graphed is not None and device.type == "cuda" \
            else loss_and_grads
        loss, metrics, grads = run(params, batch)
        with torch.no_grad():
            updates, opt_state = opt.update(dict(zip(params, grads)),
                                            state.opt_state, params)
            torch._foreach_add_(list(params.values()),
                                [updates[k] for k in params])
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        out = {"loss": loss, "grad_norm": opt_state["grad_norm"],
               "lr": opt_state["lr"], **metrics}
        return new_state, out

    return step
