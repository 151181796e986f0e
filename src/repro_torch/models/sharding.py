"""Partition specs on a `torch.distributed` DeviceMesh, and the explicit,
autograd-aware collectives the sharded model runs.

A spec (`P`) names, for each dim of a global tensor, the mesh axes it is
split over (None: none), as the reference's ``PartitionSpec`` does. An
entry naming several axes splits the dim over all of them, the first one
major: piece ``i_data * n_model + i_model`` of a ("data", "model") entry
lies on rank (i_data, i_model), as in JAX and in DTensor's placements
(`placements`: ``Shard(dim)`` on each mesh dim the spec names,
``Replicate()`` on the others).

The sharded model computes on local tensors, each rank its piece, and
moves them with `torch.distributed`'s functional collectives
(``_c10d_functional``: what the step's CUDA graph captures, and what the
operator probe's meta record sees and the COLLECTIVE layer reads off).
Every move is an `autograd.Function` with its transpose as backward:

    gather   all-gather       | take this rank's chunk (a replicated
                              |   consumer: its gradient is replicated)
    chunk    take the chunk   | all-gather
    gather_sum all-gather     | reduce-scatter (the consumer's gradient
                              |   is this rank's part of a sum)
    sum_grad identity         | all-reduce
    sum_fwd  all-reduce       | identity
    all_to_all                | all_to_all back

The convention behind them: every rank ends a forward with the global loss,
and its backward gives the gradient of its own share of the work (its
batch piece; inside a tensor-parallel region, its heads or tokens). A
weight's gradient is then summed over the axes its use was split over
(`use_weight`). A group of one issues nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

_F = torch.ops._c10d_functional


class P(tuple):
    """A partition spec: one entry per leading tensor dim (trailing dims
    unnamed are replicated), each None, an axis name or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_sizes(mesh) -> Dict[str, int]:
    """axis name -> size, for a DeviceMesh or any object whose ``shape``
    maps names to sizes (the reference's ``Mesh.shape``)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def spec_dims(spec: Sequence) -> Dict[str, int]:
    """axis -> the tensor dim the spec splits over it."""
    return {a: d for d, e in enumerate(spec) for a in entry_axes(e)}


def placements(spec: Sequence, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``."""
    names = list(mesh.mesh_dim_names)
    out: List = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec!r} names {unknown}, not axes of "
                             f"the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            # DTensor splits a dim over mesh dims in mesh order, major first
            raise ValueError(f"spec {spec!r} orders {axes} against the "
                             f"mesh's {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


# ---------------------------------------------------------------------------
# Collectives over one mesh axis
# ---------------------------------------------------------------------------


class Axis:
    """One mesh axis: its process group, size and this rank's index."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.size = axis_sizes(mesh)[name]
        self.group = mesh.get_group(name)
        self.rank = mesh.get_local_rank(name)

    @property
    def group_name(self) -> str:
        return self.group.group_name


def _all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return _F.wait_tensor(_F.all_reduce(x.contiguous(), "sum",
                                        ax.group_name))


def _all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    y = _F.all_gather_into_tensor(x.movedim(dim, 0).contiguous(), ax.size,
                                  ax.group_name)
    return _F.wait_tensor(y).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    y = _F.reduce_scatter_tensor(x.movedim(dim, 0).contiguous(), "sum",
                                 ax.size, ax.group_name)
    return _F.wait_tensor(y).movedim(0, dim)


def _chunk(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


def _a2a(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """all_to_all_single on dim 0 in equal splits."""
    split = [x.shape[0] // ax.size] * ax.size
    return _F.wait_tensor(_F.all_to_all_single(x.contiguous(), split, split,
                                               ax.group_name))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.ax, ctx.dim).contiguous(), None, None


class _Chunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _chunk(x, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _SumFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _a2a(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.ax), None


def gather(x, ax: Axis, dim: int):
    return x if ax.size == 1 else _Gather.apply(x, ax, dim)


def chunk(x, ax: Axis, dim: int):
    return x if ax.size == 1 else _Chunk.apply(x, ax, dim)


def gather_sum(x, ax: Axis, dim: int):
    return x if ax.size == 1 else _GatherSum.apply(x, ax, dim)


def sum_grad(x, ax: Axis):
    return x if ax.size == 1 else _SumGrad.apply(x, ax)


def sum_fwd(x, ax: Axis):
    return x if ax.size == 1 else _SumFwd.apply(x, ax)


def all_to_all(x, ax: Axis):
    return x if ax.size == 1 else _AllToAll.apply(x, ax)


def all_reduce_(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """A sum over the axis outside autograd (counts, norms)."""
    return x if ax.size == 1 else _all_reduce(x, ax)


# ---------------------------------------------------------------------------
# Layouts of local tensors
# ---------------------------------------------------------------------------


def redistribute(x: torch.Tensor, dst: Sequence, src: Sequence,
                 axes: Mapping[str, Axis]) -> torch.Tensor:
    """This rank's piece of a tensor laid out by ``src`` -> its piece under
    ``dst``: DTensor's redistribute between Shard and Replicate placements,
    on the local tensor (a Replicate piece's gradient is replicated)."""
    s, d = spec_dims(src), spec_dims(dst)
    moved = [a for a in axes if s.get(a) != d.get(a)]
    for name in reversed(moved):  # gathers: minor axes first
        if s.get(name) is not None:
            x = gather(x, axes[name], s[name])
    for name in moved:  # chunks: major axes first
        if d.get(name) is not None:
            x = chunk(x, axes[name], d[name])
    return x


def use_weight(x: torch.Tensor, spec: Sequence, axes: Mapping[str, Axis],
               split: Iterable[str], keep: Iterable[str] = ()
               ) -> torch.Tensor:
    """A weight's local piece -> the tensor its use computes with: whole on
    every axis but those in ``keep`` (where the use takes its piece). Its
    gradient is summed over the axes in ``split`` — those the use's work
    is divided over — and taken as is over the others."""
    dims = spec_dims(spec)
    split, keep = set(split), set(keep)
    for name in reversed(list(axes)):  # minor axes first
        ax, d = axes[name], dims.get(name)
        if d is None:
            if name in split:
                x = sum_grad(x, ax)
        elif name in keep:
            continue
        elif name in split:
            x = gather_sum(x, ax, d)
        else:
            x = gather(x, ax, d)
    return x


def piece(n: int, entry, axes: Mapping[str, Axis]) -> Tuple[int, int]:
    """(start, length) of this rank's piece of a dim of ``n`` split by a
    spec entry."""
    index, count = 0, 1
    for name in entry_axes(entry):
        index = index * axes[name].size + axes[name].rank
        count *= axes[name].size
    return index * (n // count), n // count


# ---------------------------------------------------------------------------
# States on the mesh (DTensor)
# ---------------------------------------------------------------------------


def distribute(full, spec: Sequence, mesh,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """A whole tensor (or array) -> this rank's piece of it under ``spec``
    (`torch.distributed.tensor.distribute_tensor`; every rank passes the
    same tensor)."""
    t = torch.as_tensor(np.asarray(full) if not isinstance(
        full, torch.Tensor) else full)
    t = t.detach().to(device if device is not None else t.device)
    return distribute_tensor(t, mesh, placements(spec, mesh)).to_local() \
        .clone()


def full_tensor(local: torch.Tensor, spec: Sequence, mesh,
                shape: Sequence[int]) -> torch.Tensor:
    """This rank's piece -> the whole tensor, on every rank (a collective
    when the spec splits anything)."""
    shape = tuple(shape)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local.detach(), mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride).full_tensor()
