"""Local device meshes over a `torch.distributed` process group (port of
`repro/launch/mesh.py:16-36`).

    with process_group("cpu"):                 # or "cuda"
        mesh = make_local_mesh(data=2, model=1, device="cpu")
        print(describe(mesh))                   # data=2xmodel=1

Under ``torchrun`` the group comes from its environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); otherwise it is a group
of one on an in-memory ``HashStore``. The backend is ``nccl`` on the card
and ``gloo`` when the caller asks for the CPU. Every group is made with a
finite ``timeout``: a collective that no other rank matches fails instead
of hanging. The reference's 16x16 production mesh
(``make_production_mesh``) is built for its dry run, which the port does
not have yet.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

AXES = ("data", "model")
TIMEOUT_S = 300.0


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def init_process_group(device: DeviceLike = None,
                       timeout_s: float = TIMEOUT_S) -> bool:
    """Join (or make) the default process group for ``device``'s type.
    Returns False when one was already initialised (nothing is made)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if under_torchrun():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return True


@contextlib.contextmanager
def process_group(device: DeviceLike = None,
                  timeout_s: float = TIMEOUT_S) -> Iterator[None]:
    """The default process group for the block, destroyed on every exit
    (a group made outside the block is left as it is)."""
    made = init_process_group(device, timeout_s)
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def local_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` on the card, else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the default process group (initialised
    here if it is not yet). Its size must be the world size."""
    init_process_group(device)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a data={data} x model={model} mesh needs "
                         f"{data * model} ranks; the process group has "
                         f"{world} (launch with torchrun --nproc-per-node "
                         f"{data * model})")
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=AXES)


def describe(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in
                    zip(mesh.mesh_dim_names, mesh.shape))
