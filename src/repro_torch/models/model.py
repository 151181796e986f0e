"""Model composition: init, forward, loss for every family of
`repro/models/model.py` (dense, moe with dense residual and leading dense
layers, ssm, hybrid, encoder, vlm backbone; `:94-150, 175-316`), and
decode for every family but the encoder (`:328-459`).

Parameters are one flat dict of float32 leaf tensors keyed by
`repro_torch.config.param_shapes` names. Kernels keep the reference's
``(d_in, d_out)`` layout and apply as ``x @ W``; the layer stack is a
Python loop over ``layers.{i}`` (the reference stacks layers on leading
axes and scans them: `repro_torch.config.stack_layout`). The embedding is
padded to `padded_vocab`, tied to the head unless the config has an
``lm_head``; padded logit columns are masked out of the loss. A config with
``input_mode="embeddings"`` takes (B, S, d_model) frame embeddings in
place of tokens. Weights are cast to the compute dtype where they are
used, so gradients reach the float32 masters.

Decode (`init_decode_caches`, `decode_step`) is one token a step against
per-layer caches that the step updates in place (KV rows, a sliding
window's ring, MLA's latent rows, an SSM's conv window and state), with
the reference's per-slot ``start`` masking for continuous batching.

On a mesh (``Runtime.mesh``, a `torch.distributed` DeviceMesh with axes
"data" and "model") the parameters are this rank's pieces under
`param_partition_specs`, the reference's sharding rules, and `loss_fn`
takes the global batch and computes on this rank's piece of it
(`Runtime.batch_spec`). Each use gathers the weights it needs
(`sharding.use_weight`) and keeps its piece where the work splits over
the model axis: attention's heads, an MLP's hidden units, the experts
(`moe.py`); attention whose heads do not split over it splits its query
rows instead (`attention._seq_shard_spec`). The SSD mixer's projections
concatenate z, x, B, C and dt in one kernel, whose even split over the
model axis falls across those parts: it runs whole on each rank. Every
rank ends with the global loss (see `sharding`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import (ModelConfig, hybrid_structure, padded_vocab,
                                param_shapes, stack_layout)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, apply_norm, fanin_init,
                                       normal_init)
from repro_torch.models.sharding import (Axis, P, axis_sizes, entry_axes,
                                         piece, redistribute, sum_fwd,
                                         sum_grad, use_weight)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs, the mesh and its sharding levers
    (`repro/models/model.py:33-78`; the reference's defaults). ``remat``
    re-runs each block in the backward: ``"full"`` keeps only its inputs,
    ``"dots"`` also the outputs of its matrix products without batch
    dimensions. ``global_batch`` is set by the sharded forward: the batch
    its local pieces belong to."""

    compute_dtype: torch.dtype = torch.bfloat16
    moe_capacity_factor: float = 1.25
    mesh: Any = None
    remat: str = "none"  # none | full | dots
    fsdp: bool = False
    model_axis: str = "model"
    data_axis_order: Tuple[str, ...] = ("pod", "data")
    strategy: str = "tp"  # tp (megatron-style) | dp (pure ZeRO-3)
    attn_seq_shard: bool = True  # split attention's queries when heads don't
    global_batch: int = 0

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return {} if self.mesh is None else axis_sizes(self.mesh)

    @functools.cached_property
    def axes(self) -> Dict[str, Axis]:
        """The mesh's axes, in mesh order, with their groups."""
        return {a: Axis(self.mesh, a) for a in self.mesh.mesh_dim_names}

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        if self.mesh is None:
            return ()
        order = (self.data_axis_order + (self.model_axis,)
                 if self.strategy == "dp" else self.data_axis_order)
        return tuple(a for a in order if a in self.mesh_shape)

    def batch_spec(self, batch: int):
        """Largest prefix of batch axes that divides `batch` (as one spec
        entry)."""
        if self.mesh is None:
            return None
        shape = self.mesh_shape
        axes = self.batch_axes
        n = math.prod(shape[a] for a in axes) if axes else 1
        while axes and batch % n != 0:
            axes = axes[:-1]
            n = math.prod(shape[a] for a in axes) if axes else 1
        return axes if axes else None

    def model_divides(self, n: int) -> bool:
        if self.mesh is None or self.strategy == "dp":
            return False  # dp: the model axis is folded into data parallelism
        return n % self.mesh_shape[self.model_axis] == 0

    def shard(self, x: torch.Tensor, spec, src) -> torch.Tensor:
        """The port's ``with_sharding_constraint``: ``x``, this rank's piece
        of a tensor laid out by ``src``, moved to its piece under ``spec``
        (`sharding.redistribute`). Without a mesh it does nothing."""
        if self.mesh is None:
            return x
        return redistribute(x, spec, src, self.axes)

    def activation_spec(self, batch: int, extra=(None, None)) -> P:
        return P(self.batch_spec(batch), *extra)

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a region whose work splits over the model axis: each rank's
        gradient of ``x`` is its part, summed here."""
        if self.mesh is None:
            return x
        return sum_grad(x, self.axes[self.model_axis])

    def tp_exit(self, y: torch.Tensor) -> torch.Tensor:
        """Out of such a region: the ranks' parts of ``y`` summed."""
        if self.mesh is None:
            return y
        return sum_fwd(y, self.axes[self.model_axis])

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's piece of a global batch (tensors or arrays, split on
        their first dim by `batch_spec`)."""
        if self.mesh is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        start, length = piece(n, self.batch_spec(n), self.axes)
        return {k: v[start:start + length] for k, v in batch.items()}


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` re-run in the backward (`repro/models/model.py:81-86`):
    ``"full"`` saves nothing of it but its inputs; ``"dots"`` also saves
    the outputs of matrix products without batch dimensions (``aten.mm``,
    ``aten.addmm``; not ``aten.bmm``), as
    ``dots_with_no_batch_dims_saveable`` does. No block draws random
    numbers, so no RNG state is kept (reading it inside a CUDA graph's
    capture would fail)."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    context_fn = None
    if mode == "dots":
        saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       policy)

    def wrapped(*args):
        kw = {"context_fn": context_fn} if context_fn is not None else {}
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return wrapped


def check_decode_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration without a decode step: an encoder (nor
    has the reference one)."""
    if not cfg.has_decode:
        raise NotImplementedError(f"{cfg.name} is an encoder: it has no "
                                  "decode step (nor has the reference)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                generator_device: DeviceLike = "cpu") -> Params:
    """Random float32 parameters from a generator seeded with ``seed``,
    drawn on ``generator_device`` (the CPU unless asked: the same weights on
    every device; the reference's distributions, but `jax.random` bits
    cannot be reproduced, so parity tests load the reference's weights
    instead)."""
    dev = resolve_device(device)
    gdev = torch.device(generator_device)
    gen = torch.Generator(device=gdev).manual_seed(seed)
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        t = (ssm_mod.init_ssm_leaf(gen, name.split(".mixer.", 1)[1], shape)
             if ".mixer." in name else None)
        if t is None and name.endswith(".scale"):
            t = torch.ones(shape, device=gdev)
        elif t is None and name.endswith(".bias"):
            t = torch.zeros(shape, device=gdev)
        elif t is None:
            t = (normal_init if name == "embed.table" else fanin_init)(
                gen, shape)
        params[name] = t.to(dev).requires_grad_()
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _tf_block(params: Params, prefix: str, cfg: ModelConfig, rt: Runtime,
              x: torch.Tensor, is_moe: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    x = x + attn.attention_forward(params, f"{prefix}.attn", cfg, h, rt=rt)
    h = apply_norm(params, f"{prefix}.norm2", cfg, x)
    if not is_moe:
        return x + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h,
                                       rt=rt), None
    # the reference pins the MoE input to (batch, seq -> model) and the
    # dense residual's to the activation layout only to steer GSPMD
    # (`repro/models/model.py:100-127`); here the dispatch splits its
    # tokens itself (`moe.moe_dispatch_compute`) and h keeps its layout
    y, aux = moe_mod.moe_forward(params, f"{prefix}.moe", cfg, rt, h)
    if cfg.dense_residual:
        y = y + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h, rt=rt)
    return x + y, aux


def _mamba_block(params: Params, prefix: str, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    return x + ssm_mod.ssd_forward(params, f"{prefix}.mixer", cfg, h)


def _shared_attn_block(params: Params, cfg: ModelConfig, rt: Runtime,
                       x: torch.Tensor) -> torch.Tensor:
    """Zamba2's shared attention + MLP block (weight-tied across
    invocations)."""
    h = apply_norm(params, "shared.norm1", cfg, x)
    x = x + attn.attention_forward(params, "shared.attn", cfg, h, rt=rt)
    h = apply_norm(params, "shared.norm2", cfg, x)
    return x + ffn_mod.ffn_forward(params, "shared.ffn", cfg, h, rt=rt)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(params: Params, cfg: ModelConfig, rt: Runtime,
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.input_mode != "tokens":
        return batch["embeddings"].to(rt.compute_dtype)
    # F.embedding, not indexing: at up to 3072 tokens its CUDA backward is a
    # single kernel with no host sync, so the step can be captured in a graph
    return F.embedding(batch["tokens"].long(),
                       params["embed.table"].to(rt.compute_dtype))


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params, "final_norm", cfg, x)
    if cfg.tie_embeddings:
        return x @ params["embed.table"].to(x.dtype).T
    return x @ params["lm_head.kernel"].to(x.dtype)


def _forward(params: Params, cfg: ModelConfig, rt: Runtime,
             batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """`forward` on this rank's piece of the batch (all of it without a
    mesh), the weights as its uses need them."""
    x = _embed(params, cfg, rt, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        mamba = _remat(lambda lp, pre, h: _mamba_block(lp, pre, cfg, h),
                       rt.remat)
        if cfg.attn_every:
            shared = _remat(lambda lp, h: _shared_attn_block(lp, cfg, rt, h),
                            rt.remat)
            n_groups, g, n_tail = hybrid_structure(cfg)
            for gi in range(n_groups):
                for j in range(g):
                    x = mamba(params, f"layers.{gi * g + j}", x)
                x = shared(params, x)
            for t in range(n_tail):
                x = mamba(params, f"layers.{n_groups * g + t}", x)
        else:
            for i in range(cfg.n_layers):
                x = mamba(params, f"layers.{i}", x)
    else:
        fd = cfg.first_dense_layers if cfg.n_experts else 0
        dense = _remat(lambda lp, pre, h: _tf_block(lp, pre, cfg, rt, h),
                       rt.remat)
        moe = _remat(lambda lp, pre, h: _tf_block(lp, pre, cfg, rt, h,
                                                  is_moe=True), rt.remat)
        for i in range(cfg.n_layers):
            x, a = (moe if cfg.n_experts and i >= fd else dense)(
                params, f"layers.{i}", x)
            if a is not None:
                aux = aux + a
    return _head(params, cfg, x), aux


def forward(params: Params, cfg: ModelConfig, rt: Runtime,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V_padded), aux_loss): the
    MoE layers' summed load-balance loss (zero without experts). On a mesh
    ``batch`` is the global batch and the logits are this rank's piece."""
    if rt.mesh is None:
        return _forward(params, cfg, rt, batch)
    return _forward(*_on_mesh(params, cfg, rt, batch))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

# {"layers": [...], ...}: one cache dict per layer in a list per group of
# layers (the reference stacks them on leading axes)
Caches = Dict[str, List[Dict[str, torch.Tensor]]]


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = None) -> Caches:
    """The model's decode caches (`repro/models/model.py:328-357`), KV
    caches in ``dtype``, SSM caches in float32. Dense and MoE: ``layers``
    (the layers after the leading dense ones) and ``head_layers`` (those);
    SSM: ``layers``; hybrid: ``layers`` (every grouped mixer, layer by
    layer), ``tail`` (the mixers after the last group) and ``shared`` (the
    shared attention's KV cache, one per group)."""
    check_decode_supported(cfg)
    dev = resolve_device(device)

    def kv(n):
        return [attn.init_kv_cache(cfg, batch, max_len, dtype, dev)
                for _ in range(n)]

    def ssm(n):
        return [ssm_mod.init_ssm_cache(cfg, batch, device=dev)
                for _ in range(n)]

    if cfg.family in ("ssm", "hybrid"):
        if not cfg.attn_every:
            return {"layers": ssm(cfg.n_layers)}
        n_groups, g, n_tail = hybrid_structure(cfg)
        caches = {"layers": ssm(n_groups * g), "shared": kv(n_groups)}
        if n_tail:
            caches["tail"] = ssm(n_tail)
        return caches
    fd = cfg.first_dense_layers if cfg.n_experts else 0
    caches = {"layers": kv(cfg.n_layers - fd)}
    if fd:
        caches["head_layers"] = kv(fd)
    return caches


def _tf_block_decode(params: Params, prefix: str, cfg: ModelConfig,
                     rt: Runtime, x: torch.Tensor, cache: attn.Cache,
                     index: Union[int, torch.Tensor],
                     start: Optional[torch.Tensor] = None,
                     is_moe: bool = False) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    x = x + attn.attention_decode(params, f"{prefix}.attn", cfg, h, cache,
                                  index, start=start)
    h = apply_norm(params, f"{prefix}.norm2", cfg, x)
    if not is_moe:
        return x + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)
    y, _ = moe_mod.moe_forward(params, f"{prefix}.moe", cfg, rt, h)
    if cfg.dense_residual:
        y = y + ffn_mod.ffn_forward(params, f"{prefix}.ffn", cfg, h)
    return x + y


def _mamba_block_decode(params: Params, prefix: str, cfg: ModelConfig,
                        x: torch.Tensor, cache: ssm_mod.SSMCache
                        ) -> torch.Tensor:
    h = apply_norm(params, f"{prefix}.norm1", cfg, x)
    return x + ssm_mod.ssd_decode(params, f"{prefix}.mixer", cfg, h, cache)


def decode_step(params: Params, cfg: ModelConfig, rt: Runtime,
                batch: Dict[str, torch.Tensor], caches: Caches,
                index: Union[int, torch.Tensor],
                start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One token step (`repro/models/model.py:383-459`). batch:
    {"tokens": (B, 1)} or {"embeddings": (B, 1, d_model)}. Returns (logits
    (B, 1, V_padded), caches), the caches updated in place.

    ``start``: optional (B,) — each sequence's first valid absolute
    position. Continuous-batching serving passes it so a request that
    joined the running batch mid-flight never attends to cache rows written
    by the slot's previous occupant (see `attention.gqa_decode`)."""
    x = _embed(params, cfg, rt, batch)
    if cfg.family in ("ssm", "hybrid"):
        layers = caches["layers"]
        if cfg.attn_every:
            n_groups, g, n_tail = hybrid_structure(cfg)
            for gi in range(n_groups):
                for j in range(g):
                    i = gi * g + j
                    x = _mamba_block_decode(params, f"layers.{i}", cfg, x,
                                            layers[i])
                h = apply_norm(params, "shared.norm1", cfg, x)
                x = x + attn.attention_decode(
                    params, "shared.attn", cfg, h, caches["shared"][gi],
                    index, start=start)
                h = apply_norm(params, "shared.norm2", cfg, x)
                x = x + ffn_mod.ffn_forward(params, "shared.ffn", cfg, h)
            for t in range(n_tail):
                x = _mamba_block_decode(params, f"layers.{n_groups * g + t}",
                                        cfg, x, caches["tail"][t])
        else:
            for i in range(cfg.n_layers):
                x = _mamba_block_decode(params, f"layers.{i}", cfg, x,
                                        layers[i])
    else:
        fd = cfg.first_dense_layers if cfg.n_experts else 0
        for i in range(cfg.n_layers):
            cache = (caches["head_layers"][i] if i < fd
                     else caches["layers"][i - fd])
            x = _tf_block_decode(params, f"layers.{i}", cfg, rt, x, cache,
                                 index, start=start,
                                 is_moe=bool(cfg.n_experts) and i >= fd)
    return _head(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(params: Params, cfg: ModelConfig, rt: Runtime,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy; ignores labels < 0. On a mesh
    ``batch`` is the global batch, each rank computes on its piece, and
    every rank returns the global loss."""
    if rt.mesh is not None:
        params, cfg, rt, batch = _on_mesh(params, cfg, rt, batch)
    logits, aux = _forward(params, cfg, rt, batch)
    labels = batch["labels"].long()
    pv = padded_vocab(cfg)
    logits = logits.to(torch.float32)
    if pv != cfg.vocab_size:  # mask padded vocab columns out of the lse
        col = torch.arange(pv, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (lse - ll) * mask
    nll_sum, tokens = torch.sum(nll), torch.sum(mask)
    if rt.mesh is not None:  # over the pieces of the batch
        for a in entry_axes(rt.batch_spec(rt.global_batch)):
            nll_sum = sum_fwd(nll_sum, rt.axes[a])
            tokens = sum_fwd(tokens.detach(), rt.axes[a])
    loss = nll_sum / torch.clamp(tokens, min=1.0)
    total = loss + cfg.router_aux_coef * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": tokens}


def _on_mesh(params: Params, cfg: ModelConfig, rt: Runtime,
             batch: Dict[str, torch.Tensor]):
    """(params, cfg, rt, batch) as the local forward takes them on a mesh:
    this rank's piece of the global batch, the runtime knowing that batch,
    each weight as its use needs it (`mesh_params`)."""
    first = next(iter(batch.values()))
    B, S = first.shape[0], first.shape[1]
    rt = dataclasses.replace(rt, global_batch=B)
    return mesh_params(params, cfg, rt, B, S), cfg, rt, rt.local_batch(batch)


def mesh_params(params: Params, cfg: ModelConfig, rt: Runtime, B: int,
                S: int) -> Params:
    """Each local weight piece -> what its use computes with
    (`sharding.use_weight`) for a global batch of B sequences of S: the
    piece itself where the use splits over the model axis (attention
    heads, MLP hidden units, experts), else the whole weight. Gradients
    sum over the axes the use's work divides over: the batch's, and the
    model axis inside attention and MLP regions that split over it."""
    specs = param_partition_specs(cfg, rt, param_shapes(cfg))
    M = rt.model_axis
    split = set(entry_axes(rt.batch_spec(B)))
    mode = attn.attention_mode(cfg, rt, B, S)
    if cfg.n_experts:
        kind, tok = moe_mod.dispatch_plan(cfg, rt, B * S)
    out: Params = {}
    for name, p in params.items():
        keep, use = (), split
        if ".attn." in name:
            if mode == "heads":
                keep, use = (M,), split | {M}
            elif mode == "seq" and name.endswith((".k.kernel", ".v.kernel")):
                use = split | {M}  # keys and values serve every query row
        elif ".moe.experts." in name:
            keep = (M,) if kind in ("a2a", "replicated") else ()
            use = set(entry_axes(tok)) | set(keep)
        elif ".ffn." in name or ".moe.shared." in name:
            prefix = name[:name.rindex(".", 0, name.rindex("."))]
            if rt.model_divides(ffn_mod.ffn_width(cfg, prefix)):
                keep, use = (M,), split | {M}
        out[name] = use_weight(p, specs[name], rt.axes, use, keep)
    return out


# ---------------------------------------------------------------------------
# Partition specs (the reference's GSPMD sharding rules)
# ---------------------------------------------------------------------------


def _stacked(cfg: ModelConfig, shapes: Dict[str, Tuple[int, ...]]):
    """name -> (the reference leaf's path names, its stacked shape, the
    number of stacking dims)."""
    out = {}
    for name, (leaf, _, stacked) in stack_layout(cfg).items():
        names = [c for c in leaf.split(".") if not c.isdigit()]
        out[name] = (names, tuple(stacked) + tuple(shapes[name]),
                     len(stacked))
    return out


def param_partition_specs(cfg: ModelConfig, rt: Runtime,
                          shapes: Dict[str, Tuple[int, ...]]
                          ) -> Dict[str, P]:
    """name -> the spec of that parameter (`repro/models/model.py:462-556`,
    the reference's rules on its stacked leaves, less their stacking
    dims: the port keeps each layer's tensor apart). ``shapes``: the
    global shapes (`param_shapes`)."""
    if rt.mesh is None:
        return {k: P() for k in shapes}
    sizes = rt.mesh_shape
    stacked = _stacked(cfg, shapes)

    def unstack(name, spec):
        n = stacked[name][2]
        if any(e is not None for e in spec[:n]):
            raise NotImplementedError(
                f"{name}: the rule splits a stacking dim ({spec!r}); the "
                "port keeps layers apart")
        return P(*spec[n:])

    if rt.strategy == "dp":
        # pure ZeRO-3: every tensor fully sharded over (data x model) on its
        # largest divisible dim; gathered just-in-time per use.
        combo = tuple(a for a in ("data", rt.model_axis) if a in sizes)
        csize = math.prod(sizes[a] for a in combo)

        def dp_rule(shape):
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[i] % csize == 0:
                    entries: list = [None] * len(shape)
                    entries[i] = combo
                    return P(*entries)
            return P(*([None] * len(shape)))

        return {k: unstack(k, dp_rule(stacked[k][1])) for k in shapes}
    M = rt.model_axis
    msize = sizes[M]
    fsdp_axis = "data" if (rt.fsdp and "data" in sizes) else None

    def div(n):
        return n % msize == 0

    heads_ok = cfg.n_heads and div(cfg.n_heads)
    pv = padded_vocab(cfg)

    def rule(names: List[str], shape: Tuple[int, ...]) -> P:
        name = ".".join(names)
        rank = len(shape)

        def spec(*entries):
            # pad leading stacking dims (layers/groups) with None
            return P(*((None,) * (rank - len(entries)) + entries))

        def fs(axis_len):
            """fsdp axis if divisible, else None."""
            if fsdp_axis and axis_len % sizes[fsdp_axis] == 0:
                return fsdp_axis
            return None

        if "embed" in names:
            return spec(M if div(pv) else None, fs(cfg.d_model))
        if "lm_head" in names:
            return spec(fs(cfg.d_model), M if div(pv) else None)
        if "router" in names:
            return spec(None, M if div(cfg.n_experts) else None)
        if "experts" in names:
            e_spec = M if div(cfg.n_experts) else None
            if name.endswith("down"):  # (E, f, d)
                return spec(e_spec, fs(shape[-2]), None)
            return spec(e_spec, fs(shape[-2]), None)  # (E, d, f)
        if "attn" in names:
            if cfg.attn_kind == "mla":
                if "q_up" in names or "kv_up" in names:
                    return spec(None, M if heads_ok else None)
                if "out" in names:
                    return spec(M if heads_ok else None, None)
                return spec(*([None] * min(rank, 2)))
            if any(k in names for k in ("q", "k", "v")) and "kernel" in names:
                proj_heads = cfg.n_heads if "q" in names else cfg.n_kv_heads
                return spec(fs(cfg.d_model),
                            M if div(proj_heads) else None)
            if "out" in names:
                return spec(M if heads_ok else None, fs(cfg.d_model))
        if "mixer" in names:
            if "in_proj" in names:
                return spec(fs(cfg.d_model), M if div(shape[-1]) else None)
            if "conv" in names:
                return spec(None, M if div(shape[-1]) else None)
            if "out_proj" in names:
                return spec(M if div(shape[-2]) else None, fs(cfg.d_model))
            if names[-1] in ("A_log", "D", "dt_bias"):
                return spec(M if div(shape[-1]) else None)
            if "norm" in names:
                return spec(M if div(shape[-1]) else None)
        if "ffn" in names or "shared" in names:
            if "down" in names:
                return spec(M if div(shape[-2]) else None, fs(shape[-1]))
            if names[-1] == "kernel":  # up / gate
                return spec(fs(shape[-2]), M if div(shape[-1]) else None)
        # norms and anything small: replicated
        return spec(*([None] * min(rank, 1)))

    return {k: unstack(k, rule(stacked[k][0], stacked[k][1]))
            for k in shapes}


def cache_partition_specs(cfg: ModelConfig, rt: Runtime, caches: Caches,
                          batch: int) -> Dict[str, List[Dict[str, P]]]:
    """The decode caches' specs, in their structure
    (`repro/models/model.py:558-592`; a per-layer cache's spec is its
    stacked leaf's, less the stacking dims)."""
    if rt.mesh is None:
        return {g: [{k: P() for k in c} for c in cs]
                for g, cs in caches.items()}
    M = rt.model_axis
    bspec = rt.batch_spec(batch)
    kv_ok = cfg.n_kv_heads and rt.model_divides(cfg.n_kv_heads)
    nh_ok = cfg.ssm_state and rt.model_divides(cfg.ssm_nheads)

    def rule(names: List[str], shape: Tuple[int, ...]) -> P:
        rank = len(shape)

        def spec(*entries):
            return P(*((None,) * (rank - len(entries)) + entries))

        if "state" in names:  # (B, nh, hd, st)
            return spec(bspec, M if nh_ok else None, None, None)
        if "conv" in names:  # (B, K-1, conv_dim)
            cd = shape[-1]
            return spec(bspec, None, M if rt.model_divides(cd) else None)
        if "c_kv" in names or "k_rope" in names:  # (B, S, r) — shard S
            return spec(bspec, M if rt.model_divides(shape[-2]) else None,
                        None)
        if "pos" in names:  # (slots,)
            return spec(None)
        if names and names[-1] in ("k", "v"):  # (B, S, KV, hd)
            if kv_ok:
                return spec(bspec, None, M, None)
            return spec(bspec, M if rt.model_divides(shape[-3]) else None,
                        None, None)
        return spec(*([None] * rank))

    return {g: [{k: rule([g, k], tuple(t.shape)) for k, t in c.items()}
                for c in cs] for g, cs in caches.items()}


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device``: token ids and labels as
    int64, frame embeddings as float32."""
    return {k: (torch.as_tensor(v, device=device).float()
                if np.issubdtype(np.asarray(v).dtype, np.floating)
                else torch.as_tensor(v, device=device).long())
            for k, v in batch.items()}
