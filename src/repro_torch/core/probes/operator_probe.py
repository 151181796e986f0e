"""Operator-layer probe: the Torch-operator-tracing analogue (port of
`repro/core/probes/operator_probe.py`).

The paper reverse-engineers obfuscated PyTorch C++ symbols to place uprobes
on operator entry points. The reference reads JAX's operator stream off the
jaxpr. Here the operator stream is the aten ops the step dispatches: this
probe takes any function the runtime is about to execute (observed via the
step probe, not via user instrumentation), runs it once under a
`TorchDispatchMode` on meta copies of its arguments — shapes only, no
arithmetic, the caller's tensors untouched — and records one entry per aten
op with its shapes and a FLOP estimate: `torch.utils.flop_counter`'s
formulas where torch has one (2·M·N·K for a matmul, as the reference's
``_eqn_flops`` counts ``dot_general``), the reference's rule elsewhere (8
per output element for a transcendental, 1 for any other op). Per-step
operator latencies are then attributed proportionally to the FLOP estimate —
operator-level visibility without touching the model code.

Why meta copies: the step the launcher holds may be a CUDA-graphed one,
whose replays dispatch no aten op, and running it would train (parameters
and optimizer moments are updated in place). On meta tensors the step takes
its eager path, and the record leaves the training state bit-identical, as
``jax.make_jaxpr`` does in the reference.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.core.events import Layer
from repro_torch.core.probes.base import Probe

# the reference's transcendental primitives, by aten name
_TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "erf", "rsqrt", "sqrt")


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else x,
             tree)
    return out


def _nbytes(tensors: List[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def op_flops(func, args, kwargs, out) -> float:
    """FLOPs of one aten op call: torch's formula where it has one, else the
    reference's rule (`repro/core/probes/operator_probe.py::_eqn_flops`)."""
    from torch.utils.flop_counter import flop_registry

    packet = func._overloadpacket
    formula = flop_registry.get(packet)
    if formula is not None:
        return float(formula(*args, **(kwargs or {}), out_val=out))
    out_elems = sum(t.numel() for t in _tensors(out))
    if packet.__name__.strip("_") in _TRANSCENDENTAL:  # exp_ is exp
        return 8.0 * out_elems  # transcendental cost estimate
    return float(out_elems)


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records: List[Dict[str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func._overloadpacket.__name__
        self.records.append({
            "name": name,
            "prim": name,
            "flops": op_flops(func, args, kwargs, out),
            "bytes": _nbytes(outs) + _nbytes(_tensors((args, kwargs))),
            "out_shape": tuple(outs[0].shape) if outs else (),
            "count": 1,
        })
        return out


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta").requires_grad_(
            x.requires_grad)
    return x


def extract_operator_records(fn, *args, **kwargs) -> List[Dict[str, Any]]:
    """Run fn once with every tensor of its argument tree replaced by a meta
    copy (host data such as a numpy batch is passed as it is; the step
    moves it to its parameters' device, here meta) -> per-aten-op
    records."""
    meta_args, meta_kwargs = tree_map(_to_meta, (args, kwargs))
    rec = _Recorder()
    with rec:
        fn(*meta_args, **meta_kwargs)
    return rec.records


class OperatorProbe(Probe):
    """Emits operator events: static records on register_fn(); per-step
    latency attribution on observe_step()."""

    name = "operator"

    def __init__(self, top_n: int = 24):
        super().__init__()
        self.top_n = top_n
        self._records: List[Dict[str, Any]] = []
        self._total_flops = 0.0
        # per-step emission is fully columnar: the name/size/flop-fraction
        # columns are computed ONCE at register_fn and replayed every step
        # with a single scaled dur column (no per-record Python work)
        self._row_names = np.empty(0, dtype="<U64")
        self._row_fracs = np.empty(0, dtype=np.float64)
        self._row_bytes = np.empty(0, dtype=np.float64)

    def _attach(self) -> None:
        pass  # passive: fed by the collector/step probe

    def _detach(self) -> None:
        self._records = []
        self._row_names = np.empty(0, dtype="<U64")
        self._row_fracs = np.empty(0, dtype=np.float64)
        self._row_bytes = np.empty(0, dtype=np.float64)

    def register_fn(self, fn, *args, **kwargs) -> None:
        """Extract the operator stream of a step function (never modifies it
        or its arguments)."""
        recs = extract_operator_records(fn, *args, **kwargs)
        recs.sort(key=lambda r: -r["flops"])
        self._records = recs[: self.top_n]
        self._total_flops = max(sum(r["flops"] for r in recs), 1.0)
        self._row_names = np.array([r["prim"] for r in self._records])
        self._row_fracs = np.array(
            [r["flops"] / self._total_flops for r in self._records])
        self._row_bytes = np.array([float(r["bytes"]) for r in self._records])
        if self._records:
            self.emit_rows(
                Layer.OPERATOR,
                np.array(["static/" + r["name"] for r in self._records]),
                ts=self.now(), size=self._row_bytes, pid=os.getpid(),
                meta=np.array(
                    [json.dumps({"flops": r["flops"],
                                 "shape": str(r["out_shape"])},
                                separators=(",", ":"))
                     for r in self._records], dtype=object))

    def observe_step(self, step: int, step_dur: float, ts: float) -> None:
        """Attribute a measured step duration across the operator stream —
        one block append of top_n rows, dur = step_dur * flop fraction."""
        if not self._row_names.shape[0]:
            return
        self.emit_rows(Layer.OPERATOR, self._row_names, ts=ts,
                       dur=step_dur * self._row_fracs, size=self._row_bytes,
                       step=step, pid=os.getpid())
