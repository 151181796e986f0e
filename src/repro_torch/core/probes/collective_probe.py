"""Collective-layer probe: the NCCL-event analogue.

Message sizes come from the compiled HLO's collective ops (exact, like uprobe
arguments on ncclAllReduce) or, for a sharded torch step, from the
collectives the step itself issues (`register_schedule`, read off the
operator probe's record); per-step latencies come from the step-time
decomposition plus the ICI bandwidth model. Fault injection (chaos) perturbs
the observed latencies the way chaosblade perturbs the NIC in the paper.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.events import Layer
from repro_torch.core.probes.base import Probe

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# e.g. "  %ag = bf16[16,1024,128]{2,1,0} all-gather(%x), ..." (HLO text)
_HLO_RE = re.compile(
    r"(?P<dtype>[a-z0-9]+)\[(?P<dims>[0-9,]*)\][^ ]*\s+"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")


def parse_hlo_collectives(hlo_text: str) -> List[Dict[str, Any]]:
    """Extract collective ops with output byte sizes from HLO text."""
    out: List[Dict[str, Any]] = []
    for line in hlo_text.splitlines():
        m = _HLO_RE.search(line)
        if not m:
            continue
        if "-done(" in line:  # async pair: count the start only
            continue
        dims = [int(x) for x in m.group("dims").split(",") if x]
        elems = 1
        for d in dims:
            elems *= d
        nbytes = elems * _DTYPE_BYTES.get(m.group("dtype"), 4)
        out.append({"op": m.group("op"), "bytes": nbytes, "shape": dims})
    return out


def collective_bytes_by_op(hlo_text: str) -> Dict[str, float]:
    agg: Dict[str, float] = {}
    for rec in parse_hlo_collectives(hlo_text):
        agg[rec["op"]] = agg.get(rec["op"], 0.0) + rec["bytes"]
    return agg


class CollectiveProbe(Probe):
    name = "collective"

    def __init__(self, link_bw: float = 50e9, latency_us: float = 10.0,
                 seed: Optional[int] = None):
        super().__init__()
        self.link_bw = link_bw
        self.latency_us = latency_us
        self._schedule: List[Dict[str, Any]] = []
        # columnar replay state, computed once at register_compiled: per-step
        # emission scales the base-latency column (no per-op Python loop)
        self._ops = np.empty(0, dtype="<U64")
        self._bytes = np.empty(0, dtype=np.float64)
        self._base_lat = np.empty(0, dtype=np.float64)
        # seed=None (the default) draws fresh OS entropy per probe instance:
        # a fixed default would make every node's jitter/retransmit sequence
        # byte-identical, collapsing cross-node variance in fleet runs
        self._rng = np.random.default_rng(seed)
        self.comm_scale = 1.0  # chaos hook: >1 under injected network faults
        self.drop_prob = 0.0   # chaos hook: packet-loss -> retransmit inflation

    def _attach(self) -> None:
        pass

    def _detach(self) -> None:
        self._schedule = []
        self._ops = np.empty(0, dtype="<U64")
        self._bytes = np.empty(0, dtype=np.float64)
        self._base_lat = np.empty(0, dtype=np.float64)

    def register_compiled(self, hlo_text: str) -> None:
        """Read the collective schedule off a compiled artifact (non-intrusive)."""
        self.register_schedule(parse_hlo_collectives(hlo_text))

    def register_schedule(self, schedule: List[Dict[str, Any]]) -> None:
        """Replay ``schedule`` (records of ``op``, ``bytes``, ``shape``, as
        `parse_hlo_collectives` gives them) every step."""
        import json

        self._schedule = list(schedule)
        self._ops = np.array([rec["op"] for rec in self._schedule],
                             dtype="<U64")
        self._bytes = np.array([float(rec["bytes"])
                                for rec in self._schedule], dtype=np.float64)
        self._base_lat = self._bytes / self.link_bw + self.latency_us * 1e-6
        head = self._schedule[:64]
        if head:
            self.emit_rows(
                Layer.COLLECTIVE,
                np.array(["static/" + rec["op"] for rec in head]),
                ts=self.now(), size=self._bytes[:len(head)], pid=os.getpid(),
                meta=np.array([json.dumps({"shape": str(rec["shape"])},
                                          separators=(",", ":"))
                               for rec in head], dtype=object))

    def observe_step(self, step: int, ts: float, rng=None) -> float:
        """Emit per-collective latency rows for one step; returns total comm
        seconds (bandwidth model x chaos perturbation). One block append.

        ``rng`` accepts a numpy Generator (vectorised) or, for back-compat,
        any random-module-style object with an argless ``random()``."""
        n = self._base_lat.shape[0]
        if not n:
            return 0.0
        gen = self._rng if rng is None else rng
        lat = self._base_lat * self.comm_scale
        if not isinstance(gen, np.random.Generator):
            # legacy rng objects (random module / random.Random): keep the
            # original sequential draw order exactly
            retries = np.zeros(n)
            jitter = np.empty(n)
            for i in range(n):
                if self.drop_prob > 0:
                    while gen.random() < self.drop_prob and retries[i] < 5:
                        retries[i] += 1
                jitter[i] = gen.random()
            lat = lat * (1.0 + retries) * (1.0 + 0.05 * jitter)
        else:
            if self.drop_prob > 0:  # retransmits under loss: count
                # consecutive drops (up to 5) like the sequential retry loop
                drops = gen.random((n, 5)) < self.drop_prob
                retries = np.cumprod(drops, axis=1).sum(axis=1)
                lat = lat * (1.0 + retries)
            lat = lat * (1.0 + 0.05 * gen.random(n))  # jitter
        self.emit_rows(Layer.COLLECTIVE, self._ops, ts=ts, dur=lat,
                       size=self._bytes, step=step, pid=os.getpid())
        return float(lat.sum())
