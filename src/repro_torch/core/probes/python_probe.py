"""Python-layer probe: the uprobe-on-PyObject_CallFunction analogue (port
of `repro/core/probes/python_probe.py`; only the imports and the default
include list differ).

Installs a `sys.setprofile` hook at attach() time (runtime attachment — the
monitored code is never modified, mirroring eBPF's dynamic uprobes). Records
call/return pairs for functions whose module matches the include filters,
with optional 1-in-N sampling to bound overhead the same way the paper bounds
eBPF map traffic.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional, Sequence, Tuple

from repro_torch.core.events import Layer
from repro_torch.core.probes.base import Probe


class PythonProbe(Probe):
    name = "python"

    def __init__(self, include: Sequence[str] = ("repro_torch", "torch"),
                 sample_every: int = 1, max_depth: int = 64):
        super().__init__()
        self.include = tuple(include)
        self.sample_every = max(1, sample_every)
        self.max_depth = max_depth
        self._stack: dict = {}  # tid -> list[(name, t_enter)]
        self._counter = 0
        self._prev_hook = None

    def _match(self, frame) -> Optional[str]:
        mod = frame.f_globals.get("__name__", "")
        for inc in self.include:
            if mod == inc or mod.startswith(inc + "."):
                return f"{mod}.{frame.f_code.co_name}"
        return None

    def _profile(self, frame, event: str, arg):
        if event == "call":
            name = self._match(frame)
            if name is None:
                return
            self._counter += 1
            if self._counter % self.sample_every:
                return
            tid = threading.get_ident()
            stack = self._stack.setdefault(tid, [])
            if len(stack) < self.max_depth:
                stack.append((name, id(frame), self.now()))
        elif event == "return":
            tid = threading.get_ident()
            stack = self._stack.get(tid)
            if stack and stack[-1][1] == id(frame):
                name, _, t_enter = stack.pop()
                t = self.now()
                self.emit_rows(Layer.PYTHON, name, t_enter, dur=t - t_enter,
                               pid=os.getpid(), tid=tid)

    def _attach(self) -> None:
        self._prev_hook = sys.getprofile()
        sys.setprofile(self._profile)

    def _detach(self) -> None:
        sys.setprofile(self._prev_hook)
        self._prev_hook = None
        self._stack.clear()
