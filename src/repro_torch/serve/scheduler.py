"""Admission scheduling for the continuous-batching engine (port of
`repro/serve/scheduler.py`; only the imports differ).

FCFS by design: admission order is exactly queue order, so the whole serve
plane is deterministic under a fixed arrival seed (the basis of the
scheduler-determinism test). The only policy knob is the capacity guard — a
request is admitted into a free slot only when its prompt plus its full
generation budget fit in the remaining cache positions, so a running request
can never be evicted by cache exhaustion mid-generation.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.request import Request, RequestQueue


class AdmissionScheduler:
    """Deterministic FCFS admission against a shared position budget.

    All slots share the engine's absolute decode ``index``: a request admitted
    at index ``i`` occupies positions ``i .. i + prompt_len + max_new - 2``.
    ``fits`` is the capacity guard; ``epoch_reset`` decides when the engine
    may rewind ``index`` to 0 (only when no request is in flight — stale
    cache rows left behind are excluded by each slot's ``start`` mask and the
    ``pos <= index`` validity mask).
    """

    def __init__(self, max_len: int):
        self.max_len = int(max_len)
        self.admitted = 0
        self.epoch_resets = 0

    def fits(self, req: Request, index: int) -> bool:
        return index + req.prompt_len + req.max_new_tokens <= self.max_len

    def epoch_reset(self, head: Optional[Request], index: int,
                    n_active: int) -> bool:
        """True when the engine should rewind its decode index to 0."""
        if head is None or n_active > 0 or index == 0:
            return False
        return not self.fits(head, index) and self.fits(head, 0)

    def select(self, queue: RequestQueue, index: int, free_slots: int) -> list:
        """Pop up to ``free_slots`` admissible requests, FCFS, stopping at the
        first one that does not fit (no reordering: later requests must not
        jump a blocked head)."""
        out = []
        while len(out) < free_slots:
            head = queue.peek()
            if head is None or not self.fits(head, index):
                break
            out.append(queue.pop())
            self.admitted += 1
        return out
