"""Golden anomaly-detection fixtures: tiny deterministic labelled windows
(port of `repro/eval/fixtures.py`: the same NumPy generator, so the same
seed gives bit-identical events in both packages).

One case per (non-serve) fault kind: a clean training prefix plus a scoring
window whose tail is a fault burst, generated from a seeded RNG so the same
seed always yields byte-identical events. The generator
(`tools/make_detector_fixtures.py`) runs every registered *batch* detector
family over these cases and commits the resulting per-row flag masks to
``tests/golden/detector_fixtures.json``; the conformance suite regenerates
the masks in-process and diffs them against the committed golden file, so a
behaviour change in any family is a visible diff, not a silent drift.

The bursts are sized like the chaos injector's (docs/evaluation.md): well
clear of clean jitter in the layer's own feature space, so every family is
expected to catch most of the burst while staying quiet on the clean case.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.events import Event, Layer
from repro_torch.device import DeviceLike

# fixture axis: fault kind -> the layer whose window carries the burst
FIXTURE_KINDS: Dict[str, Layer] = {
    "op_latency": Layer.OPERATOR,
    "net_latency": Layer.COLLECTIVE,
    "hw_contention": Layer.DEVICE,
    "mem_leak": Layer.DEVICE,
}
TRAIN_ROWS = 240
WINDOW_ROWS = 120
BURST_ROWS = 24  # the window's tail rows carry the fault

_OPS = (("matmul", 800e-6, 1 << 22), ("layernorm", 120e-6, 1 << 18),
        ("softmax", 200e-6, 1 << 19))


def _op_events(rng: np.random.Generator, n: int, step0: int,
               slow: np.ndarray) -> List[Event]:
    """Operator-layer rows: per-name lognormal durations around fixed
    medians; ``slow`` multiplies the affected rows' durations."""
    out: List[Event] = []
    ts = 0.0
    for i in range(n):
        name, base, size = _OPS[i % len(_OPS)]
        dur = base * float(np.exp(rng.normal(0.0, 0.08))) * float(slow[i])
        ts += 1e-3
        out.append(Event(Layer.OPERATOR, name, ts=ts, dur=dur,
                         size=float(size), step=step0 + i // len(_OPS)))
    return out


def _coll_events(rng: np.random.Generator, n: int, step0: int,
                 slow: np.ndarray) -> List[Event]:
    """Collective rows: one all-reduce per step; a slowdown stretches dur,
    which also collapses the log-bandwidth feature."""
    out: List[Event] = []
    ts = 0.0
    for i in range(n):
        dur = 500e-6 * float(np.exp(rng.normal(0.0, 0.08))) * float(slow[i])
        ts += 1e-3
        out.append(Event(Layer.COLLECTIVE, "all_reduce", ts=ts, dur=dur,
                         size=float(4 << 20), step=step0 + i))
    return out


def _device_events(rng: np.random.Generator, n: int, step0: int,
                   util: np.ndarray, mem: np.ndarray, power: np.ndarray,
                   temp: np.ndarray) -> List[Event]:
    out: List[Event] = []
    for i in range(n):
        out.append(Event(
            Layer.DEVICE, "device0", ts=1e-3 * (i + 1), step=step0 + i,
            meta={"util": float(util[i]), "mem_gb": float(mem[i]),
                  "power_w": float(power[i]), "temp_c": float(temp[i])}))
    return out


def _device_clean(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, ...]:
    return (np.clip(rng.normal(60.0, 3.0, n), 0, 100),
            rng.normal(4.0, 0.1, n),
            rng.normal(150.0, 5.0, n),
            rng.normal(55.0, 1.5, n))


def fixture_case(kind: str, seed: int = 0
                 ) -> Tuple[List[Event], List[Event], np.ndarray, Layer]:
    """One labelled case: (train_events, window_events, truth_mask, layer).

    ``kind`` is a `FIXTURE_KINDS` key or ``"clean"`` (operator-layer window
    with no burst; truth all-False). The truth mask marks the window rows
    perturbed by the burst."""
    layer = FIXTURE_KINDS.get(kind, Layer.OPERATOR)
    # zlib.crc32, not hash(): per-kind streams must not depend on
    # PYTHONHASHSEED or the golden file regenerates differently per process
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(kind.encode())]))
    truth = np.zeros(WINDOW_ROWS, dtype=bool)
    if kind != "clean":
        truth[-BURST_ROWS:] = True
    ones_train = np.ones(TRAIN_ROWS)
    if layer == Layer.DEVICE:
        train = _device_events(rng, TRAIN_ROWS, 0,
                               *_device_clean(rng, TRAIN_ROWS))
        util, mem, power, temp = _device_clean(rng, WINDOW_ROWS)
        if kind == "hw_contention":
            util[truth] = np.clip(rng.normal(98.0, 1.0, BURST_ROWS), 0, 100)
            power[truth] = rng.normal(280.0, 5.0, BURST_ROWS)
            temp[truth] = rng.normal(85.0, 1.5, BURST_ROWS)
        else:  # mem_leak: monotone climb well above the clean band
            mem[truth] = 6.0 + 0.5 * np.arange(BURST_ROWS)
        window = _device_events(rng, WINDOW_ROWS, TRAIN_ROWS,
                                util, mem, power, temp)
    elif layer == Layer.COLLECTIVE:
        slow = np.where(truth, 6.0, 1.0)
        train = _coll_events(rng, TRAIN_ROWS, 0, ones_train)
        window = _coll_events(rng, WINDOW_ROWS, TRAIN_ROWS, slow)
    else:
        slow = np.where(truth, 8.0, 1.0)
        train = _op_events(rng, TRAIN_ROWS, 0, ones_train)
        window = _op_events(rng, WINDOW_ROWS, TRAIN_ROWS, slow)
    return train, window, truth, layer


def fixture_suite(seed: int = 0) -> Dict[str, tuple]:
    """All cases: every fault kind plus the clean control."""
    return {kind: fixture_case(kind, seed=seed)
            for kind in ("clean", *FIXTURE_KINDS)}


def compute_golden(seed: int = 0, contamination: float = 0.05,
                   device: DeviceLike = None) -> Dict[str, object]:
    """Run every registered batch detector family over the fixture suite;
    returns the JSON-ready golden document (per-case truth + per-family
    flag masks). The GMM family fits on ``device`` (``cuda`` unless the CPU
    is asked for)."""
    from repro_torch.session import DetectorSpec
    from repro_torch.session.registry import (detector_backend,
                                              detector_names)

    doc: Dict[str, object] = {
        "seed": seed,
        "contamination": contamination,
        "train_rows": TRAIN_ROWS,
        "window_rows": WINDOW_ROWS,
        "burst_rows": BURST_ROWS,
        "cases": {},
    }
    for kind, (train, window, truth, layer) in fixture_suite(seed).items():
        masks: Dict[str, List[int]] = {}
        for name in detector_names():
            try:
                cls = detector_backend(name, "batch")
            except KeyError:
                continue
            det = cls(DetectorSpec(backend=name, contamination=contamination,
                                   min_events=32, seed=seed), device=device)
            det.fit(train)
            res = det.update(window)
            if layer not in res:
                raise RuntimeError(
                    f"family {name!r} produced no {layer.value} detection "
                    f"for fixture {kind!r}")
            masks[name] = [int(f) for f in np.asarray(res[layer].flags)]
        doc["cases"][kind] = {
            "layer": layer.value,
            "truth": [int(t) for t in truth],
            "flags": masks,
        }
    return doc
