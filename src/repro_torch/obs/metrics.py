"""Zero-dependency metric primitives: counters, gauges, histograms with
labels, collected into one `MetricRegistry` and rendered in Prometheus
text-exposition format (port of `repro/obs/metrics.py`; pure Python, only
this docstring differs).

Design constraints (this is the monitor's *self*-telemetry — it must not
slow down the thing it observes):

* updates are plain dict/float operations with no locks on the write path —
  the GIL makes the individual stores atomic, and every reader
  (`render`) snapshots with ``list(...)`` before iterating;
* components that already keep cumulative stats (EventTable.pushed,
  NodeAgent.bytes_shipped, ...) are mirrored at *collection* time via
  ``Counter.set_total`` / ``Gauge.set`` from registered collector
  callbacks, so the hot path is untouched;
* label cardinality is capped per metric (``max_label_sets``): a runaway
  label (e.g. one series per kernel name) drops new series and counts the
  drops in ``eacgm_obs_labels_dropped_total`` instead of eating memory.

Rendering follows the Prometheus text format v0.0.4: one ``# HELP`` and
``# TYPE`` line per family, histogram families expand to ``_bucket`` /
``_sum`` / ``_count`` samples with cumulative ``le`` buckets.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default histogram buckets: detection sweeps span ~0.1 ms (no-op tick) to
# multiple seconds (cold EM refit with compilation)
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0)

LabelKey = Tuple[str, ...]


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Metric:
    """Base class: one metric family (name + help + label names)."""

    type_name = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 registry: Optional["MetricRegistry"] = None):
        if not METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not LABEL_NAME_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._registry = registry
        self._values: Dict[LabelKey, float] = {}

    # -- label handling -------------------------------------------------------
    def _key(self, labels: Dict[str, str]) -> Optional[LabelKey]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[ln]) for ln in self.label_names)
        if key not in self._values and self._registry is not None \
                and len(self._values) >= self._registry.max_label_sets:
            self._registry._labels_dropped(self.name)
            return None
        return key

    def _labels_str(self, key: LabelKey) -> str:
        if not self.label_names:
            return ""
        pairs = ",".join(f'{ln}="{_escape_label(v)}"'
                         for ln, v in zip(self.label_names, key))
        return "{" + pairs + "}"

    # -- reading --------------------------------------------------------------
    def value(self, **labels) -> float:
        """Current value of one series (0.0 if never touched)."""
        key = tuple(str(labels[ln]) for ln in self.label_names)
        return self._values.get(key, 0.0)

    def samples(self) -> List[Tuple[str, str, float]]:
        """(sample_name, labels_str, value) triples for rendering."""
        return [(self.name, self._labels_str(k), v)
                for k, v in list(self._values.items())]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.type_name}"]
        lines += [f"{n}{ls} {_fmt_value(v)}" for n, ls, v in self.samples()]
        return "\n".join(lines)


class Counter(Metric):
    """Monotone counter. ``inc`` adds; ``set_total`` mirrors an external
    cumulative stat (monotonicity enforced: the stored value never
    decreases, so a source reset cannot make the series go backwards)."""

    type_name = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r}: negative increment "
                             f"{amount}")
        key = self._key(labels)
        if key is not None:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key is not None:
            self._values[key] = max(self._values.get(key, 0.0), float(value))


class Gauge(Metric):
    """Point-in-time value; set freely."""

    type_name = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key is not None:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        if key is not None:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations <= its bound, ``+Inf`` counts all)."""

    type_name = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional["MetricRegistry"] = None):
        super().__init__(name, help, labels, registry)
        b = sorted(float(x) for x in buckets)
        if not b or b != sorted(set(b)):
            raise ValueError("histogram buckets must be distinct and sorted")
        self.buckets = tuple(b)
        # per label-set: [bucket counts..., +Inf count], sum
        self._counts: Dict[LabelKey, List[float]] = {}
        self._sums: Dict[LabelKey, float] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key is None:
            return
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0.0] * (len(self.buckets) + 1)
            self._sums.setdefault(key, 0.0)
            self._values[key] = 0.0  # series exists (for value()/cap)
        v = float(value)
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                counts[i] += 1
        counts[-1] += 1
        self._sums[key] = self._sums.get(key, 0.0) + v
        self._values[key] = counts[-1]  # observation count

    def count(self, **labels) -> float:
        key = tuple(str(labels[ln]) for ln in self.label_names)
        c = self._counts.get(key)
        return c[-1] if c else 0.0

    def samples(self) -> List[Tuple[str, str, float]]:
        out: List[Tuple[str, str, float]] = []
        for key, counts in list(self._counts.items()):
            base = self._labels_str(key)[1:-1] if self.label_names else ""
            sep = "," if base else ""
            for bound, c in zip(self.buckets, counts):
                out.append((f"{self.name}_bucket",
                            "{" + base + sep + f'le="{_fmt_value(bound)}"'
                            + "}", c))
            out.append((f"{self.name}_bucket",
                        "{" + base + sep + 'le="+Inf"' + "}", counts[-1]))
            ls = self._labels_str(key)
            out.append((f"{self.name}_sum", ls, self._sums.get(key, 0.0)))
            out.append((f"{self.name}_count", ls, counts[-1]))
        return out


class MetricRegistry:
    """Named metric families + collector callbacks; renders exposition text.

    ``add_collector(fn)`` registers a zero-arg callback run at the top of
    every ``render()`` — the mechanism by which pre-existing component stats
    (ring counters, aggregator totals, detector refit counts) are mirrored
    into metrics only when someone actually looks.
    """

    LABELS_DROPPED = "eacgm_obs_labels_dropped_total"

    def __init__(self, max_label_sets: int = 64):
        self.max_label_sets = int(max_label_sets)
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], None]] = []
        self._collect_lock = threading.Lock()
        self._dropped = Counter(
            self.LABELS_DROPPED,
            "Label sets dropped by the per-metric cardinality cap",
            labels=("metric",))
        self._metrics[self.LABELS_DROPPED] = self._dropped

    def _labels_dropped(self, metric_name: str) -> None:
        self._dropped.inc(metric=metric_name)

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str], **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}{m.label_names}")
            return m
        m = cls(name, help, labels, registry=self, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        self._collectors.append(fn)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def get(self, name: str) -> Metric:
        return self._metrics[name]

    def collect(self) -> None:
        """Run the collector callbacks (serialised: render may be called
        concurrently from the scrape thread and the session thread)."""
        with self._collect_lock:
            for fn in list(self._collectors):
                fn()

    def render(self) -> str:
        """Prometheus text-exposition format (v0.0.4), trailing newline."""
        self.collect()
        chunks = [self._metrics[name].render() for name in sorted(
            self._metrics)]
        return "\n".join(chunks) + "\n"
