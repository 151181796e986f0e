"""Strict pure-Python parser for the Prometheus text-exposition format
(port of `repro/obs/parser.py`; only the imports differ).

Used three ways: the test suite validates everything the `prometheus` sink
renders, CI lints the live ``/metrics`` scrape from the fleet demo, and
operators can sanity-check an exported file with

    PYTHONPATH=src python -m repro_torch.obs.parser results/fleet_metrics.prom

"Strict" means structural validity, not just tokenisation:

* metric and label names must match the Prometheus grammar;
* samples must follow a ``# TYPE`` declaration of their family, and a
  family's samples must be contiguous (no interleaving);
* a (name, labels) series may appear at most once;
* values must parse as floats (``+Inf``/``-Inf``/``NaN`` accepted);
* histogram families must carry cumulative, non-decreasing ``le`` buckets
  ending at ``+Inf``, and ``_count`` must equal the ``+Inf`` bucket;
* counter values must be finite and non-negative.

Violations raise `ExpositionError` with the offending line number.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import LABEL_NAME_RE, METRIC_NAME_RE

VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)"
    r"(?:\s+(?P<ts>-?\d+))?\s*$")
_LABEL_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"(?P<value>(?:[^"\\]|\\.)*)"'
    r"\s*(?P<sep>,|$)")


class ExpositionError(ValueError):
    def __init__(self, lineno: int, message: str):
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


@dataclasses.dataclass
class Sample:
    name: str  # full sample name (incl. _bucket/_sum/_count suffixes)
    labels: Dict[str, str]
    value: float
    family: str  # the declared family this sample belongs to
    type: str


@dataclasses.dataclass
class Exposition:
    """Parsed scrape: families (name -> type) and the flat sample list."""

    families: Dict[str, str]
    samples: List[Sample]

    def family_names(self) -> List[str]:
        return sorted(self.families)

    def sample(self, name: str, **labels) -> Optional[Sample]:
        for s in self.samples:
            if s.name == name and all(s.labels.get(k) == str(v)
                                      for k, v in labels.items()):
                return s
        return None

    def values(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], float]:
        return {tuple(sorted(s.labels.items())): s.value
                for s in self.samples if s.name == name}


def _parse_value(raw: str, lineno: int) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(lineno, f"unparseable value {raw!r}") from None


def _parse_labels(raw: str, lineno: int) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ExpositionError(lineno, f"bad label syntax at {raw[pos:]!r}")
        name = m.group("name")
        if not LABEL_NAME_RE.match(name):
            raise ExpositionError(lineno, f"invalid label name {name!r}")
        if name in labels:
            raise ExpositionError(lineno, f"duplicate label {name!r}")
        labels[name] = (m.group("value").replace(r"\"", '"')
                        .replace(r"\n", "\n").replace(r"\\", "\\"))
        pos = m.end()
        if m.group("sep") == "," and pos >= len(raw):
            raise ExpositionError(lineno, "trailing comma in labels")
    return labels


def _sample_family(name: str, families: Dict[str, str]) -> Optional[str]:
    """The declared family a sample belongs to (histogram/summary samples
    carry _bucket/_sum/_count suffixes on top of the family name)."""
    if name in families:
        return name
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in families:
            base = name[: -len(suffix)]
            if families[base] in ("histogram", "summary"):
                return base
    return None


def parse_exposition(text: str) -> Exposition:
    """Parse + structurally validate one exposition document."""
    families: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: List[Sample] = []
    seen_series = set()
    current_family: Optional[str] = None
    closed_families = set()  # families whose sample block has ended

    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(None, 1)
            if not parts or not METRIC_NAME_RE.match(parts[0]):
                raise ExpositionError(lineno, "malformed HELP line")
            if parts[0] in helps:
                raise ExpositionError(lineno,
                                      f"duplicate HELP for {parts[0]!r}")
            helps[parts[0]] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2 or not METRIC_NAME_RE.match(parts[0]):
                raise ExpositionError(lineno, "malformed TYPE line")
            name, mtype = parts
            if mtype not in VALID_TYPES:
                raise ExpositionError(lineno, f"unknown type {mtype!r}")
            if name in families:
                raise ExpositionError(lineno,
                                      f"duplicate TYPE for {name!r}")
            families[name] = mtype
            continue
        if line.startswith("#"):
            continue  # free-form comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionError(lineno, f"unparseable sample {line!r}")
        name = m.group("name")
        family = _sample_family(name, families)
        if family is None:
            raise ExpositionError(
                lineno, f"sample {name!r} has no preceding # TYPE")
        if family != current_family:
            if family in closed_families:
                raise ExpositionError(
                    lineno, f"samples of family {family!r} are not "
                    "contiguous")
            if current_family is not None:
                closed_families.add(current_family)
            current_family = family
        labels = _parse_labels(m.group("labels") or "", lineno)
        value = _parse_value(m.group("value"), lineno)
        series = (name, tuple(sorted(labels.items())))
        if series in seen_series:
            raise ExpositionError(lineno, f"duplicate series {series!r}")
        seen_series.add(series)
        mtype = families[family]
        if mtype == "counter" and not (value >= 0 and math.isfinite(value)):
            raise ExpositionError(
                lineno, f"counter {name!r} has non-monotone-compatible "
                f"value {value}")
        samples.append(Sample(name=name, labels=labels, value=value,
                              family=family, type=mtype))

    _validate_histograms(families, samples)
    return Exposition(families=families, samples=samples)


def _validate_histograms(families: Dict[str, str],
                         samples: List[Sample]) -> None:
    for family, mtype in families.items():
        if mtype != "histogram":
            continue
        # group buckets by their non-le label set
        by_series: Dict[tuple, List[Tuple[float, float]]] = {}
        counts: Dict[tuple, float] = {}
        for s in samples:
            if s.family != family:
                continue
            key = tuple(sorted((k, v) for k, v in s.labels.items()
                               if k != "le"))
            if s.name == f"{family}_bucket":
                if "le" not in s.labels:
                    raise ExpositionError(0, f"{family}: bucket without le")
                le = _parse_value(s.labels["le"], 0)
                by_series.setdefault(key, []).append((le, s.value))
            elif s.name == f"{family}_count":
                counts[key] = s.value
        for key, buckets in by_series.items():
            bounds = [b for b, _ in buckets]
            if bounds != sorted(bounds):
                raise ExpositionError(0, f"{family}: le buckets out of order")
            if not bounds or not math.isinf(bounds[-1]):
                raise ExpositionError(0, f"{family}: missing +Inf bucket")
            values = [v for _, v in buckets]
            if values != sorted(values):
                raise ExpositionError(
                    0, f"{family}: bucket counts are not cumulative")
            if key in counts and counts[key] != values[-1]:
                raise ExpositionError(
                    0, f"{family}: _count {counts[key]} != +Inf bucket "
                    f"{values[-1]}")


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        print("usage: python -m repro_torch.obs.parser <exposition-file>")
        return 2
    with open(args[0]) as f:
        text = f.read()
    try:
        exp = parse_exposition(text)
    except ExpositionError as e:
        print(f"INVALID: {e}")
        return 1
    print(f"OK: {len(exp.families)} metric families, "
          f"{len(exp.samples)} samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
