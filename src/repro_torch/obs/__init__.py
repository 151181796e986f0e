"""Self-telemetry of the monitor itself (port of `repro/obs/`): metric
primitives, a strict exposition parser, an HTTP endpoint, and the live
`prometheus`/`board` sinks (registered on import of `repro_torch.session`)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                               MetricRegistry)
from repro_torch.obs.parser import (Exposition, ExpositionError,  # noqa: F401
                              parse_exposition)
from repro_torch.obs.selfmetrics import METRIC_NAMES, SessionObs  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "Exposition", "ExpositionError", "parse_exposition",
           "METRIC_NAMES", "SessionObs"]
