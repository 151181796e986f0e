"""String-keyed registries for probes, detector backends, and sinks (port
of `repro/session/registry.py`).

The registries are the extension surface of the session API: a third-party
probe attaches by name (``@register_probe("my_probe")``) and becomes
addressable from a `MonitorSpec` without touching the collector. The same
pattern covers detector backends (keyed by ``(name, mode)`` so "gmm" can
resolve to the batch or the streaming implementation) and sinks (keyed by
kind).

Factories receive ``(options, peers)``: the spec's per-probe option dict and
the probes already built for the same collector, in spec order. That is how
the step probe finds the operator/collective/device probes it drives — order
the dependent probe after its peers in ``MonitorSpec.probes``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.probes import (CollectiveProbe, CudaRuntimeProbe,
                                     DeviceProbe, OperatorProbe, Probe,
                                     PythonProbe, StepProbe)
from repro_torch.core.probes.device_probe import (H100_PEAK_FLOPS,
                                                  H100_POWER_LIMIT_W,
                                                  GpuTelemetryModel)

ProbeFactory = Callable[[Dict[str, Any], Dict[str, Probe]], Probe]

_PROBES: Dict[str, ProbeFactory] = {}
_DETECTORS: Dict[Tuple[str, str], type] = {}
_SINKS: Dict[str, type] = {}

def _lookup(table: Dict, key, kind: str):
    try:
        return table[key]
    except KeyError:
        names = ", ".join(sorted(str(k) for k in table)) or "(none)"
        raise KeyError(f"no {kind} registered under {key!r}; "
                       f"available: {names}") from None


def register_probe(name: str) -> Callable[[ProbeFactory], ProbeFactory]:
    """Register (or override) a probe factory under ``name``."""
    def deco(factory: ProbeFactory) -> ProbeFactory:
        _PROBES[name] = factory
        return factory
    return deco


def probe_names() -> List[str]:
    return sorted(_PROBES)


def build_probe(name: str, options: Optional[Dict[str, Any]] = None,
                peers: Optional[Dict[str, Probe]] = None) -> Probe:
    factory = _lookup(_PROBES, name, "probe")
    return factory(dict(options or {}), dict(peers or {}))


def build_probes(names: List[str],
                 probe_options: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> List[Probe]:
    """Build a probe suite in spec order; later factories see earlier probes
    (keyed by registry name) as peers."""
    opts = probe_options or {}
    peers: Dict[str, Probe] = {}
    out: List[Probe] = []
    for name in names:
        p = build_probe(name, opts.get(name), peers)
        peers[name] = p
        out.append(p)
    return out


# -- detector backends --------------------------------------------------------

def register_detector(name: str, mode: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _DETECTORS[(name, mode)] = cls
        return cls
    return deco


def detector_backend(name: str, mode: str) -> type:
    return _lookup(_DETECTORS, (name, mode), "detector backend")


def detector_names() -> List[str]:
    return sorted({k for k, _ in _DETECTORS})


def detector_backends() -> List[Tuple[str, str]]:
    """Every registered (name, mode) pair — the conformance suite's axis:
    anything listed here must pass the whole detector contract."""
    return sorted(_DETECTORS)


# -- sinks --------------------------------------------------------------------

def register_sink(kind: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _SINKS[kind] = cls
        return cls
    return deco


def sink_class(kind: str) -> type:
    return _lookup(_SINKS, kind, "sink")


def sink_kinds() -> List[str]:
    return sorted(_SINKS)


# -- builtin probe factories --------------------------------------------------

@register_probe("python")
def _python_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    # spec-level default samples 1-in-25 calls: tracing every python call
    # (the probe-class default) is only affordable in targeted runs, and 25
    # is what both drivers have always used
    return PythonProbe(include=tuple(opts.get("include",
                                              ("repro_torch", "torch"))),
                       sample_every=int(opts.get("sample_every", 25)),
                       max_depth=int(opts.get("max_depth", 64)))


@register_probe("xla")
def _xla_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    return CudaRuntimeProbe()


@register_probe("operator")
def _operator_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    return OperatorProbe(top_n=int(opts.get("top_n", 24)))


@register_probe("collective")
def _collective_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    seed = opts.get("seed")
    return CollectiveProbe(link_bw=float(opts.get("link_bw", 50e9)),
                           latency_us=float(opts.get("latency_us", 10.0)),
                           seed=None if seed is None else int(seed))


@register_probe("device")
def _device_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    n = int(opts.get("n_devices", 1))
    peak_w = float(opts.get("peak_w", H100_POWER_LIMIT_W))
    return DeviceProbe(interval=float(opts.get("interval", 0.25)),
                       telemetry=[GpuTelemetryModel(peak_w=peak_w, seed=i)
                                  for i in range(n)])


@register_probe("step")
def _step_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    return StepProbe(operator_probe=peers.get("operator"),
                     collective_probe=peers.get("collective"),
                     device_probe=peers.get("device"),
                     peak_flops=float(opts.get("peak_flops", H100_PEAK_FLOPS)))


@register_probe("request")
def _request_probe(opts: Dict[str, Any], peers: Dict[str, Probe]) -> Probe:
    # lazy: repro_torch.serve pulls in the model stack, which non-serving
    # sessions should not pay for just by importing the registry
    from repro_torch.serve.probe import RequestProbe

    return RequestProbe(sample_every=int(opts.get("sample_every", 4)),
                        slo_buffer=int(opts.get("slo_buffer", 8192)))
