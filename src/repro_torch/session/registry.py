"""String-keyed probe registry (the probe half of `repro/session/registry.py`).

A third-party probe attaches by name (``@register_probe("my_probe")``) and
becomes addressable without touching the collector. Factories receive
``(options, peers)``: the per-probe option dict and the probes already built
for the same collector, in order. That is how the step probe finds the
collective/device probes it drives — order the dependent probe after its
peers. The detector and sink registries come with the session slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.probes import (CollectiveProbe, DeviceProbe, Probe,
                                     StepProbe)
from repro_torch.core.probes.device_probe import (H100_PEAK_FLOPS,
                                                  H100_POWER_LIMIT_W,
                                                  GpuTelemetryModel)

ProbeFactory = Callable[[Dict[str, Any], Dict[str, Probe]], Probe]

_PROBES: Dict[str, ProbeFactory] = {}


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
    """Build a probe suite in order; later factories see earlier probes
    (keyed by registry name) as peers."""
    opts = probe_options or {}
    peers: Dict[str, Probe] = {}
    out: List[Probe] = []
    for name in names:
        p = build_probe(name, opts.get(name), peers)
        peers[name] = p
        out.append(p)
    return out


# -- builtin probe factories --------------------------------------------------

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
    return StepProbe(collective_probe=peers.get("collective"),
                     device_probe=peers.get("device"),
                     peak_flops=float(opts.get("peak_flops", H100_PEAK_FLOPS)))
