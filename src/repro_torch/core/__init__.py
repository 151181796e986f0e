"""eACGM core on PyTorch: non-instrumented monitoring + GMM anomaly detection.

Public API:
    Collector      — probe suite + event table (attach/detach at runtime)
    FullStackMonitor, GMMDetector — paper Algorithms 1-2, fitted on the card
    FaultInjector  — pytorchfi/DCGM/chaosblade analogue
    Governor       — anomaly -> action policies
"""
from repro_torch.core.events import Event, Layer, RingBuffer, export_perfetto  # noqa: F401
from repro_torch.core.collector import Collector  # noqa: F401
from repro_torch.core.detector import DetectionResult, FullStackMonitor, GMMDetector  # noqa: F401
from repro_torch.core.gmm import GMM, GMMParams, fit_gmm, score_samples, detect_anomalies  # noqa: F401
from repro_torch.core.chaos import (Fault, FaultInjector, Scenario,  # noqa: F401
                                    get_scenario, register_scenario,
                                    scenario_names)
from repro_torch.core.governor import (Action, Governor,  # noqa: F401
                                       Policy, policy_for,
                                       register_policy)
