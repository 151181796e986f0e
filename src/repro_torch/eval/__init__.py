"""Scenario-matrix evaluation (port of `repro/eval/`): scores the monitoring
stack against chaos ground truth (paper §V, Table-I-style results for this
repo's detectors).

The subsystem closes the loop between fault injection
(`repro_torch.core.chaos` scenarios) and detection
(`repro_torch.session.Session`):

    scenario --FaultInjector--> monitored run --MonitorReport-->
        step predictions --metrics--> precision/recall/F1, time-to-detect,
        false-alarm rate, diagnosis accuracy (blamed kind / node / action)
        --matrix--> scenario_matrix.json + leaderboard.md

Entry points:
    python -m repro_torch.launch.evaluate --scenarios smoke --out results/eval/
    run_matrix(...)                       # library use
    run_scenario(scenario, mode, config)  # one cell

Cells run on ``cuda`` unless ``device="cpu"`` is given. The train
scenarios are ported; the serve and request scenarios come with the serve/
slice and raise until then. See docs/evaluation.md for the methodology and
the documented false-alarm ceiling of the clean-control scenario.
"""
from repro_torch.eval.metrics import (DetectionMetrics,  # noqa: F401
                                      DiagnosisMetrics, debounce,
                                      detection_metrics, diagnosis_metrics,
                                      step_predictions, window_kinds)
from repro_torch.eval.runner import (EvalConfig, ScenarioRun,  # noqa: F401
                                     run_scenario)
from repro_torch.eval.matrix import (CONFIG_GRID, FAR_CEILING,  # noqa: F401
                                     render_leaderboard, run_matrix,
                                     save_matrix)
