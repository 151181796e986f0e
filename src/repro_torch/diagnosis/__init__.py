"""Cross-layer root-cause diagnosis (port of `repro/diagnosis/`): incidents
-> scored, actionable diagnoses (blamed fault kind + causal chain +
recommended governor action).

Public API:
    Diagnoser / Diagnosis / ChainLink — the attribution engine
    evidence_from_columns             — batch ColumnView -> per-layer evidence
    render_incident_report / report_json — the operator incident report
    FAULT_FAMILY                      — fault kind -> taxonomy family label
"""
from repro_torch.diagnosis.engine import (ChainLink, Diagnoser,  # noqa: F401
                                          Diagnosis, Evidence, FAULT_FAMILY,
                                          diagnoses_to_json,
                                          evidence_from_columns)
from repro_torch.diagnosis.report import (render_incident_report,  # noqa: F401
                                          report_json)
