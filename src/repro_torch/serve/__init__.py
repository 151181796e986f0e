"""The serve plane (port of `repro/serve/`): the decode engines, the request
plane's data model and admission, the request probe and the SLO monitor."""
from repro_torch.serve.engine import (GraphedStep, ServeEngine,  # noqa: F401
                                      make_decode_step, make_prefill)
from repro_torch.serve.request import (LoadGenerator, Request,  # noqa: F401
                                       RequestQueue)
from repro_torch.serve.scheduler import AdmissionScheduler  # noqa: F401
from repro_torch.serve.continuous import (ContinuousBatchingEngine,  # noqa: F401
                                          VirtualClock, make_slot_step)
from repro_torch.serve.probe import RequestProbe, publish  # noqa: F401
from repro_torch.serve.slo import SLOMonitor, SLOSpec  # noqa: F401
