"""The probes ported so far. The JAX package's runtime (``xla``), operator
and python probes come with a later slice; the step probe already emits the
runtime layer's ``executable_run`` rows."""
from repro_torch.core.probes.base import Probe  # noqa: F401
from repro_torch.core.probes.collective_probe import CollectiveProbe  # noqa: F401
from repro_torch.core.probes.device_probe import DeviceProbe, GpuTelemetryModel  # noqa: F401
from repro_torch.core.probes.step_probe import StepProbe  # noqa: F401
