"""The probe suite (port of `repro/core/probes/`). The reference's runtime
probe ``xla`` (`jax_probe.py`, on ``jax.monitoring``) is `CudaRuntimeProbe`
here, on torch's CUDA runtime entry points; the registry name and the layer
stay ``xla``."""
from repro_torch.core.probes.base import Probe  # noqa: F401
from repro_torch.core.probes.python_probe import PythonProbe  # noqa: F401
from repro_torch.core.probes.runtime_probe import CudaRuntimeProbe  # noqa: F401
from repro_torch.core.probes.operator_probe import OperatorProbe  # noqa: F401
from repro_torch.core.probes.collective_probe import CollectiveProbe  # noqa: F401
from repro_torch.core.probes.device_probe import DeviceProbe, GpuTelemetryModel  # noqa: F401
from repro_torch.core.probes.step_probe import StepProbe  # noqa: F401
