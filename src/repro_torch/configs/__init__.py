"""Architecture configs of the port. Importing this package registers each
one with `repro_torch.config`; only the paper's GPT-2 workload is ported so
far (the JAX package's `repro.configs` lists the rest)."""
from repro_torch.configs import gpt2  # noqa: F401
