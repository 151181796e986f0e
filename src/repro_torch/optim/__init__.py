from repro_torch.optim.optimizers import Optimizer, adamw, make_optimizer  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule, linear_schedule, make_schedule  # noqa: F401
