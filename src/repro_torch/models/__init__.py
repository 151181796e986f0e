from repro_torch.models.model import (  # noqa: F401
    Runtime,
    init_params,
    forward,
    loss_fn,
)
