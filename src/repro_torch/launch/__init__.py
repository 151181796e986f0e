"""Drivers of the port (port of `repro/launch/`): so far the training
entry point, `python -m repro_torch.launch.train`."""
