"""Launchers: the device mesh over a ``torch.distributed`` process group
and the serving driver (``python -m repro_torch.launch.serve``)."""
