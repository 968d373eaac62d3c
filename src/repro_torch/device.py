"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller names another device (the
CPU tests pass ``device="cpu"``). A missing GPU is an error, never a
silent fall-back to the CPU: a benchmark or a server that quietly ran on
the host would report host numbers under a device's name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a :class:`torch.device`.

    Raises :class:`~repro_torch.serve.errors.ResidencyError` when a CUDA
    device is asked for (explicitly or by default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        # imported here: serve imports this module while it initialises
        from .serve.errors import ResidencyError
        raise ResidencyError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions of the kernels on the host")
    return dev
