"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; raises rather than carry on
    quietly on the CPU when a CUDA device is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")
    return dev
