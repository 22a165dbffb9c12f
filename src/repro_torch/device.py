"""Where the port's entry points run: the card unless the caller says CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    A CUDA device with no card present raises: the entry points never fall
    back to the CPU on their own. Pass ``device="cpu"`` to run there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"repro_torch: device {dev} requested but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev
