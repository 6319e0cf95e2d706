"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never the CPU in the card's place."""

from __future__ import annotations

import torch


def entry_device(device, given: str = "device='cuda'", cpu: str = "device='cpu'"):
    """``device`` as a ``torch.device``. A CUDA device where torch finds
    none raises ``RuntimeError``, naming the option as the caller spells it
    (``given``, and ``cpu`` for the way out): there is no fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{given} (the default) but torch finds no CUDA device; pass {cpu} "
                           "to run the torch scan path on the CPU")
    return device
