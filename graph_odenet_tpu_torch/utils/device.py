"""The device an entry point runs on.

The port's entry points run on the card unless the caller asks for the CPU:
without a card, ``device="cuda"`` raises instead of training on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no card is there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU"
        )
    return dev
