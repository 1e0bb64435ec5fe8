"""Where the port's entry points run: the card unless the caller says
otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when a CUDA device is asked for and
    none is present: there is no silent move to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device
