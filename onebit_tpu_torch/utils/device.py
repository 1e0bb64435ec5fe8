"""Where the port's entry points run: the card unless the caller says
otherwise."""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when a CUDA device is asked for and
    none is present: there is no silent move to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device


def is_fake(t: torch.Tensor) -> bool:
    """A fake tensor (shapes and dtypes, no storage): the memory plans of
    ``parallel/memplan.py`` run the steps on them."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernel path: a CUDA tensor, or a fake one,
    whose kernel wrappers return the kernels' outputs' shapes (the memory
    plans count the kernel path, not the plain one)."""
    return t.device.type == "cuda" or is_fake(t)
