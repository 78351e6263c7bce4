"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Without a GPU
they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. Returns a ``torch.device`` of type cuda or cpu;
    raises if CUDA is asked for (explicitly or by default) and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to run "
            "the plain PyTorch versions of the kernels on the CPU")
    return dev
