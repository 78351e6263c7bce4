"""Parameter initializers with the torch distributions of the original code,
drawn from an explicit ``torch.Generator``.

Fans follow torch's own rule on the torch weight layout:
  conv:   (Cout, Cin, kh, kw) -> fan_in = Cin*kh*kw,  fan_out = Cout*kh*kw
  convT:  (Cin, Cout, kh, kw) -> fan_in = Cout*kh*kw, fan_out = Cin*kh*kw
  linear: (out, in)           -> fan_in = in,         fan_out = out
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

Init = Callable[[Sequence[int], Optional[torch.Generator]], torch.Tensor]


def _uniform(bound: float) -> Init:
    def init(shape, generator=None):
        t = torch.empty(tuple(shape), dtype=torch.float32)
        return t.uniform_(-bound, bound, generator=generator)

    return init


def xavier_uniform(fan_in: int, fan_out: int, gain: float = 1.0) -> Init:
    return _uniform(gain * math.sqrt(6.0 / (fan_in + fan_out)))


def kaiming_uniform(fan_in: int, a: float = math.sqrt(5.0)) -> Init:
    """torch.nn.init.kaiming_uniform_ with nonlinearity='leaky_relu'."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return _uniform(gain * math.sqrt(3.0 / fan_in))


def torch_bias_uniform(fan_in: int) -> Init:
    """torch Conv/Linear default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def lstm_uniform(hidden_size: int) -> Init:
    """torch LSTM default: every parameter U(-1/sqrt(H), 1/sqrt(H))."""
    return torch_bias_uniform(hidden_size)


def weight_init(name: str, fan_in: int, fan_out: int) -> Init:
    if name == "xavier_uniform":
        return xavier_uniform(fan_in, fan_out)
    if name == "kaiming_uniform":
        return kaiming_uniform(fan_in)
    raise ValueError(f"unknown init {name!r}")
