"""LSTM and the complex LSTM of the DCS-Net latent bottleneck.

``torch.nn.LSTM`` is the engine (gate order i, f, g, o; state ``(h, c)``
each (num_layers * directions, batch, hidden)); the JAX package's ``lax.scan``
LSTM is not a Pallas kernel. The complex LSTM stacks (x_re, x_im) on the
batch axis so each of its two real LSTMs runs once:
``out = (L_r(x_r) - L_i(x_i)) + i (L_r(x_i) + L_i(x_r))``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dcs_net_tpu_torch.ops.initializers import lstm_uniform
from dcs_net_tpu_torch.utils.carray import CArray

State = Tuple[torch.Tensor, torch.Tensor]


class LSTM(nn.LSTM):
    """``torch.nn.LSTM(batch_first=True)`` drawn from an explicit generator:
    every parameter U(-1/sqrt(H), 1/sqrt(H)). ``forward(x, state)`` returns
    ``(out (B, T, H*D), (h, c))``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True, bidirectional=bidirectional)
        u = lstm_uniform(hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(u(p.shape, generator))


class ComplexLSTM(nn.Module):
    """Two real LSTMs (``real_lstm``, ``imag_lstm``) combined as a complex
    LSTM. The optional state is a pair (real LSTM's, imag LSTM's), each on
    the 2B-stacked batch."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.real_lstm = LSTM(input_size, hidden_size, num_layers,
                              bidirectional, generator)
        self.imag_lstm = LSTM(input_size, hidden_size, num_layers,
                              bidirectional, generator)

    def forward(self, x: CArray, state: Optional[Tuple[State, State]] = None
                ) -> Tuple[CArray, Tuple[State, State]]:
        stacked = torch.cat([x.re, x.im], dim=0)  # (2B, T, F)
        s_r, s_i = (None, None) if state is None else state
        out_r, new_r = self.real_lstm(stacked, s_r)
        out_i, new_i = self.imag_lstm(stacked, s_i)
        B = x.re.shape[0]
        r2r, r2i = out_r[:B], out_r[B:]
        i2r, i2i = out_i[:B], out_i[B:]
        return CArray(r2r - i2i, r2i + i2r), (new_r, new_i)
