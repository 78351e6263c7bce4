"""LSTM and the complex LSTM of the DCS-Net latent bottleneck.

``torch.nn.LSTM`` is the engine (gate order i, f, g, o; state ``(h, c)``
each (num_layers * directions, batch, hidden)); the JAX package's ``lax.scan``
LSTM is not a Pallas kernel. The complex LSTM stacks (x_re, x_im) on the
batch axis so each of its two real LSTMs runs once:
``out = (L_r(x_r) - L_i(x_i)) + i (L_r(x_i) + L_i(x_r))``.

At bf16 (``dtype``) the complex LSTM runs the JAX package's recurrence
instead (``dcs_net_tpu/ops/lstm.py:36-44, 134-142, 230-270``), which
``torch.nn.LSTM`` at bf16 is not (it keeps its state in bf16): every product
(the input projections and the recurrent ``h @ W_hh``) takes bf16 operands,
sums in float32 and is rounded to bf16, then widened to float32; the biases,
the gates, h and c stay float32; all four heads (real and imaginary LSTM,
forward and reverse, the reverse head on its flipped sequence) step at once
on the 2B-stacked batch, one batched product a step; the output is rounded to
the input's type, the state returned in float32. It is a Python loop over the
sequence, host-bound when eager; a CUDA graph (``models/graphed.py``) pays
that host cost once, at its capture.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dcs_net_tpu_torch.ops import precision as P
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


def _mm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The JAX ``_mm``: operands rounded to ``dt``, the product rounded to
    ``dt`` from float32 sums, then widened to float32."""
    return P.matmul(a.to(dt), b.to(dt)).float()


class ComplexLSTM(nn.Module):
    """Two real LSTMs (``real_lstm``, ``imag_lstm``) combined as a complex
    LSTM. The optional state is a pair (real LSTM's, imag LSTM's), each on
    the 2B-stacked batch. ``dtype`` bf16 runs the JAX recurrence on the same
    parameters (see above)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.real_lstm = LSTM(input_size, hidden_size, num_layers,
                              bidirectional, generator)
        self.imag_lstm = LSTM(input_size, hidden_size, num_layers,
                              bidirectional, generator)

    def _recurrence(self, stacked: torch.Tensor,
                    state: Optional[Tuple[State, State]]
                    ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[State, State]]:
        """The JAX ``ComplexLSTM`` at ``self.dtype`` on (2B, T, F): the real
        and imaginary LSTMs' outputs (2B, T, H D) in float32 and their final
        states, each (h, c) of (layers * D, 2B, H) in float32."""
        dt = self.dtype
        lstm = self.real_lstm
        L, H = lstm.num_layers, lstm.hidden_size
        D = 2 if lstm.bidirectional else 1
        B2, T, _ = stacked.shape
        if state is None:
            z = stacked.new_zeros((L * D, B2, H), dtype=torch.float32)
            state = ((z, z), (z, z))
        h0 = [tuple(t.float() for t in s) for s in state]     # real, imag (h, c)
        ins = (stacked, stacked)
        finals = ([], [], [], [])                              # h_r, c_r, h_i, c_i
        for layer in range(L):
            xps, whhs = [], []
            for mod, src in zip((self.real_lstm, self.imag_lstm), ins):
                for d in range(D):
                    sfx = f"l{layer}" + ("_reverse" if d else "")
                    b = getattr(mod, f"bias_ih_{sfx}") + getattr(mod, f"bias_hh_{sfx}")
                    xp = (_mm(src, getattr(mod, f"weight_ih_{sfx}").t(), dt) + b
                          ).transpose(0, 1)                     # (T, 2B, 4H)
                    xps.append(xp.flip(0) if d else xp)
                    whhs.append(getattr(mod, f"weight_hh_{sfx}").t())
            xp = torch.stack(xps, dim=1)                        # (T, heads, 2B, 4H)
            w_hh = torch.stack(whhs).to(dt)                     # (heads, H, 4H)
            rows = slice(layer * D, (layer + 1) * D)
            h = torch.cat([h0[0][0][rows], h0[1][0][rows]])     # (heads, 2B, H)
            c = torch.cat([h0[0][1][rows], h0[1][1][rows]])
            hs = []
            for t in range(T):
                gates = xp[t] + P.matmul(h.to(dt), w_hh).float()
                # one sigmoid over all four gates (g's is unused), fewer launches
                sig = torch.sigmoid(gates)
                i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
                c = f * c + i * torch.tanh(gates[..., 2 * H:3 * H])
                h = o * torch.tanh(c)
                hs.append(h)
            hs = torch.stack(hs)                                # (T, heads, 2B, H)

            def head_out(g):
                fwd = hs[:, g * D].transpose(0, 1)
                if D == 1:
                    return fwd
                return torch.cat([fwd, hs[:, g * D + 1].flip(0).transpose(0, 1)], dim=-1)

            ins = (head_out(0), head_out(1))
            for k, v in enumerate((h[:D], c[:D], h[D:], c[D:])):
                finals[k].append(v)
        h_r, c_r, h_i, c_i = (torch.cat(v) for v in finals)
        return ins[0], ins[1], ((h_r, c_r), (h_i, c_i))

    def forward(self, x: CArray, state: Optional[Tuple[State, State]] = None
                ) -> Tuple[CArray, Tuple[State, State]]:
        stacked = torch.cat([x.re, x.im], dim=0)  # (2B, T, F)
        if self.dtype is None:
            s_r, s_i = (None, None) if state is None else state
            out_r, new_r = self.real_lstm(stacked, s_r)
            out_i, new_i = self.imag_lstm(stacked, s_i)
        else:
            out_r, out_i, (new_r, new_i) = self._recurrence(stacked, state)
            out_r, out_i = out_r.to(x.re.dtype), out_i.to(x.re.dtype)
        B = x.re.shape[0]
        r2r, r2i = out_r[:B], out_r[B:]
        i2r, i2i = out_i[:B], out_i[B:]
        return CArray(r2r - i2i, r2i + i2r), (new_r, new_i)
