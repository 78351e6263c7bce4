"""LSTM and the complex LSTM of the DCS-Net latent bottleneck.

``torch.nn.LSTM`` is the engine (gate order i, f, g, o; state ``(h, c)``
each (num_layers * directions, batch, hidden)); the JAX package's ``lax.scan``
LSTM is not a Pallas kernel. The complex LSTM stacks (x_re, x_im) on the
batch axis so each of its two real LSTMs runs once:
``out = (L_r(x_r) - L_i(x_i)) + i (L_r(x_i) + L_i(x_r))``.

At bf16 (``dtype``) the LSTM and the complex LSTM run the JAX package's
recurrence instead (``dcs_net_tpu/ops/lstm.py:36-152, 230-270``), one
function for both (:func:`recurrence`), which
``torch.nn.LSTM`` at bf16 is not (it keeps its state in bf16): every product
(the input projections and the recurrent ``h @ W_hh``) takes bf16 operands,
sums in float32 and is rounded to bf16, then widened to float32; the biases,
the gates, h and c stay float32; every head (forward and reverse, the
reverse head on its flipped sequence; of the complex LSTM the real and the
imaginary LSTM's, on the 2B-stacked batch) steps at once, one batched product
a step; the output is rounded to the input's type, the state returned in
float32. It is a Python loop over the
sequence, host-bound when eager; a CUDA graph (``models/graphed.py``) pays
that host cost once, at its capture.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from dcs_net_tpu_torch.ops import precision as P
from dcs_net_tpu_torch.ops.initializers import lstm_uniform
from dcs_net_tpu_torch.utils.carray import CArray

State = Tuple[torch.Tensor, torch.Tensor]


class LSTM(nn.LSTM):
    """``torch.nn.LSTM(batch_first=True)`` drawn from an explicit generator:
    every parameter U(-1/sqrt(H), 1/sqrt(H)). ``forward(x, state)`` returns
    ``(out (B, T, H*D), (h, c))``. ``dtype`` bf16 runs the JAX recurrence on
    the same parameters (:func:`recurrence`): the output in x's type, the
    state float32."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True, bidirectional=bidirectional)
        self.dtype = dtype
        u = lstm_uniform(hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(u(p.shape, generator))

    def forward(self, x: torch.Tensor, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, State]:
        if self.dtype is None:
            return super().forward(x, state)
        (out,), (new,) = recurrence([self], [x], [state], self.dtype)
        return out.to(x.dtype), new


def _mm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The JAX ``_mm``: operands rounded to ``dt``, the product rounded to
    ``dt`` from float32 sums, then widened to float32."""
    return P.matmul(a.to(dt), b.to(dt)).float()


def recurrence(lstms: Sequence[nn.LSTM], ins: Sequence[torch.Tensor],
               states: Sequence[Optional[State]], dt: torch.dtype
               ) -> Tuple[List[torch.Tensor], List[State]]:
    """The JAX LSTM recurrence at operand type ``dt`` (see above) for LSTMs
    of one shape, each on its own input (B, T, F) and optional state (h, c)
    of (layers * D, B, H): every head of every LSTM (forward and reverse)
    steps at once, one batched product a step. Returns each LSTM's output
    (B, T, H D) and final state (h, c), all float32."""
    first = lstms[0]
    L, H = first.num_layers, first.hidden_size
    D = 2 if first.bidirectional else 1
    B, T, _ = ins[0].shape
    h0 = []
    for s in states:
        if s is None:
            z = ins[0].new_zeros((L * D, B, H), dtype=torch.float32)
            s = (z, z)
        h0.append(tuple(t.float() for t in s))
    ins = list(ins)
    finals = [([], []) for _ in lstms]                       # per LSTM: h, c
    for layer in range(L):
        xps, whhs = [], []
        for mod, src in zip(lstms, ins):
            for d in range(D):
                sfx = f"l{layer}" + ("_reverse" if d else "")
                b = getattr(mod, f"bias_ih_{sfx}") + getattr(mod, f"bias_hh_{sfx}")
                xp = (_mm(src, getattr(mod, f"weight_ih_{sfx}").t(), dt) + b
                      ).transpose(0, 1)                         # (T, B, 4H)
                xps.append(xp.flip(0) if d else xp)
                whhs.append(getattr(mod, f"weight_hh_{sfx}").t())
        xp = torch.stack(xps, dim=1)                            # (T, heads, B, 4H)
        w_hh = torch.stack(whhs).to(dt)                         # (heads, H, 4H)
        rows = slice(layer * D, (layer + 1) * D)
        h = torch.cat([s[0][rows] for s in h0])                 # (heads, B, H)
        c = torch.cat([s[1][rows] for s in h0])
        hs = []
        for t in range(T):
            gates = xp[t] + P.matmul(h.to(dt), w_hh).float()
            # one sigmoid over all four gates (g's is unused), fewer launches
            sig = torch.sigmoid(gates)
            i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
            c = f * c + i * torch.tanh(gates[..., 2 * H:3 * H])
            h = o * torch.tanh(c)
            hs.append(h)
        hs = torch.stack(hs)                                    # (T, heads, B, H)

        def head_out(g):
            fwd = hs[:, g * D].transpose(0, 1)
            if D == 1:
                return fwd
            return torch.cat([fwd, hs[:, g * D + 1].flip(0).transpose(0, 1)], dim=-1)

        ins = [head_out(g) for g in range(len(lstms))]
        for g, (fh, fc) in enumerate(finals):
            fh.append(h[g * D:(g + 1) * D])
            fc.append(c[g * D:(g + 1) * D])
    return ins, [(torch.cat(fh), torch.cat(fc)) for fh, fc in finals]


class ComplexLSTM(nn.Module):
    """Two real LSTMs (``real_lstm``, ``imag_lstm``) combined as a complex
    LSTM. The optional state is a pair (real LSTM's, imag LSTM's), each on
    the 2B-stacked batch. ``dtype`` bf16 runs the JAX recurrence on the same
    parameters (:func:`recurrence`, both LSTMs' four heads at once)."""

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

    def forward(self, x: CArray, state: Optional[Tuple[State, State]] = None
                ) -> Tuple[CArray, Tuple[State, State]]:
        stacked = torch.cat([x.re, x.im], dim=0)  # (2B, T, F)
        if self.dtype is None:
            s_r, s_i = (None, None) if state is None else state
            out_r, new_r = self.real_lstm(stacked, s_r)
            out_i, new_i = self.imag_lstm(stacked, s_i)
        else:
            (out_r, out_i), (new_r, new_i) = recurrence(
                [self.real_lstm, self.imag_lstm], [stacked, stacked],
                [None, None] if state is None else list(state), self.dtype)
            out_r, out_i = out_r.to(x.re.dtype), out_i.to(x.re.dtype)
        B = x.re.shape[0]
        r2r, r2i = out_r[:B], out_r[B:]
        i2r, i2i = out_i[:B], out_i[B:]
        return CArray(r2r - i2i, r2i + i2r), (new_r, new_i)
