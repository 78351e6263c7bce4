"""CBAM channel and spatial attention, real (DR / DRS) and complex (DC / DCS).

The real channel attention keeps only its max branch under the faithful
quirk ``real_ca_max_only``. The real spatial attention's k=7 conv over
[mean, max] is kernel 2's conv entry at the class (K, Cin, Cout) = (7, 2, 1)
(its input gradient (7, 1, 2)), followed by a sigmoid;
:meth:`RealSpatialAttention.gate` applies it to its input as kernel 2's real
gate (pool, then conv + sigmoid + broadcast product), forward-only like the
complex one, and un-fused under autograd.

With ``maxpool_is_avg`` (the faithful quirk) the complex "max" pool is an
average pool, so the channel attention computes sigmoid(fc(avg) + fc(avg)).
The spatial attention's k=7 conv is the small-Cout "same" conv of kernel 2;
:meth:`ComplexSpatialAttention.gate` applies the attention to its input as
kernel 2's fused gate (pool, then conv + sigmoid + product), which is
forward-only. Where autograd follows the input or the weights (training) the
gate takes the un-fused form, the JAX structure: pooling, the conv (kernel 2
under autograd), the sigmoid and the product as separate ops.

At bf16 (``dtype``, the JAX modules' operand type) the channel attentions'
1x1 convs take bf16 operands, and the complex spatial attention's gate runs
kernel 2's fused bf16 gate (``cuda_conv.sa_fused_bf16``: pool, conv
on tensor cores, sigmoid and product in one launch, x read once) on its
packed kernel rounded to bf16 once, or the bf16 pool and gate pair at a
shape the fused entry refuses. Its un-fused form (training at bf16) pools
(the mean rounded once, the max exact), runs the conv entry's bf16 class,
the sigmoid and the product, each rounded to bf16 at the JAX module's
rounding points, under autograd. The real spatial attention at bf16 does the
same with kernel 2's real classes: its gate runs the real pool and gate's
bf16 classes (``cuda_conv.sa_pool_real``, ``cuda_conv.sa_gate_real``: the
mean rounded once, the conv's float32 sums rounded, the sigmoid rounded, the
product rounded once, as the JAX module and ``widen.mul_bcast`` round), its
un-fused form the conv entry's bf16 class at (7, 2, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dcs_net_tpu_torch.ops import complex_layers as cl
from dcs_net_tpu_torch.ops import cuda_conv
from dcs_net_tpu_torch.ops import precision as P
from dcs_net_tpu_torch.ops import real_layers as rl
from dcs_net_tpu_torch.utils.carray import CArray


class RealChannelAttention(nn.Module):
    def __init__(self, channels: int, reduction: int, max_only: bool = True,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.max_only = max_only
        self.fc1 = rl.Conv2d(channels, hidden, 1, use_bias=False,
                             weight_init=weight_init, generator=generator, dtype=dtype)
        self.fc2 = rl.Conv2d(hidden, channels, 1, use_bias=False,
                             weight_init=weight_init, generator=generator, dtype=dtype)

    def _fc(self, v: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(v)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, 1, C) attention of x (B, H, W, C)."""
        out = self._fc(rl.adaptive_max_pool_1(x))
        if not self.max_only:
            out = self._fc(rl.adaptive_avg_pool_1(x)) + out
        return torch.sigmoid(out)


class RealSpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = rl.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              use_bias=False, weight_init=weight_init,
                              generator=generator, dtype=dtype)
        self._packed = None     # (key, packed kernel) of the last gate call

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) attention of x (B, H, W, C); the mean summed in
        float32 (at least) and rounded to x's type once."""
        acc = torch.promote_types(x.dtype, torch.float32)
        cat = torch.cat([x.mean(dim=-1, keepdim=True, dtype=acc).to(x.dtype),
                         x.amax(dim=-1, keepdim=True)], dim=-1)
        return torch.sigmoid(self.conv(cat))

    def packed_kernel(self) -> torch.Tensor:
        """The conv's weight (1, 2, K, K) as the gate's (K, K, 2, 1) (at bf16
        rounded to bf16): built once, detached, and kept until the weight
        changes (its version or its address, as
        :meth:`ComplexSpatialAttention.packed_kernel`)."""
        w = self.conv.weight
        key = (w.device, w.data_ptr(), w._version)
        if self._packed is None or self._packed[0] != key:
            packed = P.cast(w.detach().permute(2, 3, 1, 0), self.dtype)
            self._packed = (key, packed.contiguous())
        return self._packed[1]

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        """x * self(x), the attention applied to its own input: kernel 2's
        real pool and gate launches on a CUDA tensor (at bf16 their bf16
        classes), their plain versions on a CPU tensor. Under autograd, or
        at another kernel size, the un-fused form, whose conv alone is
        kernel 2."""
        w = self.conv.weight
        if w.shape[-1] != 7 or (torch.is_grad_enabled()
                                and (x.requires_grad or w.requires_grad)):
            return x * self(x)
        return cuda_conv.spatial_gate_real(P.cast(x, self.dtype).contiguous(),
                                           self.packed_kernel())


class ComplexChannelAttention(nn.Module):
    def __init__(self, channels: int, reduction: int,
                 maxpool_is_avg: bool = True,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.maxpool_is_avg = maxpool_is_avg
        self.fc1 = cl.ComplexConv2d(channels, hidden, 1, use_bias=False,
                                    weight_init=weight_init, generator=generator,
                                    dtype=dtype)
        self.fc2 = cl.ComplexConv2d(hidden, channels, 1, use_bias=False,
                                    weight_init=weight_init, generator=generator,
                                    dtype=dtype)

    def _fc(self, v: CArray) -> CArray:
        return self.fc2(cl.complex_relu(self.fc1(v)))

    def forward(self, x: CArray) -> CArray:
        avg_out = self._fc(cl.complex_adaptive_avg_pool_1(x))
        if self.maxpool_is_avg:
            # the "max" branch is the avg branch again: compute it once
            return cl.complex_sigmoid(avg_out + avg_out)
        max_out = self._fc(cl.complex_adaptive_max_pool_1(x, faithful_avg=False))
        return cl.complex_sigmoid(avg_out + max_out)


class ComplexSpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = cl.ComplexConv2d(2, 1, kernel_size,
                                     padding=kernel_size // 2, use_bias=False,
                                     weight_init=weight_init,
                                     generator=generator, dtype=dtype)
        self._packed = None     # (key, packed kernel) of the last gate call

    def forward(self, x: CArray) -> CArray:
        """The attention map (B, H, W, 1) alone."""
        cat = CArray(
            torch.cat([x.re.mean(dim=-1, keepdim=True),
                       x.re.amax(dim=-1, keepdim=True)], dim=-1),
            torch.cat([x.im.mean(dim=-1, keepdim=True),
                       x.im.amax(dim=-1, keepdim=True)], dim=-1))
        return cl.complex_sigmoid(self.conv(cat))

    def packed_kernel(self) -> torch.Tensor:
        """The conv's block kernel (K, K, 4, 2) over the pooled map
        [mean re, max re, mean im, max im], for the forward-only fused gate
        (at bf16 rounded to bf16): built once, detached, and kept until a
        weight changes: an in-place update (an optimizer step,
        ``load_state_dict``) moves the tensor's version, a move to another
        device its address."""
        wr, wi = self.conv.weight_r, self.conv.weight_i
        key = (wr.device, wr.data_ptr(), wr._version, wi.data_ptr(), wi._version)
        if self._packed is None or self._packed[0] != key:
            packed = P.cast(self.conv.block_kernel().detach(), self.dtype)
            self._packed = (key, packed.contiguous())
        return self._packed[1]

    def gate(self, x: CArray) -> CArray:
        """x * self(x), the attention applied to its own input: kernel 2's
        pool and gate launches on a CUDA tensor (at bf16 its fused entry),
        their plain versions on a CPU tensor. Under autograd, or at another
        kernel size, the un-fused form, whose conv alone is kernel 2."""
        wr, wi = self.conv.weight_r, self.conv.weight_i
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x.re, x.im, wr, wi)):
            return cl.complex_mul_bcast(x, self(x))
        w = self.packed_kernel()
        if tuple(w.shape) != (7, 7, 4, 2):
            return cl.complex_mul_bcast(x, self(x))
        dt = self.dtype
        return CArray(*cuda_conv.spatial_gate(
            P.cast(x.re, dt).contiguous(), P.cast(x.im, dt).contiguous(), w.contiguous()))
