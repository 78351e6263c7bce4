"""Kernel 2: stride-1 "same" convolution with small Cout (``csrc/conv_same.cu``)
and its plain version.

Replaces the Pallas kernel ``dcs_net_tpu/ops/pallas_conv.py:_conv_fwd_pallas``.
On the DCS path it runs the 13 CBAM spatial-attention convs (Cin 4, Cout 2,
K 7). On the H100 it is narrowly bound by float32 operations (33 FLOP per
byte); the kernel reads its input once into a shared-memory tile with the
zero halo and keeps all Cout accumulators of a pixel in registers. See the
source for the design notes.

:func:`conv2d_same_small_cout` takes CPU tensors through the plain version
and CUDA tensors through the kernel, never falling back between the two.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.utils.cuda_lib import CudaKernel, check_cuda_operand, ptr

MAX_K = 7
MAX_COUT = 16

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "conv_same_small_cout", "conv_same.cu", "dcs_conv_same_small_cout",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p])


def applicable(kernel_size: int, cout: int) -> bool:
    """Odd K <= 7 and 1 <= Cout <= 16: the shapes kernel 2 takes."""
    return kernel_size % 2 == 1 and kernel_size <= MAX_K and 1 <= cout <= MAX_COUT


def _check_shapes(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or bias.dim() != 1:
        raise ValueError(f"expected x (B,H,W,Cin), w (K,K,Cin,Cout), bias "
                         f"(Cout,); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(bias.shape)}")
    K, K2, cin, cout = w.shape
    if K != K2 or not applicable(K, cout):
        raise ValueError(f"kernel {K}x{K2} with Cout {cout}: need square odd "
                         f"K <= {MAX_K} and Cout <= {MAX_COUT}")
    if x.shape[-1] != cin or bias.shape[0] != cout:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, bias {tuple(bias.shape)}")


def conv2d_same_small_cout_plain(x: torch.Tensor, w: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """Plain version: zero pad, then the K*K shifted-slice sum of
    (pixels x Cin) @ (Cin x Cout) matmuls, plus bias."""
    _check_shapes(x, w, bias)
    K = w.shape[0]
    p = K // 2
    B, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, p, p, p, p))
    y = bias.to(x.dtype).expand(B, H, W, w.shape[-1]).clone()
    for kh in range(K):
        for kw in range(K):
            y = y + torch.matmul(xp[:, kh:kh + H, kw:kw + W, :], w[kh, kw])
    return y


def conv2d_same_small_cout(x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Stride-1 'same' cross-correlation (torch Conv2d, padding=K//2).
    x (B, H, W, Cin), w (K, K, Cin, Cout), bias (Cout,) -> (B, H, W, Cout)."""
    if x.device.type == "cpu":
        return conv2d_same_small_cout_plain(x, w, bias)
    _check_shapes(x, w, bias)
    dev = x.device
    check_cuda_operand("x", x, dev, 4)
    check_cuda_operand("w", w, dev, 4)
    check_cuda_operand("bias", bias, dev, 1)
    B, H, W, cin = x.shape
    K, _, _, cout = w.shape
    y = torch.empty((B, H, W, cout), device=dev, dtype=torch.float32)
    KERNEL(dev, ptr(x), ptr(w), ptr(bias), ptr(y), B, H, W, cin, K, cout)
    return y
