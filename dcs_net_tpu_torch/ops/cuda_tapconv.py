"""Kernel 3: stride-1 VALID tap correlation (``csrc/tapconv.cu``) and its
plain version.

Replaces the Pallas kernel ``dcs_net_tpu/ops/pallas_tapconv.py:tapconv_valid``.
Every decoder stage of the DCS U-Net runs through it (the unified form of the
fused skip-concat + nearest-upsample + conv, ``ops/conv_engine.py``). On the
H100 it is bound by float32 operations; the kernel is an implicit GEMM that
gathers the shifted input rows into shared memory per tap and channel chunk,
so no patch tensor reaches device memory. See the source for the design notes.

:func:`tapconv_valid` takes CPU tensors through the plain version and CUDA
tensors through the kernel, never falling back between the two.
"""

from __future__ import annotations

import ctypes

import torch

from dcs_net_tpu_torch.utils.cuda_lib import CudaKernel, check_cuda_operand, ptr

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "tapconv_valid", "tapconv.cu", "dcs_tapconv_valid",
    [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p])


def _out_shape(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int):
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"expected x (B,Hp,Wp,Cin), w (Dh*Dw,Cin,N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    B, hp, wp, cin = x.shape
    taps, cin_w, n = w.shape
    if taps != dh_n * dw_n or cin_w != cin:
        raise ValueError(f"w {tuple(w.shape)} does not match {dh_n}x{dw_n} "
                         f"taps over Cin {cin}")
    ho, wo = hp - dh_n + 1, wp - dw_n + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"input {hp}x{wp} smaller than the {dh_n}x{dw_n} window")
    return B, ho, wo, n


def tapconv_valid_plain(x: torch.Tensor, w: torch.Tensor, dh_n: int,
                        dw_n: int) -> torch.Tensor:
    """Plain version: the sum over taps of shifted-slice (pixels x Cin) @
    (Cin x N) matmuls."""
    _, ho, wo, _ = _out_shape(x, w, dh_n, dw_n)
    y = None
    for dh in range(dh_n):
        for dw in range(dw_n):
            t = torch.matmul(x[:, dh:dh + ho, dw:dw + wo, :], w[dh * dw_n + dw])
            y = t if y is None else y + t
    return y


def tapconv_valid(x: torch.Tensor, w: torch.Tensor, dh_n: int,
                  dw_n: int) -> torch.Tensor:
    """x (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N) tap-major -> y (B, HO, WO, N)
    with HO = Hp - Dh + 1, WO = Wp - Dw + 1; float32 accumulation."""
    if x.device.type == "cpu":
        return tapconv_valid_plain(x, w, dh_n, dw_n)
    B, ho, wo, n = _out_shape(x, w, dh_n, dw_n)
    dev = x.device
    check_cuda_operand("x", x, dev, 4)
    check_cuda_operand("w", w, dev, 3)
    _, hp, wp, cin = x.shape
    y = torch.empty((B, ho, wo, n), device=dev, dtype=torch.float32)
    KERNEL(dev, ptr(x), ptr(w), ptr(y), B, hp, wp, cin, dh_n, dw_n, n)
    return y
