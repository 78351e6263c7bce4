"""Kernel 3: stride-1 VALID tap correlation (``csrc/tapconv.cu``) and its
plain version.

Replaces the Pallas kernel ``dcs_net_tpu/ops/pallas_tapconv.py:tapconv_valid``.
Every decoder stage of the DCS U-Net runs through it (the unified form of the
fused skip-concat + nearest-upsample + conv, ``ops/conv_engine.py``). On the
H100 it is bound by operations. The kernel is an implicit GEMM on the tensor
cores at float32 accuracy: every operand is split into a TF32 high and a TF32
low part (the weights as :func:`split_tf32` does, rounding to nearest; the
pixels by truncation, in registers) and ``lo*hi + hi*lo + hi*hi`` accumulates
in float32 through ``wgmma`` (3xTF32). A block stages its halo tile of the input
once per 32-channel chunk and runs all taps from it, so no patch tensor
reaches device memory. TF32 ``wgmma`` reads the weights K-major from shared
memory, so a small kernel of the same source (``PACK``) first rewrites
``w`` (taps, Cin, N) into split, tiled, K-major form; :func:`pack_weights` is
the same layout in PyTorch. The public argument layout is unchanged. See the
source for the design notes.

:func:`tapconv_valid` takes CPU tensors through the plain version and CUDA
tensors through the kernel, never falling back between the two.

Gradients. On a CUDA tensor :func:`tapconv_valid` is :class:`TapconvValid`,
whose backward mirrors the JAX ``_updot_bwd``
(``dcs_net_tpu/ops/conv_engine.py:850-903``). The input gradient, the
overlap-add of g Kᵀ, is itself a VALID tap correlation: of g zero-padded by
(Dh - 1, Dw - 1) on every side with the flipped, transposed weights
(:func:`dgrad_weights`, Cin' = N, N' = Cin), so it runs on kernel 3 (with its
packing launch) and comes out exactly (B, Hp, Wp, Cin). The weight gradient
Qᵀ g is one product of the patch matrix of x with g (:func:`weight_grad`),
in PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.utils.cuda_lib import CudaKernel, check_cuda_operand, ptr

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "tapconv_valid", "tapconv.cu", "dcs_tapconv_valid",
    [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p])
PACK = CudaKernel(
    "tapconv_pack", "tapconv.cu", "dcs_tapconv_pack",
    [_p, _p, _i, _i, _i, _i, _p])
# the same two C functions launched for an input gradient, counted on their own
# so that a train step shows its forward and backward launches
DGRAD = CudaKernel("tapconv_valid_dgrad", "tapconv.cu", "dcs_tapconv_valid",
                   KERNEL.argtypes)
DGRAD_PACK = CudaKernel("tapconv_pack_dgrad", "tapconv.cu", "dcs_tapconv_pack",
                        PACK.argtypes)

BK = 32     # input channels per reduction chunk of the kernel


def tile_n(n: int) -> int:
    """Width of the kernel's N tile for ``n`` output channels."""
    return 8 if n <= 8 else 64 if n <= 64 else 128


def split_tf32(t: torch.Tensor, truncate: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` -> (hi, lo), both TF32 values (low 13 mantissa bits
    zero) with hi = tf32(t), lo = tf32(t - hi). By default rounded to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` does and as the packing
    kernel splits the weights: hi + lo == t up to 2^-22 |t|. With
    ``truncate`` the low bits are dropped, as the kernel splits the pixels
    and as the tensor cores read a float32 operand: up to 2^-20 |t|."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits if truncate else bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = tf32(t)
    return hi, tf32(t - hi)


def pack_weights(w: torch.Tensor, bn: int) -> torch.Tensor:
    """w (taps, Cin, N) -> (n tiles, chunks, taps, 2, BK/4, bn, 4): per N tile
    of ``bn`` channels, 32-channel chunk and tap, the TF32 hi and lo slabs in
    the K-major order the kernel copies into shared memory (4 consecutive
    input channels innermost, then the output channel), zero beyond Cin and N."""
    taps, cin, n = w.shape
    nt, nc = -(-n // bn), -(-cin // BK)
    wpad = F.pad(w, (0, nt * bn - n, 0, nc * BK - cin))
    tiles = wpad.reshape(taps, nc, BK // 4, 4, nt, bn).permute(4, 1, 0, 2, 5, 3)
    return torch.stack(split_tf32(tiles.contiguous()), dim=3)


def unpack_weights(wp: torch.Tensor, cin: int, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights`, summing hi and lo."""
    nt, nc, taps, _, _, bn, _ = wp.shape
    tiles = wp[:, :, :, 0] + wp[:, :, :, 1]
    w = tiles.permute(2, 1, 3, 5, 0, 4).reshape(taps, nc * BK, nt * bn)
    return w[:, :cin, :n].contiguous()


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


def _launch(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
            dgrad: bool = False) -> torch.Tensor:
    """The packing and tap-conv launches on CUDA tensors; ``dgrad`` counts
    them as an input gradient's (``DGRAD_PACK``, ``DGRAD``)."""
    B, ho, wo, n = _out_shape(x, w, dh_n, dw_n)
    dev = x.device
    check_cuda_operand("x", x, dev, 4)
    check_cuda_operand("w", w, dev, 3)
    _, hp, wp, cin = x.shape
    bn = tile_n(n)
    packed = torch.empty((-(-n // bn), -(-cin // BK), dh_n * dw_n, 2, BK // 4,
                          bn, 4), device=dev, dtype=torch.float32)
    y = torch.empty((B, ho, wo, n), device=dev, dtype=torch.float32)
    pack, kernel = (DGRAD_PACK, DGRAD) if dgrad else (PACK, KERNEL)
    pack(dev, ptr(w), ptr(packed), dh_n * dw_n, cin, n, bn)
    kernel(dev, ptr(x), ptr(packed), ptr(y), B, hp, wp, cin, dh_n, dw_n, n, bn)
    return y


def _valid(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
           dgrad: bool = False) -> torch.Tensor:
    """The tap correlation without autograd: plain on the CPU, the kernel on
    CUDA."""
    if x.device.type == "cpu":
        return tapconv_valid_plain(x, w, dh_n, dw_n)
    return _launch(x, w, dh_n, dw_n, dgrad)


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """(Dh*Dw, Cin, N) -> (Dh*Dw, N, Cin): taps in reverse order (tap (dh, dw)
    becomes (Dh - 1 - dh, Dw - 1 - dw)), input and output channels swapped.
    The VALID correlation of the upstream gradient, padded by (Dh - 1,
    Dw - 1), with these weights is the input gradient."""
    return torch.flip(w, dims=(0,)).transpose(1, 2).contiguous()


def dgrad_input(g: torch.Tensor, dh_n: int, dw_n: int) -> torch.Tensor:
    """g (B, HO, WO, N) -> (B, HO + 2 (Dh - 1), WO + 2 (Dw - 1), N)."""
    return F.pad(g, (0, 0, dw_n - 1, dw_n - 1, dh_n - 1, dh_n - 1)).contiguous()


def weight_grad(x: torch.Tensor, g: torch.Tensor, dh_n: int,
                dw_n: int) -> torch.Tensor:
    """dkbig = Qᵀ g, contracted over every output pixel, with Q the
    (pixels, Dh*Dw*Cin) patch matrix of the JAX package's ``_updot_bwd``:
    the windows of x as one strided view, copied once with the channels
    innermost, then one product -> (Dh*Dw, Cin, N)."""
    cin, n = x.shape[-1], g.shape[-1]
    win = x.unfold(1, dh_n, 1).unfold(2, dw_n, 1)       # (B, HO, WO, Cin, Dh, Dw)
    q = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, dh_n * dw_n * cin)
    return (q.t() @ g.reshape(-1, n)).reshape(dh_n * dw_n, cin, n)


class TapconvValid(torch.autograd.Function):
    """Kernel 3 under autograd: forward the tap conv, backward the JAX
    ``_updot_bwd`` (input gradient on kernel 3, weight gradient in
    PyTorch)."""

    @staticmethod
    def forward(ctx, x, w, dh_n, dw_n):
        ctx.save_for_backward(x, w)
        ctx.taps = (dh_n, dw_n)
        return _valid(x, w, dh_n, dw_n)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dh_n, dw_n = ctx.taps
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _valid(dgrad_input(g, dh_n, dw_n), dgrad_weights(w), dh_n,
                        dw_n, dgrad=True)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, g, dh_n, dw_n)
        return dx, dw, None, None


def tapconv_valid(x: torch.Tensor, w: torch.Tensor, dh_n: int,
                  dw_n: int) -> torch.Tensor:
    """x (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N) tap-major -> y (B, HO, WO, N)
    with HO = Hp - Dh + 1, WO = Wp - Dw + 1; float32 accumulation. A CPU
    tensor takes the plain version (plain autograd); a CUDA tensor
    :class:`TapconvValid`. On the card the kernel picks its tile from the
    shape (128 or 64 pixels, two halo-tile stages or one) and takes every
    window whose 64-pixel halo tile fits shared memory, Dh * (63 + Dw) <= 931
    (12 x 12 and smaller); beyond that the launch is refused and the call
    raises. Where autograd follows neither operand the kernel runs without
    the Function."""
    if x.device.type == "cpu":
        return tapconv_valid_plain(x, w, dh_n, dw_n)
    _out_shape(x, w, dh_n, dw_n)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return _launch(x, w, dh_n, dw_n)
    return TapconvValid.apply(x, w, dh_n, dw_n)
