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
(``dcs_net_tpu/ops/conv_engine.py:850-903``). ``tapconv_valid`` takes the
zero padding of its input as an argument (``pad``), so the backward knows
which pixels autograd keeps. The input gradient, the overlap-add of g Kᵀ, is
a tap correlation of g with the flipped, transposed weights (Cin' = N,
N' = Cin) that the kernel's own input-gradient entry (``DGRAD``) computes
for the kept pixels only, reading g unpadded, after ``DGRAD_PACK`` has
packed the flipped weights straight from w; :func:`dgrad_plan` chooses its
tiling from the shape. :func:`dgrad_input` and :func:`dgrad_weights` (g
padded, the weights flipped, as copies) define the plain version
:func:`tapconv_dgrad_plain` and are not on the kernel's path. The weight
gradient Qᵀ g is one product of the patch matrix of the padded x with g
(:func:`weight_grad`), in PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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
# the input gradient: its own entry of the same kernel, and its packing
DGRAD = CudaKernel(
    "tapconv_valid_dgrad", "tapconv.cu", "dcs_tapconv_dgrad",
    [_p, _p, _p] + [_i] * 15 + [_p])
DGRAD_PACK = CudaKernel(
    "tapconv_pack_dgrad", "tapconv.cu", "dcs_tapconv_pack_dgrad",
    [_p, _p, _i, _i, _i, _i, _i, _p])

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


def pack_weights(w: torch.Tensor, bn: int, bk: int = BK) -> torch.Tensor:
    """w (taps, Cin, N) -> (n tiles, chunks, taps, 2, bk/4, bn, 4): per N tile
    of ``bn`` channels, ``bk``-channel chunk and tap, the TF32 hi and lo
    slabs in the K-major order the kernel copies into shared memory (4
    consecutive input channels innermost, then the output channel), zero
    beyond Cin and N."""
    taps, cin, n = w.shape
    nt, nc = -(-n // bn), -(-cin // bk)
    wpad = F.pad(w, (0, nt * bn - n, 0, nc * bk - cin))
    tiles = wpad.reshape(taps, nc, bk // 4, 4, nt, bn).permute(4, 1, 0, 2, 5, 3)
    return torch.stack(split_tf32(tiles.contiguous()), dim=3)


def unpack_weights(wp: torch.Tensor, cin: int, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights`, summing hi and lo."""
    nt, nc, taps, _, bk4, bn, _ = wp.shape
    tiles = wp[:, :, :, 0] + wp[:, :, :, 1]
    w = tiles.permute(2, 1, 3, 5, 0, 4).reshape(taps, nc * 4 * bk4, nt * bn)
    return w[:, :cin, :n].contiguous()


Pad = Tuple[int, int, int, int]     # (top, bottom, left, right)


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


def _pad(x: torch.Tensor, pad: Optional[Pad]) -> torch.Tensor:
    """x zero-padded by ``pad`` = (top, bottom, left, right) rows and columns."""
    if pad is None or not any(pad):
        return x
    if min(pad) < 0:
        raise ValueError(f"pad {pad} must not be negative")
    top, bottom, left, right = pad
    return F.pad(x, (0, 0, left, right, top, bottom)).contiguous()


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


def _launch(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int) -> torch.Tensor:
    """The packing and tap-conv launches on CUDA tensors."""
    B, ho, wo, n = _out_shape(x, w, dh_n, dw_n)
    dev = x.device
    check_cuda_operand("x", x, dev, 4)
    check_cuda_operand("w", w, dev, 3)
    _, hp, wp, cin = x.shape
    bn = tile_n(n)
    packed = torch.empty((-(-n // bn), -(-cin // BK), dh_n * dw_n, 2, BK // 4,
                          bn, 4), device=dev, dtype=torch.float32)
    y = torch.empty((B, ho, wo, n), device=dev, dtype=torch.float32)
    PACK(dev, ptr(w), ptr(packed), dh_n * dw_n, cin, n, bn)
    KERNEL(dev, ptr(x), ptr(packed), ptr(y), B, hp, wp, cin, dh_n, dw_n, n, bn)
    return y


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """(Dh*Dw, Cin, N) -> (Dh*Dw, N, Cin): taps in reverse order (tap (dh, dw)
    becomes (Dh - 1 - dh, Dw - 1 - dw)), input and output channels swapped.
    With :func:`dgrad_input` it defines the plain input gradient; the
    kernel's packing entry reads w in this order without the copy."""
    return torch.flip(w, dims=(0,)).transpose(1, 2).contiguous()


def dgrad_input(g: torch.Tensor, dh_n: int, dw_n: int) -> torch.Tensor:
    """g (B, HO, WO, N) -> (B, HO + 2 (Dh - 1), WO + 2 (Dw - 1), N), zero
    padded: the input of the plain input gradient (the kernel reads g in
    place)."""
    return F.pad(g, (0, 0, dw_n - 1, dw_n - 1, dh_n - 1, dh_n - 1)).contiguous()


def tapconv_dgrad_plain(g: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                        pad: Pad, hw: Tuple[int, int]) -> torch.Tensor:
    """The input gradient of ``tapconv_valid(x, w, dh_n, dw_n, pad)`` for x
    of H x W = ``hw``: the VALID correlation of g padded by (Dh - 1, Dw - 1)
    with the flipped, transposed weights is the gradient of the padded x;
    its interior, (B, H, W, Cin), is x's."""
    top, _, left, _ = pad
    dxp = tapconv_valid_plain(dgrad_input(g, dh_n, dw_n), dgrad_weights(w), dh_n, dw_n)
    return dxp[:, top:top + hw[0], left:left + hw[1]]


def dgrad_tiles(n: int, cin: int) -> Tuple[int, int]:
    """(channels per reduction chunk, N tile) of the input gradient, whose
    reduction runs over the forward's N and whose outputs are its Cin: 8 and
    32 for at most 8 and 32 (dec6's class: one k8 step a tap, no padding of
    K to 32 or of N to 64), else 32 and the smallest of 32, 64, 128 that
    holds Cin."""
    if n <= 8 and cin <= 32:
        return 8, 32
    return BK, 32 if cin <= 32 else 64 if cin <= 64 else 128


SMEM_LIMIT = 227 * 1024
SMS = 132       # the H100's SMs, where no card is at hand (meta tensors)


def _taps_per_stage(kb: int, bn: int) -> int:
    return 9 if bn == 8 or kb == 8 else 128 // bn


def dgrad_smem_bytes(kb: int, bn: int, nsa: int, cg: int, taps: int,
                     arows: int, apw: int) -> int:
    """Shared memory of one block (``smem_bytes`` in the source): the B
    ring, ``nsa`` halo-tile stages of arows x apw pixels, the mbarriers."""
    tps = min(taps, _taps_per_stage(kb, bn))
    nchunks = -(-cg // kb)
    nit = nchunks * -(-taps // tps)
    words = (min(nit, 3) * tps * 2 * kb * bn
             + min(nchunks, nsa) * arows * apw * (kb + 4))
    return 4 * words + 3 * 8


def dgrad_tiling(flat: int, wgs: int, H: int, W: int, dh_n: int, dw_n: int
                 ) -> Tuple[int, int, int]:
    """(M tiles per image or output row, halo rows, halo pixels a row) of the
    input-gradient entry (``set_tiles`` in the source): a flat tile of BM =
    64 * wgs consecutive pixels covers at most (BM + W - 2) // W + 1 rows,
    BM // W where rows divide it; a row tile BM pixels of one row."""
    bm = 64 * wgs
    if flat:
        span = bm // W if bm % W == 0 else (bm + W - 2) // W + 1
        return -(-H * W // bm), min(span, H) + dh_n - 1, W + dw_n - 1
    return -(-W // bm), dh_n, bm + dw_n - 1


def dgrad_plan(B: int, H: int, W: int, n: int, cin: int, dh_n: int, dw_n: int,
               sms: int = SMS) -> Tuple[int, int, int, int]:
    """(kb, bn, flat, wgs) of the input gradient at dx (B, H, W, Cin) from g's
    N channels, from the shape alone. Images narrower than 128 columns take
    flat tiles (several rows a tile, so a 32-column image fills the 64 wgmma
    rows); wider ones one row a tile, as the forward. 128-pixel tiles (two
    warpgroups sharing B) unless 64 fill the tiles' rows better (by more than
    a tenth), 128 would leave half of the card's SMs without a block, or
    their halo tiles do not fit shared memory twice."""
    kb, bn = dgrad_tiles(n, cin)
    taps = dh_n * dw_n

    def fits(flat, wgs, nsa):
        _, arows, apw = dgrad_tiling(flat, wgs, H, W, dh_n, dw_n)
        return dgrad_smem_bytes(kb, bn, nsa, n, taps, arows, apw) <= SMEM_LIMIT

    flat = int(W < 128 and fits(1, 1, 1))
    px = H * W if flat else W

    def fill(wgs):
        bm = 64 * wgs
        return px / (bm * -(-px // bm))

    tiles2 = dgrad_tiling(flat, 2, H, W, dh_n, dw_n)[0]
    blocks2 = B * tiles2 * (1 if flat else H) * -(-cin // bn)
    wide = fits(flat, 2, 2) and fill(2) >= 0.9 * fill(1) and 2 * blocks2 > sms
    return kb, bn, flat, 2 if wide else 1


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_dgrad(g: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                  pad: Pad, hw: Tuple[int, int]) -> torch.Tensor:
    """The input gradient's packing and kernel launches on CUDA tensors:
    g (B, HO, WO, N), w (Dh*Dw, Cin, N) -> dx (B, H, W, Cin)."""
    dev = g.device
    check_cuda_operand("g", g, dev, 4)
    check_cuda_operand("w", w, dev, 3)
    B, ho, wo, n = g.shape
    taps, cin, n_w = w.shape
    H, W = hw
    top, bottom, left, right = pad
    if (taps != dh_n * dw_n or n_w != n or ho != H + top + bottom - dh_n + 1
            or wo != W + left + right - dw_n + 1 or min(pad) < 0):
        raise ValueError(f"g {tuple(g.shape)} and w {tuple(w.shape)} are not the "
                         f"{dh_n}x{dw_n} tap conv of a {H}x{W} input padded by {pad}")
    kb, bn, flat, wgs = dgrad_plan(B, H, W, n, cin, dh_n, dw_n, _sm_count(dev))
    packed = torch.empty((-(-cin // bn), -(-n // kb), taps, 2, kb // 4, bn, 4),
                         device=dev, dtype=torch.float32)
    dx = torch.empty((B, H, W, cin), device=dev, dtype=torch.float32)
    DGRAD_PACK(dev, ptr(w), ptr(packed), taps, cin, n, kb, bn)
    DGRAD(dev, ptr(g), ptr(packed), ptr(dx), B, ho, wo, n, H, W, cin, dh_n, dw_n,
          top, left, flat, wgs, kb, bn)
    return dx


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
    """Kernel 3 under autograd: forward the tap conv of x zero-padded by
    ``pad``, backward the JAX ``_updot_bwd`` (input gradient, of x's own
    pixels, on kernel 3's input-gradient entry; weight gradient in
    PyTorch)."""

    @staticmethod
    def forward(ctx, x, w, dh_n, dw_n, pad=None):
        xp = _pad(x, pad)
        ctx.save_for_backward(xp, w)
        ctx.taps, ctx.pad, ctx.hw = (dh_n, dw_n), tuple(pad or (0, 0, 0, 0)), x.shape[1:3]
        if x.device.type == "cpu":
            return tapconv_valid_plain(xp, w, dh_n, dw_n)
        return _launch(xp, w, dh_n, dw_n)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        dh_n, dw_n = ctx.taps
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if g.device.type == "cpu":
                dx = tapconv_dgrad_plain(g, w, dh_n, dw_n, ctx.pad, ctx.hw)
            else:
                dx = _launch_dgrad(g, w, dh_n, dw_n, ctx.pad, ctx.hw)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(xp, g, dh_n, dw_n)
        return dx, dw, None, None, None


def tapconv_valid(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                  pad: Optional[Pad] = None) -> torch.Tensor:
    """x (B, H, W, Cin) zero-padded by ``pad`` = (top, bottom, left, right)
    to (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N) tap-major -> y (B, HO, WO, N) with
    HO = Hp - Dh + 1, WO = Wp - Dw + 1; float32 accumulation. A CPU tensor
    takes the plain version (plain autograd); a CUDA tensor
    :class:`TapconvValid`. On the card the kernel picks its tile from the
    shape (128 or 64 pixels, two halo-tile stages or one) and takes every
    window whose 64-pixel halo tile fits shared memory, Dh * (63 + Dw) <= 931
    (12 x 12 and smaller); beyond that the launch is refused and the call
    raises. Where autograd follows neither operand the kernel runs without
    the Function."""
    xp = _pad(x, pad)
    if x.device.type == "cpu":
        return tapconv_valid_plain(xp, w, dh_n, dw_n)
    _out_shape(xp, w, dh_n, dw_n)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return _launch(xp, w, dh_n, dw_n)
    return TapconvValid.apply(x, w, dh_n, dw_n, pad)
