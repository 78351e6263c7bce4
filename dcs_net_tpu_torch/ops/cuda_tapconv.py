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
reaches device memory. It reads x itself: the zero padding the decoder's
unified conv asks for (``pad``) is zero fill at staging, never a padded
copy. TF32 ``wgmma`` reads the weights K-major from shared memory, so a
small kernel of the same source (``PACK``) first rewrites ``w`` (taps, Cin,
N) into split, tiled, K-major form; :func:`pack_weights` is the same layout
in PyTorch. :func:`forward_plan` chooses the tiling from the shape alone:
flat multi-row tiles for images narrower than 128 columns, and where the
grid would leave the card idle (batch 1, a streaming chunk group) the tiling
and a split of the channel chunks among a cluster of blocks that adds its
partial tiles in a fixed order, by a cost model measured on the H100. The
public argument layout is unchanged. See the source for the design notes.

The forward has a bf16 class, the JAX package's ``tapconv_valid`` at bf16
operands: x and w bf16, float32 sums, y bf16, on weights packed by
``PACK_BF16`` (:func:`pack_weights_bf16`'s layout). Two bodies, chosen from
the shape alone (:func:`bf16_body`): the staged body (``KERNEL_BF16``), where
a ring of two stages fits shared memory (every 3 x 3 stage of the model):
both ``wgmma`` operands from shared memory through descriptors, the halo
tile of a 32-channel chunk staged as the K-major core-matrix image so that a
tap is a descriptor offset, flat tiles in halo coordinates
(:func:`staged_tiling`), every live tap's weights of the chunk in one stage,
a producer warpgroup filling the ring and consumer warpgroups that never
meet at a block barrier in the main loop, planned by :func:`forward_plan`
with its own cost model (``STEP_MS_BF16``); and the tap body
(``KERNEL_BF16_TAP``) for larger windows: the float32 kernel's template with
one bf16 ``wgmma`` a 16-channel step. Its plain version
:func:`tapconv_valid_bf16_plain` sums the same exact products in float32 and
rounds once. The input gradient's bf16 class (training at bf16; the JAX
``_updot_bwd`` at bf16: g cast to bf16, g Kᵀ and its overlap-add over taps
summed in float32, dx rounded once) is the same VALID correlation of g with
the flipped, transposed weights, on one of three bodies by
:func:`dgrad_body_bf16`: the narrow-reduction body (``DGRAD_NARROW_BF16``,
a reduction of at most 8 of the forward's N channels to at most 32 of its
Cin: dec6), bound by bytes: g read once through a halo tile, the taps
folded into the reduction (:func:`narrow_fold`), ``mma.sync`` on a 32-wide
N tile whose columns :func:`narrow_channel` orders so that dx leaves as
whole pixels, w read as it is; the forward's staged body on g read in
place, zero-padded by Dh - 1 - top rows before it (and so on each side),
reading the forward's own packing of w (kept by :class:`TapconvValid`, no
packing of its own) MN-major through the transpose bit, taps reversed by
index (``DGRAD_BF16``); and the tap body on weights packed flipped from w
by ``DGRAD_PACK_BF16`` (``DGRAD_BF16_TAP``, counted with the staged body;
off the model's path). Its plain version :func:`tapconv_dgrad_bf16_plain`.
The weight gradient at bf16 sums in float32 and is cast to w's type.

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
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.ops import precision
from dcs_net_tpu_torch.utils.cuda_lib import KERNELS, CudaKernel, check_cuda_operand, ptr
from dcs_net_tpu_torch.utils.device import device_cache

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "tapconv_valid", "tapconv.cu", "dcs_tapconv_valid",
    [_p, _p, _p] + [_i] * 15 + [_p])
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
# the forward's bf16 class (its staged body, and its tap body for the shapes
# the staged body does not take) and its packing
KERNEL_BF16 = CudaKernel(
    "tapconv_valid_bf16", "tapconv.cu", "dcs_tapconv_valid_bf16", KERNEL.argtypes)
KERNEL_BF16_TAP = CudaKernel(
    "tapconv_valid_bf16_tap", "tapconv.cu", "dcs_tapconv_valid_bf16_tap",
    KERNEL.argtypes)
PACK_BF16 = CudaKernel(
    "tapconv_pack_bf16", "tapconv.cu", "dcs_tapconv_pack_bf16",
    [_p, _p, _i, _i, _i, _i, _i, _p])
# the input gradient's bf16 class: the staged body on g reading the
# forward's packed weights as they are (its own entry), the tap body on g
# (counted with the staged body's) with the packing of the flipped,
# transposed weights, and the narrow-reduction body (dec6: w read as it is)
DGRAD_BF16 = CudaKernel(
    "tapconv_valid_dgrad_bf16", "tapconv.cu", "dcs_tapconv_dgrad_bf16",
    [_p, _p, _p] + [_i] * 17 + [_p])
DGRAD_BF16_TAP = CudaKernel(
    "tapconv_valid_dgrad_bf16_tap", "tapconv.cu", "dcs_tapconv_valid_bf16_tap",
    KERNEL.argtypes, counted_with=DGRAD_BF16)
DGRAD_PACK_BF16 = CudaKernel(
    "tapconv_pack_dgrad_bf16", "tapconv.cu", "dcs_tapconv_pack_dgrad_bf16",
    PACK_BF16.argtypes)
DGRAD_NARROW_BF16 = CudaKernel(
    "tapconv_valid_dgrad_narrow_bf16", "tapconv.cu", "dcs_tapconv_dgrad_narrow_bf16",
    [_p, _p, _p] + [_i] * 11 + [_p])

BK = 32     # input channels per reduction chunk of the kernel (and of the
            # bf16 class's tap body)
# the bf16 class's staged body: channels a stage (one k16 step a tap), and
# the deepest ring it takes
STAGED_KB, STAGED_MAX_STAGES = 16, 6


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


def pack_weights_bf16(w: torch.Tensor, bn: int, bk: int = BK) -> torch.Tensor:
    """w (taps, Cin, N) bf16 -> (n tiles, chunks, taps, bk/8, bn, 8): per N
    tile, ``bk``-channel chunk and tap one bf16 slab in the K-major
    core-matrix order the bf16 class copies into shared memory (8
    consecutive input channels, 16 bytes, innermost, then the output
    channel), zero beyond Cin and N: the layout ``dcs_tapconv_pack_bf16``
    writes (``bk`` 16 for the staged body, whose stage is a chunk's every
    tap, one contiguous run; 32 for the tap body)."""
    taps, cin, n = w.shape
    nt, nc = -(-n // bn), -(-cin // bk)
    wpad = F.pad(w, (0, nt * bn - n, 0, nc * bk - cin))
    return wpad.reshape(taps, nc, bk // 8, 8, nt, bn).permute(4, 1, 0, 2, 5, 3).contiguous()


def unpack_weights_bf16(wp: torch.Tensor, cin: int, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights_bf16`."""
    nt, nc, taps, bk8, bn, _ = wp.shape
    w = wp.permute(2, 1, 3, 5, 0, 4).reshape(taps, nc * 8 * bk8, nt * bn)
    return w[:, :cin, :n].contiguous()


def unpack_weights(wp: torch.Tensor, cin: int, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights`, summing hi and lo."""
    nt, nc, taps, _, bk4, bn, _ = wp.shape
    tiles = wp[:, :, :, 0] + wp[:, :, :, 1]
    w = tiles.permute(2, 1, 3, 5, 0, 4).reshape(taps, nc * 4 * bk4, nt * bn)
    return w[:, :cin, :n].contiguous()


Pad = Tuple[int, int, int, int]     # (top, bottom, left, right)


def _pads(pad: Optional[Pad]) -> Pad:
    pad = tuple(pad or (0, 0, 0, 0))
    if len(pad) != 4 or min(pad) < 0:
        raise ValueError(f"pad {pad} must be four non-negative (top, bottom, "
                         f"left, right)")
    return pad


def _out_shape(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
               pad: Optional[Pad] = None):
    """(B, HO, WO, N) of the tap conv of x zero-padded by ``pad``."""
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"expected x (B,H,W,Cin), w (Dh*Dw,Cin,N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    B, h, wd, cin = x.shape
    taps, cin_w, n = w.shape
    if taps != dh_n * dw_n or cin_w != cin:
        raise ValueError(f"w {tuple(w.shape)} does not match {dh_n}x{dw_n} "
                         f"taps over Cin {cin}")
    top, bottom, left, right = _pads(pad)
    hp, wp = h + top + bottom, wd + left + right
    ho, wo = hp - dh_n + 1, wp - dw_n + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"input {hp}x{wp} smaller than the {dh_n}x{dw_n} window")
    return B, ho, wo, n


def _pad(x: torch.Tensor, pad: Optional[Pad]) -> torch.Tensor:
    """x zero-padded by ``pad`` = (top, bottom, left, right) rows and columns:
    the plain version's input and the weight gradient's; the kernel reads x
    in place."""
    top, bottom, left, right = _pads(pad)
    if not any((top, bottom, left, right)):
        return x
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


def tapconv_valid_bf16_plain(x: torch.Tensor, w: torch.Tensor, dh_n: int,
                             dw_n: int) -> torch.Tensor:
    """Plain version of the bf16 class: the operands rounded to bf16, the
    tap sum of :func:`tapconv_valid_plain` in float32 on those values (their
    products are exact in float32), the output rounded to bf16 once."""
    b16 = torch.bfloat16
    return tapconv_valid_plain(x.to(b16).float(), w.to(b16).float(), dh_n, dw_n).to(b16)


# the forward's bf16 packing of w as the input gradient's staged body reads
# it: (the tiles of pack_weights_bf16, their N tile, their chunk)
Packing = Tuple[torch.Tensor, int, int]


def pack_bf16(w: torch.Tensor, bn: int, kb: int) -> Packing:
    """``PACK_BF16``'s launch on a CUDA w (taps, Cin, N) bf16: the tiles of
    :func:`pack_weights_bf16` at N tile ``bn`` and chunk ``kb``."""
    taps, cin, n = w.shape
    packed = torch.empty((-(-n // bn), -(-cin // kb), taps, kb // 8, bn, 8),
                         device=w.device, dtype=torch.bfloat16)
    PACK_BF16(w.device, ptr(w), ptr(packed), taps, cin, n, bn, kb)
    return packed, bn, kb


def _launch(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
            pad: Optional[Pad] = None,
            plan: Optional[Tuple[int, int, int, int]] = None,
            body: Optional[str] = None) -> torch.Tensor:
    """The packing and tap-conv launches on CUDA tensors: x (B, H, W, Cin)
    read in place as zero-padded by ``pad``, at ``plan`` = (bn, flat, wgs,
    split), by default :func:`forward_plan`'s. bf16 x and w take the bf16
    class (its packing and the body ``body`` names, by default
    :func:`bf16_body`'s), float32 the 3xTF32 one."""
    return _launch_packed(x, w, dh_n, dw_n, pad, plan, body)[0]


def _launch_packed(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                   pad: Optional[Pad] = None,
                   plan: Optional[Tuple[int, int, int, int]] = None,
                   body: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Optional[Packing]]:
    """:func:`_launch`, returning with y the bf16 class's packing of w
    (None at float32), which the input gradient reads."""
    B, ho, wo, n = _out_shape(x, w, dh_n, dw_n, pad)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    check_cuda_operand("x", x, dev, 4, dtype)
    check_cuda_operand("w", w, dev, 3, dtype)
    _, H, W, cin = x.shape
    top, _, left, _ = _pads(pad)
    if bf16:
        body = body or bf16_body(B, H, W, cin, n, dh_n, dw_n, pad)
    bn, flat, wgs, split = plan or forward_plan(B, H, W, cin, n, dh_n, dw_n, pad, dev,
                                                bf16=bf16, body=body)
    taps = dh_n * dw_n
    packing = None
    if bf16:
        kernel = KERNEL_BF16 if body == "staged" else KERNEL_BF16_TAP
        packing = pack_bf16(w, bn, STAGED_KB if body == "staged" else BK)
        packed = packing[0]
    else:
        kernel = KERNEL
        packed = torch.empty((-(-n // bn), -(-cin // BK), taps, 2, BK // 4, bn, 4),
                             device=dev, dtype=dtype)
        PACK(dev, ptr(w), ptr(packed), taps, cin, n, bn)
    y = torch.empty((B, ho, wo, n), device=dev, dtype=dtype)
    kernel(dev, ptr(x), ptr(packed), ptr(y), B, H, W, cin, ho, wo, n, dh_n, dw_n,
           top, left, flat, wgs, bn, split)
    return y, packing


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


def tapconv_dgrad_bf16_plain(g: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                             pad: Pad, hw: Tuple[int, int]) -> torch.Tensor:
    """The input gradient's bf16 class, plain: :func:`tapconv_dgrad_plain` in
    float32 on g and w rounded to bf16 (exact products), dx rounded once to
    bf16."""
    b16 = torch.bfloat16
    return tapconv_dgrad_plain(g.to(b16).float(), w.to(b16).float(), dh_n, dw_n,
                               pad, hw).to(b16).contiguous()


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


def smem_bytes(kb: int, bn: int, nsa: int, cg: int, taps: int, arows: int,
               apw: int, part_rows: int = 0, bf16: bool = False) -> int:
    """Shared memory of one block (``smem_bytes`` in the source): the B
    ring and ``nsa`` halo-tile stages of arows x apw pixels (float32: hi and
    lo slabs, 36 words a pixel; ``bf16``: one bf16 slab, 40 bf16 a pixel),
    or, where larger, the float32 partial tile of ``part_rows`` rows of a
    split; the mbarriers."""
    tps = min(taps, _taps_per_stage(kb, bn))
    nchunks = -(-cg // kb)
    nit = nchunks * -(-taps // tps)
    tapf, apitch, size = (kb * bn, kb + 8, 2) if bf16 else (2 * kb * bn, kb + 4, 4)
    ring = size * (min(nit, 3) * tps * tapf + min(nchunks, nsa) * arows * apw * apitch)
    return max(ring, 4 * part_rows * (bn + 8)) + 3 * 8


def tiling(flat: int, wgs: int, H: int, W: int, dh_n: int, dw_n: int
           ) -> Tuple[int, int, int]:
    """(M tiles per image or output row, halo rows, halo pixels a row) of an
    output H x W (``set_tiles`` in the source): a flat tile of BM = 64 * wgs
    consecutive pixels covers at most (BM + W - 2) // W + 1 rows, BM // W
    where rows divide it; a row tile BM pixels of one row."""
    bm = 64 * wgs
    if flat:
        span = bm // W if bm % W == 0 else (bm + W - 2) // W + 1
        return -(-H * W // bm), min(span, H) + dh_n - 1, W + dw_n - 1
    return -(-W // bm), dh_n, bm + dw_n - 1


def _m_tiles(B: int, H: int, W: int, dh_n: int, dw_n: int, flat: int, wgs: int) -> int:
    return B * tiling(flat, wgs, H, W, dh_n, dw_n)[0] * (1 if flat else H)


def _tile_plan(B: int, H: int, W: int, cg: int, n: int, kb: int, bn: int,
               dh_n: int, dw_n: int, sms: int, bf16: bool = False) -> Tuple[int, int]:
    """(flat, wgs) for an output (B, H, W, n) reduced over ``cg`` channels,
    from the shape alone. Images narrower than 128 columns take flat tiles
    (several rows a tile, so a 32-column image fills the 64 wgmma rows);
    wider ones one row a tile. 128-pixel tiles (two warpgroups sharing B)
    unless 64 fill the tiles' rows better (by more than a tenth), 128 would
    leave half of the card's SMs without a block, or their halo tiles do not
    fit shared memory twice."""
    taps = dh_n * dw_n

    def fits(flat, wgs, nsa):
        _, arows, apw = tiling(flat, wgs, H, W, dh_n, dw_n)
        return smem_bytes(kb, bn, nsa, cg, taps, arows, apw, bf16=bf16) <= SMEM_LIMIT

    flat = int(W < 128 and fits(1, 1, 1))
    px = H * W if flat else W

    def fill(wgs):
        bm = 64 * wgs
        return px / (bm * -(-px // bm))

    blocks2 = _m_tiles(B, H, W, dh_n, dw_n, flat, 2) * -(-n // bn)
    wide = fits(flat, 2, 2) and fill(2) >= 0.9 * fill(1) and 2 * blocks2 > sms
    return flat, 2 if wide else 1


def dgrad_plan(B: int, H: int, W: int, n: int, cin: int, dh_n: int, dw_n: int,
               sms: int = SMS) -> Tuple[int, int, int, int]:
    """(kb, bn, flat, wgs) of the input gradient at dx (B, H, W, Cin) from g's
    N channels, from the shape alone (:func:`_tile_plan`)."""
    kb, bn = dgrad_tiles(n, cin)
    return (kb, bn) + _tile_plan(B, H, W, n, cin, kb, bn, dh_n, dw_n, sms)


# The forward's time where its grid is under half a wave, as chip_smoke.py's
# sweep of kernel 3 measured it on the H100 (80GB HBM3, 700 W) at dec0-dec2
# at batch 1 and 8: about STEP_MS[wgs] for each tap and channel chunk a
# block runs (the A side's loads and splits and the wgmma instructions, not
# the weights' bytes), times the waves of clusters the grid takes. Fitted
# to the sweep's lines by tools/fit_tapconv_plan.py, on the float32 class;
# the bf16 class's tap body takes the same model.
STEP_MS = {1: 0.00094, 2: 0.00126}
# The same model for the bf16 class's staged body (every tap of a 16-channel
# chunk a step), fitted by tools/fit_tapconv_plan.py --bf16 to the smoke's
# bf16 sweep lines on the H100 (80GB HBM3, 700 W): 96 timings, median error
# 0.15.
STEP_MS_BF16 = {1: 0.00007, 2: 0.00010}
# cudaOccupancyMaxActiveClusters on the H100 at one block an SM, by cluster
# size: the figures where no card is at hand (meta tensors)
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


@device_cache(64)
def _clusters_at_once(device: torch.device, wgs: int, smem: int, split: int,
                      bf16: int = 0) -> int:
    """Clusters of ``split`` blocks at ``wgs`` warpgroups and ``smem`` bytes
    of shared memory that the card runs at once (``dcs_tapconv_clusters``;
    ``bf16``: 1 of the bf16 class's tap body, 2 of its staged body). A device
    cache: a graph's warm-up asks the library, its capture reads the answer
    from the graph's entry."""
    if device.type != "cuda":
        return H100_CLUSTERS[split]
    # through the registry: KERNEL itself may be wrapped (shape logs, tests)
    fn = KERNELS["tapconv_valid"].library_function(
        "dcs_tapconv_clusters", [_i, _i, _i, _i, ctypes.POINTER(_i)])
    out = _i(0)
    with torch.cuda.device(device):
        rc = fn(wgs, smem, split, int(bf16), ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"dcs_tapconv_clusters({wgs}, {smem}, {split}) failed: "
                           f"error {rc}, {out.value} clusters")
    return out.value


def launch_smem(bn: int, wgs: int, cin: int, taps: int, arows: int, apw: int,
                split: int, bf16: bool = False) -> int:
    """Shared memory of one forward block as the source sizes it: two halo
    stages where they fit (always at two warpgroups), else one; the partial
    tile of a split."""
    part = 64 * wgs if split > 1 else 0
    two = smem_bytes(BK, bn, 2, cin, taps, arows, apw, part, bf16)
    return two if two <= SMEM_LIMIT or wgs == 2 else smem_bytes(
        BK, bn, 1, cin, taps, arows, apw, part, bf16)


def _live_taps(flat: int, wgs: int, H: int, HO: int, WO: int, top: int,
               dh_n: int, dw_n: int) -> List[int]:
    """Taps each M tile of one image runs: the tap rows that read inside the
    input's H rows for some output row of the tile (the kernel skips the
    others), times Dw."""
    bm, hw = 64 * wgs, HO * WO
    spans = ([(q, min(q + bm, hw) - 1) for q in range(0, hw, bm)] if flat
             else [(h * WO, h * WO) for h in range(HO) for _ in range(0, WO, bm)])
    return [dw_n * max(0, min(dh_n - 1, H - 1 - (qa // WO - top))
                       - max(0, top - qb // WO) + 1) for qa, qb in spans]


def staged_tiling(flat: int, wgs: int, H: int, W: int, dh_n: int, dw_n: int
                  ) -> Tuple[int, int, int, int]:
    """(M tiles per image or output row, halo pixels a row, halo rows a
    stage's tensor copy brings, halo pixels an 8-channel plane of a stage
    holds) of the staged body for an output H x W (``staged_tiles`` in the
    source). A flat tile is BM = 64 * wgs
    consecutive positions of the image's H x pw halo grid (pw = W + Dw - 1),
    starting at any column: the copy brings min(its rows, H) + Dh - 1 rows,
    and its M rows read up to position pw - 1 + BM - 1 + (Dh - 1) pw + Dw -
    1; a row tile is BM output columns of one row (pw = BM + Dw - 1, Dh
    rows). The plane holds the larger, rounded up to 8. ``flat`` = 2 (the
    input gradient's flat tiles in planes): Dw planes a group, plane d the
    halo's columns from d on, W pixels a row (pw = W): a tile is BM
    consecutive output pixels, whose M rows read up to W - 1 + BM - 1 + (Dh
    - 1) W."""
    bm = 64 * wgs
    if flat == 2:
        tiles = -(-H * W // bm)
        arows = min((bm + W - 2) // W + 1, H) + dh_n - 1
        return tiles, W, arows, -(-max(arows * W, dh_n * W + bm - 1) // 8) * 8
    if flat:
        pw = W + dw_n - 1
        tiles = -(-((H - 1) * pw + W) // bm)
        arows = min((bm + pw - 2) // pw + 1, H) + dh_n - 1
        reach = dh_n * pw + bm + dw_n - 2
    else:
        pw = bm + dw_n - 1
        tiles, arows, reach = -(-W // bm), dh_n, dh_n * pw
    return tiles, pw, arows, -(-max(arows * pw, reach) // 8) * 8


def _staged_bars_offset(bn: int, wgs: int, taps: int, npix: int, split: int,
                        nst: int) -> int:
    ring = nst * (taps * STAGED_KB * bn * 2 + npix * STAGED_KB * 2)
    out = 64 * wgs * (bn + 8) * (4 if split > 1 else 2)
    return -(-max(ring, out) // 8) * 8


def staged_stages(bn: int, wgs: int, taps: int, npix: int, cin: int, split: int) -> int:
    """Stages of the staged body's ring (``staged_stages`` in the source): at
    most 4 and a rank's chunks, or 0 where fewer than two fit shared memory
    for a rank with more than one chunk (the body does not take it)."""
    per = -(-(-(-cin // STAGED_KB)) // split)
    for nst in range(min(STAGED_MAX_STAGES, per), 0, -1):
        if _staged_bars_offset(bn, wgs, taps, npix, split, nst) + 16 * nst <= SMEM_LIMIT:
            return nst if nst >= 2 or per == 1 else 0
    return 0


def staged_smem(bn: int, wgs: int, taps: int, npix: int, cin: int, split: int) -> int:
    """Shared memory of one staged-body block: its ring (or the output's
    staging, where larger) and 2 mbarriers a stage."""
    nst = staged_stages(bn, wgs, taps, npix, cin, split)
    return _staged_bars_offset(bn, wgs, taps, npix, split, nst) + 16 * nst


def _staged_plan(B: int, H: int, W: int, cin: int, n: int, dh_n: int, dw_n: int,
                 pad: Pad, device: torch.device, planes: bool = False
                 ) -> Optional[Tuple[int, int, int, int]]:
    """(bn, flat, wgs, split) of the bf16 class's staged body, or None where
    no tiling of it fits shared memory. Flat tiles below 128 output
    columns, 128 M rows (two consumer warpgroups sharing each stage) unless
    64 fill the tiles better by a tenth or 128 would leave half of the SMs
    idle; where the grid is under half a wave, the (flat, wgs, split) of the
    least modelled time, as :func:`forward_plan`, at ``STEP_MS_BF16`` (every
    tap runs in the staged body). ``planes``: the input gradient's, whose
    flat tiles are planes (``flat`` = 2, :func:`staged_tiling`) where the
    halo grid's tiles would leave a third of their M rows or more on halo
    columns and past the image (dec0 and dec1 of a train step: 0.50, 0.67
    live): planes take three tensor copies a channel group in place of one,
    which costs more than the dead rows elsewhere."""
    top, bottom, left, right = _pads(pad)
    HO, WO = H + top + bottom - dh_n + 1, W + left + right - dw_n + 1
    bn, nt, taps = tile_n(n), -(-n // tile_n(n)), dh_n * dw_n
    sms = _sm_count(device)

    def a_pixels(flat, wgs):
        npix = staged_tiling(flat, wgs, HO, WO, dh_n, dw_n)[3]
        return npix * (dw_n if flat == 2 else 1)

    def stages(flat, wgs, split=1):
        return staged_stages(bn, wgs, taps, a_pixels(flat, wgs), cin, split)

    flat = int(WO < 128 and stages(1, 1) > 0)
    if flat and planes and max(HO * WO / (64 * w * staged_tiling(1, w, HO, WO, dh_n, dw_n)[0])
                               for w in (1, 2)) < 2 / 3 + 1e-9 and stages(2, 1) > 0:
        flat = 2
    if stages(flat, 1) == 0:
        return None
    px = (HO * WO if flat == 2 else (HO - 1) * (WO + dw_n - 1) + WO) if flat else WO

    def fill(wgs):
        bm = 64 * wgs
        return px / (bm * -(-px // bm))

    def m_tiles(flat, wgs):
        return B * staged_tiling(flat, wgs, HO, WO, dh_n, dw_n)[0] * (1 if flat else HO)

    wgs = 2 if (stages(flat, 2) > 0 and fill(2) >= 0.9 * fill(1)
                and 2 * m_tiles(flat, 2) * nt > sms) else 1
    if 2 * m_tiles(flat, wgs) * nt > sms:
        return bn, flat, wgs, 1
    nchunks = -(-cin // STAGED_KB)
    best, plan, tiled = None, (bn, flat, wgs, 1), flat or 1
    for flat, wgs in ((0, 1), (0, 2), (tiled, 1), (tiled, 2)):
        if flat and WO >= 128:
            continue
        npix = a_pixels(flat, wgs)
        for split in (1, 2, 4, 8):
            if split > nchunks or stages(flat, wgs, split) == 0:
                break
            smem = staged_smem(bn, wgs, taps, npix, cin, split)
            waves = -(-m_tiles(flat, wgs) * nt // _clusters_at_once(device, wgs, smem, split, 2))
            key = (waves * -(-nchunks // split) * taps * STEP_MS_BF16[wgs],
                   m_tiles(flat, wgs) * wgs)
            if best is None or key < best:
                best, plan = key, (bn, flat, wgs, split)
    return plan


def bf16_body(B: int, H: int, W: int, cin: int, n: int, dh_n: int, dw_n: int,
              pad: Optional[Pad] = None) -> str:
    """The body of the bf16 class a shape takes, from the shape alone:
    ``"staged"`` for a 3 x 3 window (the one it is compiled for, every stage
    of the model's) where N > 8, Cin is a multiple of 8 (its tensor copies
    read x in 16-byte groups) and some tiling of the staged body fits shared
    memory (a ring of two stages of the 9 taps' weights and the halo tile of
    a 16-channel chunk: every stage of the model but the last), else
    ``"tap"``. At N <= 8 (dec6: 8 channels out of 32) a stage is a few
    m64n8k16 products and the block's set-up dominates: the tap body's
    m64n8 class, all taps in one stage and several blocks an SM, is the
    faster there (``chip_smoke.py`` phase "bf16" times both bodies at dec6,
    its rows ``tapconv_valid_bf16_tap*``, ``staged_ms``)."""
    if n <= 8 or cin % 8 or (dh_n, dw_n) != (3, 3):
        return "tap"
    plan = _staged_plan(B, H, W, cin, n, dh_n, dw_n, _pads(pad), torch.device("meta"))
    return "tap" if plan is None else "staged"


def forward_plan(B: int, H: int, W: int, cin: int, n: int, dh_n: int, dw_n: int,
                 pad: Pad = (0, 0, 0, 0), device: torch.device = torch.device("meta"),
                 bf16: bool = False, body: Optional[str] = None, planes: bool = False
                 ) -> Tuple[int, int, int, int]:
    """(bn, flat, wgs, split) of the forward of x (B, H, W, Cin) zero-padded
    by ``pad`` to N = ``n`` channels on ``device``, from the shape alone: the
    N tile of :func:`tile_n` and the tiling of :func:`_tile_plan`. Where that
    grid leaves more than half of the card's SMs without a block (batch 1, a
    streaming chunk group), the tiling (flat or one row, 64 or 128 pixels)
    and the split (1, 2, 4 or 8 blocks of one output tile, each with at least
    one 32-channel chunk) of the least modelled time: the taps and chunks a
    block runs at ``STEP_MS``, times the waves of clusters the card runs
    (:func:`_clusters_at_once`); of equal times, the fewer taps streamed.
    ``bf16``: the bf16 class's, of the body ``body`` names (by default
    :func:`bf16_body`'s): the staged body's by :func:`_staged_plan` (its
    flat tiles in planes for the input gradient, ``planes``), the tap
    body's as the float32 class's, sized by its shared memory."""
    if bf16 and (body or bf16_body(B, H, W, cin, n, dh_n, dw_n, pad)) == "staged":
        plan = _staged_plan(B, H, W, cin, n, dh_n, dw_n, _pads(pad), device, planes)
        if plan is None:
            raise ValueError(f"the staged body takes no tiling of x ({B}, {H}, {W}, "
                             f"{cin}) to N {n} at {dh_n}x{dw_n}")
        return plan
    top, bottom, left, right = _pads(pad)
    HO, WO = H + top + bottom - dh_n + 1, W + left + right - dw_n + 1
    bn, nt = tile_n(n), -(-n // tile_n(n))
    flat, wgs = _tile_plan(B, HO, WO, cin, n, BK, bn, dh_n, dw_n, _sm_count(device), bf16)
    if 2 * _m_tiles(B, HO, WO, dh_n, dw_n, flat, wgs) * nt > _sm_count(device):
        return bn, flat, wgs, 1
    nchunks = -(-cin // BK)
    best, plan = None, (bn, flat, wgs, 1)
    for flat, wgs in ((0, 1), (0, 2), (1, 1), (1, 2)):
        if flat and WO >= 128:
            continue
        _, arows, apw = tiling(flat, wgs, HO, WO, dh_n, dw_n)
        taps = _live_taps(flat, wgs, H, HO, WO, top, dh_n, dw_n)
        for split in (1, 2, 4, 8):
            smem = launch_smem(bn, wgs, cin, dh_n * dw_n, arows, apw, split, bf16)
            if split > nchunks or smem > SMEM_LIMIT:
                break
            waves = -(-B * len(taps) * nt // _clusters_at_once(device, wgs, smem, split,
                                                               bf16))
            key = (waves * -(-nchunks // split) * max(taps) * STEP_MS[wgs], B * sum(taps))
            if best is None or key < best:
                best, plan = key, (bn, flat, wgs, split)
    return plan


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def dgrad_pad_bf16(pad: Pad, dh_n: int, dw_n: int) -> Pad:
    """The zero padding of g under which the input gradient of the tap conv
    of x padded by ``pad`` is a forward VALID correlation giving x's pixels
    alone: Dh - 1 - top rows before, Dh - 1 - bottom after, and so for the
    columns; every pad at most the window less one."""
    top, bottom, left, right = pad
    if max(top, bottom) > dh_n - 1 or max(left, right) > dw_n - 1:
        raise ValueError(f"pad {pad} exceeds the {dh_n}x{dw_n} window less one: the "
                         "input gradient's bf16 class takes no such padding")
    return dh_n - 1 - top, dh_n - 1 - bottom, dw_n - 1 - left, dw_n - 1 - right


def dgrad_body_bf16(B: int, ho: int, wo: int, n: int, cin: int, dh_n: int, dw_n: int,
                    gpad: Pad) -> str:
    """The body of the input gradient's bf16 class for g (B, HO, WO, N) to dx
    of Cin channels under ``gpad`` (:func:`dgrad_pad_bf16`), from the shape
    alone: ``"narrow"`` (``DGRAD_NARROW_BF16``) for a 3 x 3 window reducing
    at most 8 of the forward's N channels to at most 32 of its Cin (dec6 of
    every variant: N = 4 or 8, Cin = 32); else the forward's rule
    (:func:`bf16_body`) at the transposed shape, but ``"tap"`` where the
    forward's N is at most 8 (the staged body reads the forward's packing in
    16-channel runs of its N tile, 64 or 128 wide above 8)."""
    if (dh_n, dw_n) == (3, 3) and n <= 8 and cin <= 32:
        return "narrow"
    if n <= 8:
        return "tap"
    return bf16_body(B, ho, wo, n, cin, dh_n, dw_n, gpad)


# the narrow-reduction body's fixed tiling and its tap folding, as the source
# has them (kNarrowRows, kNarrowCols, the channels a tap slot)
NARROW_ROWS, NARROW_COLS = 4, 64


def narrow_fold(n: int) -> Tuple[int, int]:
    """(C, k16 steps) of the narrow body at a reduction of ``n`` <= 8
    channels: each tap is C = 4 or 8 slots of the reduction (n zero-padded
    to C), so a k16 step carries 16 / C taps; 9 taps take ceil(9 C / 16)
    steps (36 -> 48, 72 -> 80)."""
    c = 4 if n <= 4 else 8
    return c, -(-9 * c // 16)


def narrow_channel(j: int, col: int) -> int:
    """The output channel of column ``col`` of n8 tile ``j`` of the narrow
    body's 32-wide N tile: 8 (col / 2) + 2 j + col % 2, so a thread's
    accumulators of a pixel are 8 consecutive channels."""
    return 8 * (col // 2) + 2 * j + col % 2


def _launch_dgrad_bf16(g: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                       pad: Pad, hw: Tuple[int, int],
                       packing: Optional[Packing] = None) -> torch.Tensor:
    """The input gradient's bf16 class on CUDA tensors, g (B, HO, WO, N) and
    w (Dh*Dw, Cin, N) bf16 -> dx (B, H, W, Cin) bf16, by
    :func:`dgrad_body_bf16`'s body: the narrow body on g and w as they are;
    the staged body on g read in place under :func:`dgrad_pad_bf16`'s
    padding and on the forward's packing of w, ``packing`` (from the
    forward's launch; packed here by ``PACK_BF16`` where None), at
    :func:`forward_plan`'s plan for that correlation (flat tiles in
    planes); the tap body on the flipped weights' packing
    (``DGRAD_PACK_BF16``)."""
    B, ho, wo, n = g.shape
    taps, cin, _ = w.shape
    H, W = hw
    gpad = dgrad_pad_bf16(pad, dh_n, dw_n)
    dev = g.device
    dx = torch.empty((B, H, W, cin), device=dev, dtype=torch.bfloat16)
    body = dgrad_body_bf16(B, ho, wo, n, cin, dh_n, dw_n, gpad)
    if body == "narrow":
        DGRAD_NARROW_BF16(dev, ptr(g), ptr(w), ptr(dx), B, ho, wo, n, H, W, cin, dh_n,
                          dw_n, pad[0], pad[2])
        return dx
    bn, flat, wgs, split = forward_plan(B, ho, wo, n, cin, dh_n, dw_n, gpad, dev,
                                        bf16=True, body=body, planes=True)
    if body == "staged":
        packed, bn_f, kb_f = packing or pack_bf16(w, tile_n(n), STAGED_KB)
        DGRAD_BF16(dev, ptr(g), ptr(packed), ptr(dx), B, ho, wo, n, H, W, cin, dh_n, dw_n,
                   gpad[0], gpad[2], flat, wgs, bn, split, bn_f, kb_f)
        return dx
    packed = torch.empty((-(-cin // bn), -(-n // BK), taps, BK // 8, bn, 8),
                         device=dev, dtype=torch.bfloat16)
    DGRAD_PACK_BF16(dev, ptr(w), ptr(packed), taps, cin, n, bn, BK)
    DGRAD_BF16_TAP(dev, ptr(g), ptr(packed), ptr(dx), B, ho, wo, n, H, W, cin, dh_n, dw_n,
                   gpad[0], gpad[2], flat, wgs, bn, split)
    return dx


def _launch_dgrad(g: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                  pad: Pad, hw: Tuple[int, int],
                  packing: Optional[Packing] = None) -> torch.Tensor:
    """The input gradient's packing and kernel launches on CUDA tensors:
    g (B, HO, WO, N), w (Dh*Dw, Cin, N) -> dx (B, H, W, Cin); bf16 g and w
    take the bf16 class (on the forward's ``packing`` of w where given)."""
    dev = g.device
    dtype = torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32
    check_cuda_operand("g", g, dev, 4, dtype)
    check_cuda_operand("w", w, dev, 3, dtype)
    B, ho, wo, n = g.shape
    taps, cin, n_w = w.shape
    H, W = hw
    top, bottom, left, right = pad
    if (taps != dh_n * dw_n or n_w != n or ho != H + top + bottom - dh_n + 1
            or wo != W + left + right - dw_n + 1 or min(pad) < 0):
        raise ValueError(f"g {tuple(g.shape)} and w {tuple(w.shape)} are not the "
                         f"{dh_n}x{dw_n} tap conv of a {H}x{W} input padded by {pad}")
    if dtype == torch.bfloat16:
        return _launch_dgrad_bf16(g, w, dh_n, dw_n, pad, hw, packing)
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
    innermost, then one product -> (Dh*Dw, Cin, N). bf16 x and g: float32
    sums, the result bf16 (``ops/precision.py:matmul``)."""
    cin, n = x.shape[-1], g.shape[-1]
    win = x.unfold(1, dh_n, 1).unfold(2, dw_n, 1)       # (B, HO, WO, Cin, Dh, Dw)
    q = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, dh_n * dw_n * cin)
    if x.dtype == torch.bfloat16:
        dk = precision.matmul(q.t(), g.reshape(-1, n))
    else:
        dk = q.t() @ g.reshape(-1, n)
    return dk.reshape(dh_n * dw_n, cin, n)


class TapconvValid(torch.autograd.Function):
    """Kernel 3 under autograd: forward the tap conv of x zero-padded by
    ``pad`` (x read in place), backward the JAX ``_updot_bwd`` (input
    gradient, of x's own pixels, on kernel 3's input-gradient entry, at bf16
    its bf16 class; weight gradient in PyTorch, on the padded x, in w's
    type)."""

    @staticmethod
    def forward(ctx, x, w, dh_n, dw_n, pad=None):
        ctx.save_for_backward(x, w)
        ctx.taps, ctx.pad, ctx.hw = (dh_n, dw_n), _pads(pad), x.shape[1:3]
        ctx.packing = None
        if x.device.type == "cpu":
            return tapconv_valid_plain(_pad(x, pad), w, dh_n, dw_n)
        y, ctx.packing = _launch_packed(x, w, dh_n, dw_n, pad)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dh_n, dw_n = ctx.taps
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if g.device.type == "cpu":
                dx = tapconv_dgrad_plain(g, w, dh_n, dw_n, ctx.pad, ctx.hw)
            else:
                dx = _launch_dgrad(g, w, dh_n, dw_n, ctx.pad, ctx.hw, ctx.packing)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(_pad(x, ctx.pad), g, dh_n, dw_n).to(w.dtype)
        return dx, dw, None, None, None


def tapconv_valid(x: torch.Tensor, w: torch.Tensor, dh_n: int, dw_n: int,
                  pad: Optional[Pad] = None) -> torch.Tensor:
    """x (B, H, W, Cin) zero-padded by ``pad`` = (top, bottom, left, right)
    to (B, Hp, Wp, Cin), w (Dh*Dw, Cin, N) tap-major -> y (B, HO, WO, N) with
    HO = Hp - Dh + 1, WO = Wp - Dw + 1; float32 accumulation. A CPU tensor
    takes the plain version on the padded x (plain autograd); a CUDA tensor
    :class:`TapconvValid`, whose kernel reads x in place at
    :func:`forward_plan`'s tiling. Every window whose 64-pixel halo tile
    fits shared memory, Dh * (63 + Dw) <= 931 (12 x 12 and smaller), is
    taken; beyond that the launch is refused and the call raises. Where
    autograd follows neither operand the kernel runs without the
    Function. bf16 x and w take the bf16 class in both directions (its plain
    version on the CPU, under plain autograd)."""
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return tapconv_valid_bf16_plain(_pad(x, pad), w, dh_n, dw_n)
        return tapconv_valid_plain(_pad(x, pad), w, dh_n, dw_n)
    _out_shape(x, w, dh_n, dw_n, pad)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return _launch(x, w, dh_n, dw_n, pad)
    return TapconvValid.apply(x, w, dh_n, dw_n, pad)
