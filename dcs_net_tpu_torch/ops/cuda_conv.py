"""Kernel 2 (``csrc/conv_same.cu``): the stride-1 "same" convolution with small
Cout, the CBAM spatial-attention gates built around it (complex and real), and
their plain versions.

Replaces the Pallas kernel ``dcs_net_tpu/ops/pallas_conv.py:_conv_fwd_pallas``.
On the DCS path the conv is the middle of the 13 spatial-attention gates

    pooled = [mean_c re, max_c re, mean_c im, max_c im]     (B, H, W, 4)
    a      = sigmoid(conv_same(pooled, w (7, 7, 4, 2)))      (B, H, W, 2)
    out    = x * a     (complex product, a broadcast over C) (B, H, W, C)

whose pooling and product move far more bytes than the conv computes on, so
the source has the conv alone and a pool and a gate entry for each family,
and this module a wrapper for each:

* :func:`conv2d_same_small_cout` -- the conv alone (+ bias), any odd K <= 7,
  Cout <= 16. The shape classes (K, Cin, Cout) = (7, 4, 2) and its input
  gradient's (7, 2, 4), and the real attention's (7, 2, 1) and its input
  gradient's (7, 1, 2), run a register-tiled body (a thread slides the 7
  taps over a run of R pixels held in registers); every other class runs the
  generic one-pixel-per-thread body.
* :func:`sa_pool` -- one read of x -> the pooled map.
* :func:`sa_gate` -- the (7, 4, 2) conv body with a sigmoid-and-product
  epilogue: one more read and one write of x.
* :func:`sa_pool_real`, :func:`sa_gate_real` -- the same pair for the real
  attention of DR / DRS: one plane pooled to [mean, max], the (7, 2, 1) body,
  x * sigmoid(conv) broadcast over C.

:func:`spatial_gate` and :func:`spatial_gate_real` are pool + gate, two
launches, bound by the bytes of x. The tiles of the tiled body are chosen here
(:func:`choose_tile`, :func:`gate_tile`) so that the CPU tests reach the
choice; see the source
for the design notes.

The complex pool and gate have bf16 classes (``POOL_BF16``, ``GATE_BF16``),
which :func:`sa_pool` and :func:`sa_gate` take for bf16 tensors: the JAX
package's spatial attention at ``dtype=bfloat16``, with the pooled map, the
packed kernel and x in bf16, float32 sums, the mean rounded once and the max
exact, and the conv, sigmoid and product of the gate in float32 on the
widened values, each output rounded once (:func:`sa_pool_bf16_plain`,
:func:`sa_gate_bf16_plain`). At bf16 :func:`spatial_gate` takes the fused
entry instead (``FUSED_BF16``, :func:`sa_fused_bf16`): the same function in
one launch, x read once through shared memory by two tensor copies a block,
pooled there, the 7 x 7 conv on bf16 tensor cores (``mma.sync`` m16n8k16),
the sigmoid and the product from the same tile. It takes every site of the
DC / DCS serving paths (C a multiple of 8 up to 256, a tile that fits; its
tiles :func:`fused_tile`, its launch :func:`fused_geometry`); the pair
serves only the shapes it refuses (:func:`fused_takes`).

Training at bf16 runs the un-fused gate, whose conv is the conv entry's
bf16 class (``KERNEL_BF16``): a tensor-core body at every tiled class
(``TILED_CLASSES``: the complex (7, 4, 2), (7, 2, 4) and the real (7, 2,
1), (7, 1, 2)), bf16 ``mma.sync`` m16n8k16 on a tile staged once with its
halo, N = 8 filled with output shifts (:func:`mma_class`), the B operands
built from w as it lies (:func:`mma_b_table`), x and w bf16, float32 sums,
the float32 bias added and the output rounded once to bf16
(:func:`conv2d_same_small_cout_bf16_plain`); its tiles :func:`mma_tile`,
its launch :func:`mma_geometry`. The fused gate's conv is the same body's
(7, 4, 2) instance. The input gradient is the same class on the bf16
gradient (``DGRAD_BF16``, :func:`conv2d_same_small_cout_dgrad_bf16_plain`).

The real pool and gate have bf16 classes too (``POOL_REAL_BF16``,
``GATE_REAL_BF16``), which :func:`sa_pool_real` and :func:`sa_gate_real`
take for a bf16 x: the JAX real spatial attention at ``dtype=bfloat16``
followed by ``widen.mul_bcast``, rounded where it rounds: the mean once
from float32 sums (the max exact), the conv's float32 sums to bf16, the
sigmoid of that to bf16, the product once
(:func:`sa_pool_real_bf16_plain`, :func:`sa_gate_real_bf16_plain`).

Each wrapper takes CPU tensors through the plain version and CUDA tensors
through the kernel, never falling back between the two. ``KERNEL.launches``
counts the launches of kernel 2's conv body in the forward direction: its
own entry and the complex gate entry, which runs that body with another
epilogue; ``DGRAD.launches`` counts the conv entry's launches for input
gradients; ``KERNEL_BF16.launches`` and ``DGRAD_BF16.launches`` the same
two at bf16. The real gate's two entries count on their own (``POOL_REAL``,
``GATE_REAL``, at bf16 ``POOL_REAL_BF16``, ``GATE_REAL_BF16``), so that a
DR / DRS enhance call shows them apart from the conv entry.

Gradients. On a CUDA tensor :func:`conv2d_same_small_cout` is
:class:`Conv2dSameSmallCout`, whose backward mirrors the JAX ``_bwd``
(``dcs_net_tpu/ops/pallas_conv.py:198-223``): the input gradient is the same
"same" conv of the upstream gradient with the flipped, transposed kernel,
launched on kernel 2 (for the spatial attention, Cin 2 -> Cout 4: the
register-tiled body where g is aligned to its pixel, as the forward's); the
weight gradient is one contraction over every pixel (:func:`weight_grad`)
and the bias gradient a sum, in PyTorch, as the JAX package leaves them to
XLA. At bf16 the rounding follows ``_bwd``: the upstream gradient cast to
x's type, dx in bf16 from float32 sums, dw in w's type, db in float32. On
a CPU tensor the plain version runs under plain autograd (at bf16 its
float32 sums on the bf16 values give those types). The pool
and gate entries, complex and real, are forward-only: on a CUDA tensor that
autograd follows they raise, and the attention modules' ``gate`` takes the
un-fused form instead.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.ops import cuda_tapconv
from dcs_net_tpu_torch.utils.cuda_lib import CudaKernel, check_cuda_operand, ptr
from dcs_net_tpu_torch.utils.device import device_cache

MAX_K = 7
MAX_COUT = 16
# (K, Cin, Cout) of the register-tiled body: the spatial attention's conv
# and its input gradient, complex and real
TILED_CLASSES = ((7, 4, 2), (7, 2, 4), (7, 2, 1), (7, 1, 2))
GENERIC_TILE = (0, 0, 0)         # names the generic body to the C entry
BLOCK_THREADS = 128              # NT in the source
_MAX_SMEM = 48 * 1024

Tile = Tuple[int, int, int]      # (R, TX, TY): TY rows x R * TX columns

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "conv_same_small_cout", "conv_same.cu", "dcs_conv_same_small_cout",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p])
POOL = CudaKernel("sa_pool", "conv_same.cu", "dcs_sa_pool",
                  [_p, _p, _p, _i, _i, _i, _i, _p])
GATE = CudaKernel("sa_gate", "conv_same.cu", "dcs_sa_gate",
                  [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p],
                  counted_with=KERNEL)
POOL_REAL = CudaKernel("sa_pool_real", "conv_same.cu", "dcs_sa_pool_real",
                       [_p, _p, _i, _i, _i, _i, _p])
GATE_REAL = CudaKernel("sa_gate_real", "conv_same.cu", "dcs_sa_gate_real",
                       [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p])
# the conv entry launched for an input gradient: the same C function, counted
# on its own so that a train step shows its forward and backward launches
DGRAD = CudaKernel("conv_same_small_cout_dgrad", "conv_same.cu",
                   "dcs_conv_same_small_cout", KERNEL.argtypes)
# the complex pool's and gate's bf16 classes, counted on their own: a bf16
# enhance call launches them and nothing of the float32 classes
POOL_BF16 = CudaKernel("sa_pool_bf16", "conv_same.cu", "dcs_sa_pool_bf16",
                       POOL.argtypes)
GATE_BF16 = CudaKernel("sa_gate_bf16", "conv_same.cu", "dcs_sa_gate_bf16",
                       GATE.argtypes)
# the fused bf16 gate (pool, conv, sigmoid, product in one launch), which
# serving at bf16 launches at every site it takes (:func:`fused_takes`)
FUSED_BF16 = CudaKernel("sa_fused_bf16", "conv_same.cu", "dcs_sa_fused_bf16",
                        [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p])
# the conv entry's bf16 class (training at bf16: the un-fused gate's conv)
# and its input gradient's launches, counted apart from the float32 classes
KERNEL_BF16 = CudaKernel("conv_same_small_cout_bf16", "conv_same.cu",
                         "dcs_conv_same_small_cout_bf16", KERNEL.argtypes)
DGRAD_BF16 = CudaKernel("conv_same_small_cout_dgrad_bf16", "conv_same.cu",
                        "dcs_conv_same_small_cout_bf16", KERNEL.argtypes)
# the real pool's and gate's bf16 classes, counted on their own: a bf16 DR /
# DRS enhance call launches them and nothing of the float32 classes
POOL_REAL_BF16 = CudaKernel("sa_pool_real_bf16", "conv_same.cu", "dcs_sa_pool_real_bf16",
                            POOL_REAL.argtypes)
GATE_REAL_BF16 = CudaKernel("sa_gate_real_bf16", "conv_same.cu", "dcs_sa_gate_real_bf16",
                            GATE_REAL.argtypes)
FUSED_SMEM_LIMIT = 232448        # 227 KB, a block's most on the H100 (either bf16 body)
FUSED_TILE_BYTES = 32 * 1024     # a tile's x, both planes, at most
FUSED_MIN_BLOCKS = 132           # the H100's SMs: a tile shrinks to give each a block


def applicable(kernel_size: int, cout: int) -> bool:
    """Odd K <= 7 and 1 <= Cout <= 16: the shapes kernel 2 takes."""
    return kernel_size % 2 == 1 and kernel_size <= MAX_K and 1 <= cout <= MAX_COUT


def slot(p: int, R: int) -> int:
    """Where pixel ``p`` of a staged row sits in shared memory (in pixel
    slots) for runs of R pixels: one slot of padding after every run, so that
    neighbouring threads' runs start R + 1 slots apart (an odd stride) and
    the eight threads of a quarter-warp read eight different 16-byte bank
    groups."""
    return p + p // R


def tile_pitch(tile: Tile, cin: int = 4) -> int:
    """Pixel slots a staged row of ``tile``: the last pixel's slot + 1. For
    8-byte slots (Cin = 2) a half-warp's 16 loads must fall on 16 different
    8-byte bank groups, and a half-warp spans rows where the tile is fewer
    than 16 runs wide: the pitch is padded to TX * (R + 1) mod 16, so that
    thread (tx, ty) reads slot (ty * TX + tx) * (R + 1) + j mod 16. For
    4-byte slots (Cin = 1) a warp's 32 loads are served at once: the same
    rule mod 32."""
    R, tx, _ = tile
    pitch = slot(R * tx + 6 - 1, R) + 1
    if cin == 4:
        return pitch
    banks = 32 // cin
    return pitch + (tx * (R + 1) - pitch) % banks


def tile_smem_bytes(tile: Tile, cin: int = 4, cout: int = 2) -> int:
    """Dynamic shared memory of one block: the 49 Cin Cout weights, the
    staged tile with its halo at the padded pitch (``cin`` floats a slot),
    the attention map (``cout`` floats a pixel), each in 16-byte words."""
    R, tx, ty = tile
    staged = (ty + 6) * tile_pitch(tile, cin) * cin
    return 16 * (-(-49 * cin * cout // 4) + -(-staged // 4)
                 + -(-(ty * R * tx * cout) // 4))


def tap_word_bytes(cin: int, cout: int, elem: int = 4) -> int:
    """The word in which the tiled body reads a tap's Cin * Cout weights of
    ``elem`` bytes: four weights (16 bytes in float32, 8 in bf16) at the
    complex classes (8 weights, two words), two (8 bytes, or 4) at the real
    (2)."""
    return elem * (4 if (cin * cout) % 4 == 0 else 2)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _narrowed(tile: Tile, cin: int, cout: int) -> Tile:
    """``tile`` with its width halved until it fits 48 KB of shared memory at
    class (7, Cin, Cout): one row of a very long image."""
    R, tx, ty = tile
    while tx > 1 and tile_smem_bytes((R, tx, ty), cin, cout) > _MAX_SMEM:
        tx //= 2
    return R, tx, ty


def _streaming_tile(B: int, H: int, W: int) -> Tile:
    """A block has 128 threads. The tile holds about 1/256 of the pixels,
    between 8 and 512, so that even a few thousand pixels spread over the
    card's 132 SMs (a gate streams up to 1 KB a pixel). A thread's run is
    R = 4 pixels in a tile of 256 or more and 2 below; the tile is 8 runs
    wide where it has that many, and as tall as the rest allows up to 16
    rows."""
    tile_px = _pow2_floor(min(max(B * H * W // 256, 8), 512))
    R = 4 if tile_px >= 256 else 2
    ty = min(_pow2_ceil(H), 16, max(1, tile_px // (8 * R)))
    return R, tile_px // (R * ty), ty


def gate_tile(B: int, H: int, W: int, cin: int, cout: int) -> Tile:
    """The tile of a spatial-attention gate over (B, H, W) pixels, whose
    conv is of class (7, Cin, Cout): (4, 2) for the complex gate, (2, 1) for
    the real. Both stream C channels a pixel after the conv, and take
    :func:`_streaming_tile`'s rule (``tools/time_gate``, also ``--real``)."""
    return _narrowed(_streaming_tile(B, H, W), cin, cout)


def choose_tile(B: int, H: int, W: int, cin: int, cout: int) -> Tile:
    """The conv entry's register-tiled tile for an image of class (7, Cin,
    Cout), from its shape alone.

    The complex classes, (7, 4, 2) and (7, 2, 4), take the gates' rule
    (:func:`_streaming_tile`). The real classes, (7, 2, 1) and (7, 1, 2),
    with a quarter of the operations a pixel and nothing to stream after
    it, run faster on tiles two to eight times as large (``tools/time_gate
    --real``): about 1/384 of the pixels, between 64 and 1024; R = 8 from
    1024 pixels, 4 from 256, 2 below; 4 runs wide where the image has the
    rows. A tile too wide for shared memory is narrowed."""
    if cin * cout != 2:
        return gate_tile(B, H, W, cin, cout)
    tile_px = _pow2_floor(min(max(B * H * W // 384, 64), 1024))
    R = 8 if tile_px >= 1024 else 4 if tile_px >= 256 else 2
    ty = min(_pow2_ceil(H), 16, max(1, tile_px // (4 * R)))
    return _narrowed((R, tile_px // (R * ty), ty), cin, cout)


def _check_tile(tile: Tile, cin: int = 4, cout: int = 2) -> None:
    R, tx, ty = tile
    r_ok = R in (2, 4) or (R == 8 and cin * cout == 2)
    if (not r_ok or tx < 1 or ty < 1 or tx * ty > BLOCK_THREADS
            or tile_smem_bytes(tile, cin, cout) > _MAX_SMEM):
        raise ValueError(f"tile (R, TX, TY) = {tile} at (Cin, Cout) = "
                         f"{(cin, cout)}: need R in (2, 4) (or 8 at the real "
                         f"classes), TX * TY <= {BLOCK_THREADS} and at most "
                         f"{_MAX_SMEM} bytes of shared memory")


# --- the bf16 class's tensor-core body ------------------------------------------

class MmaClass(NamedTuple):
    """The products of class (7, Cin, Cout) on ``mma.sync`` m16n8k16
    (``MmaClass`` in the source): N = 8 is Cout outputs x ``sc`` column x
    ``sr`` row shifts, n = (dy sc + s) Cout + co; M row m is tile column c0
    + sc m; K = 16 is staged pixels x Cin channels (:func:`mma_k_order`),
    ``u`` k16 steps a staged row; a staged row feeds a group of ``sr`` tile
    rows at ``d`` row offsets; the staged tile starts ``lead`` columns left
    of the tile; a product's M rows span ``span`` columns; a staged word
    holds ``px`` pixels; a product's row reads ``win`` staged pixels; a
    lane holds ``words`` B registers."""
    sc: int
    sr: int
    u: int
    d: int
    lead: int
    span: int
    px: int
    win: int
    words: int


def mma_class(cin: int, cout: int) -> MmaClass:
    """The tensor-core body's layout at class (7, Cin, Cout): (7, 4, 2) 2
    outputs x 2 column x 2 row shifts over two steps of 4 pixels x 4
    channels; (7, 2, 4) 4 outputs x 2 column shifts, one step of 8 pixels x
    2 channels; (7, 2, 1) 1 output x 2 column x 4 row shifts, the same
    step; (7, 1, 2) 2 outputs x 4 column shifts, one step of 16 pixels."""
    if (7, cin, cout) not in TILED_CLASSES:
        raise ValueError(f"(Cin, Cout) = {(cin, cout)} is no tiled class")
    sc = 4 if cin == 1 else 2
    sr = 8 // (cout * sc)
    u = 2 if cin == 4 else 1
    win = u * 16 // cin
    return MmaClass(sc, sr, u, 6 + sr, 4 if cin == 1 else 3, 16 * sc, 2 if cin == 1 else 1,
                    win, (6 + sr) * u * 2)


def mma_k_order(cin: int) -> Tuple[Tuple[int, int], ...]:
    """(staged pixel within the step, channel) of each k of a k16 step: the
    fragments give a thread k = 2 t + {0, 1} and 2 t + 8 + {0, 1}, one
    staged word: at Cin 4 pixel t's channels (0, 1) and (2, 3); at Cin 2
    pixels t and t + 4; at Cin 1 the pixel pairs 2 t and 2 t + 8."""
    if cin == 4:
        return tuple(((k % 8) // 2, k % 2 + 2 * (k // 8)) for k in range(16))
    if cin == 2:
        return tuple(((k % 8) // 2 + 4 * (k // 8), k % 2) for k in range(16))
    return tuple((k, 0) for k in range(16))


def mma_b_table(w: torch.Tensor) -> torch.Tensor:
    """The B operands (D, U, 16, 8) of the tensor-core body from w (7, 7,
    Cin, Cout) as the kernel builds them (``mma_b_taps``): [d][u][k][n] for
    a staged row d rows below a group's first tile row, step u, k = (pixel
    p, channel ci) = ``mma_k_order(Cin)[k]`` at staged pixel 4 u + p past a
    product's column (less ``lead`` - 3), n = (dy sc + s) Cout + co, output
    co of the tile pixel dy rows down and s columns right:
    w[d - dy][4 u + p - s - (lead - 3)][ci][co], 0 outside the kernel."""
    _, _, cin, cout = w.shape
    m = mma_class(cin, cout)
    b = torch.zeros((m.d, m.u, 16, 8), dtype=w.dtype, device=w.device)
    for d in range(m.d):
        for u in range(m.u):
            for k, (p, ci) in enumerate(mma_k_order(cin)):
                for n in range(8):
                    co, q = n % cout, n // cout
                    dy, s = divmod(q, m.sc)
                    kh, kw = d - dy, 4 * u + p - s - (m.lead - 3)
                    if 0 <= kh < 7 and 0 <= kw < 7:
                        b[d, u, k, n] = w[kh, kw, ci, co]
    return b


MMA_WARPS = BLOCK_THREADS // 32   # warps a block of the tensor-core body
MMA_MIN_BLOCKS = 2 * 132          # two blocks an H100 SM: the grid a 16-row tile needs


def mma_rows(th: int, tw: int, cin: int, cout: int) -> int:
    """RB, the tile rows of a warp's task: 8, halved (down to 2, or the
    class's row shifts) while the tile would leave a warp without a task."""
    m = mma_class(cin, cout)
    rb = 8
    while rb > max(2, m.sr) and -(-tw // m.span) * -(-th // rb) < MMA_WARPS:
        rb //= 2
    return rb


def mma_tile(B: int, H: int, W: int, cin: int, cout: int) -> Tile:
    """The tensor-core body's tile (TH, TW, RB) for an image of class (7,
    Cin, Cout), from its shape alone. TW: one product's span (32 columns, 64
    at Cin 1) or two, up to 64, as the width allows. TH: the image's height
    rounded up to a power of two, at most 16 where that grid has two blocks
    an SM (the 128 x 128 sites: 16 x 64 tiles, 1.5x staged per output) and
    at most 8 elsewhere: at the small sites, whose time is a launch and a
    block's round trips, 8-row tiles ran faster than tiles halved down to
    2 rows to give every SM two blocks (``tools/time_gate --dtype bfloat16
    --all-classes``'s sweep on the H100)."""
    m = mma_class(cin, cout)
    tw = m.span * max(1, min(-(-W // m.span), 64 // m.span))
    th = min(16, _pow2_ceil(H))
    if B * -(-H // th) * -(-W // tw) < MMA_MIN_BLOCKS:
        th = min(th, 8)
    return th, tw, mma_rows(th, tw, cin, cout)


class MmaGeometry(NamedTuple):
    """One launch of the tensor-core body (``MGeo`` in the source): a block
    a tile of ``th`` x ``tw`` pixels, ``rb`` tile rows a task; the staged
    tile ``th`` + 6 rows of ``pitch`` words; ``smem`` bytes of shared
    memory a block (the B table, then the staged tile); ``grid`` (W tiles,
    H tiles, B)."""
    th: int
    tw: int
    rb: int
    pitch: int
    smem: int
    grid: Tuple[int, int, int]


def mma_geometry(B: int, H: int, W: int, cin: int, cout: int,
                 tile: Optional[Tile] = None) -> MmaGeometry:
    """The launch the bf16 conv entry makes at ``tile`` (default
    :func:`mma_tile`'s), as the source computes it."""
    m = mma_class(cin, cout)
    th, tw, rb = mma_tile(B, H, W, cin, cout) if tile is None else tile
    pitch = (tw + m.win - m.sc) // m.px
    word = 8 if cin == 4 else 4
    smem = m.words * 32 * 4 + (th + 6) * pitch * word
    return MmaGeometry(th, tw, rb, pitch, smem, (-(-W // tw), -(-H // th), B))


def mma_fits(B: int, H: int, W: int, cin: int, cout: int, tile: Tile) -> bool:
    """Whether the tensor-core body takes (B, H, W) at class (7, Cin, Cout)
    on ``tile`` = (TH, TW, RB): TW a positive multiple of the span, RB 2, 4
    or 8 and a multiple of the row shifts, the grid and a block's shared
    memory within the card's limits."""
    if (7, cin, cout) not in TILED_CLASSES or len(tile) != 3:
        return False
    m = mma_class(cin, cout)
    th, tw, rb = tile
    if (min(B, H, W, th) < 1 or B > 65535 or tw < m.span or tw % m.span
            or rb not in (2, 4, 8) or rb % m.sr):
        return False
    geo = mma_geometry(B, H, W, cin, cout, tile)
    return geo.smem <= FUSED_SMEM_LIMIT and geo.grid[1] <= 65535


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


def _check_gate_shapes(pooled: torch.Tensor, w: torch.Tensor,
                       re: torch.Tensor, im: torch.Tensor) -> None:
    if re.dim() != 4 or re.shape != im.shape:
        raise ValueError(f"expected re, im (B,H,W,C) of one shape; got "
                         f"{tuple(re.shape)}, {tuple(im.shape)}")
    if tuple(pooled.shape) != tuple(re.shape[:3]) + (4,):
        raise ValueError(f"pooled is {tuple(pooled.shape)}, expected "
                         f"{tuple(re.shape[:3]) + (4,)}")
    if tuple(w.shape) != (7, 7, 4, 2):
        raise ValueError(f"the gate's packed kernel is (7, 7, 4, 2), got "
                         f"{tuple(w.shape)}")


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


def conv2d_same_small_cout_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                                      bias: torch.Tensor) -> torch.Tensor:
    """The bf16 class's plain version: :func:`conv2d_same_small_cout_plain`
    in float32 on x and w rounded to bf16 (their products are exact in
    float32) and the float32 bias, the output rounded once to bf16."""
    b16 = torch.bfloat16
    return conv2d_same_small_cout_plain(x.to(b16).float(), w.to(b16).float(),
                                        bias.float()).to(b16)


def conv2d_same_small_cout_dgrad_bf16_plain(g: torch.Tensor, w: torch.Tensor
                                            ) -> torch.Tensor:
    """The input gradient's bf16 class, plain: the JAX ``_bwd``'s dx at bf16
    (g cast to bf16, the "same" conv with the flipped, transposed kernel
    summed in float32, dx rounded once to bf16) for w (K, K, Cin, Cout) and
    g (B, H, W, Cout) -> (B, H, W, Cin)."""
    return conv2d_same_small_cout_bf16_plain(
        g, dgrad_kernel(w), torch.zeros(w.shape[2], dtype=torch.float32, device=g.device))


def launch_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                tile: Tile, dgrad: bool = False) -> torch.Tensor:
    """Launch the conv entry on CUDA tensors with the body named by ``tile``:
    ``GENERIC_TILE``, or (R, TX, TY) for the register-tiled body. ``dgrad``
    counts the launch as an input gradient's (``DGRAD``). bf16 x and w (the
    bias float32) take the bf16 class (``KERNEL_BF16``, ``DGRAD_BF16``),
    the tensor-core body at the tiled classes, whose ``tile`` is (TH, TW,
    RB) (:func:`mma_tile`; x aligned to its pixel), and give a bf16
    output."""
    _check_shapes(x, w, bias)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    check_cuda_operand("x", x, dev, 4, dtype)
    check_cuda_operand("w", w, dev, 4, dtype)
    check_cuda_operand("bias", bias, dev, 1)
    B, H, W, cin = x.shape
    K, _, _, cout = w.shape
    if bf16:
        if (K, cin, cout) not in TILED_CLASSES or not mma_fits(B, H, W, cin, cout, tile):
            raise ValueError(f"the conv entry's bf16 class takes the tensor-core body at "
                             f"(K, Cin, Cout) in {TILED_CLASSES} on a tile (TH, TW, RB) "
                             f"it fits (mma_fits), not {(K, cin, cout)} at {tile}")
        if x.data_ptr() % (2 * cin):
            raise ValueError(f"the conv entry's bf16 class reads x in {2 * cin}-byte "
                             "pixels: x is off its word")
    elif tile != GENERIC_TILE:
        if (K, cin, cout) not in TILED_CLASSES:
            raise ValueError(f"(K, Cin, Cout) = {(K, cin, cout)} has no tiled body")
        _check_tile(tile, cin, cout)
    y = torch.empty((B, H, W, cout), device=dev, dtype=dtype)
    if bf16:
        kernel = DGRAD_BF16 if dgrad else KERNEL_BF16
    else:
        kernel = DGRAD if dgrad else KERNEL
    kernel(dev, ptr(x), ptr(w), ptr(bias), ptr(y), B, H, W, cin, K, cout, *tile)
    return y


@device_cache(32)
def zero_bias(cout: int, device: torch.device) -> torch.Tensor:
    """The bias operand of a conv without bias, made once a device."""
    return torch.zeros(cout, device=device, dtype=torch.float32)


def _plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version of x's class: bf16, or float32 (float64 in the
    CPU's witness runs)."""
    if x.dtype == torch.bfloat16:
        return conv2d_same_small_cout_bf16_plain(x, w, bias)
    return conv2d_same_small_cout_plain(x, w, bias)


def _same_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               dgrad: bool = False) -> torch.Tensor:
    """The conv without autograd: the plain version on the CPU; on CUDA the
    conv entry, with the body the shape class and the alignment allow (at
    bf16 the tensor-core body on :func:`mma_tile`'s tile, whose entry
    refuses x off its pixel)."""
    if x.device.type == "cpu":
        return _plain(x, w, bias)
    _check_shapes(x, w, bias)
    B, H, W, cin = x.shape
    K, cout = w.shape[0], w.shape[-1]
    if x.dtype == torch.bfloat16:
        tiled = (K, cin, cout) in TILED_CLASSES
        return launch_conv(x, w, bias, mma_tile(B, H, W, cin, cout) if tiled
                           else GENERIC_TILE, dgrad)
    # the tiled body reads a pixel's channels as one word of 4 Cin bytes and
    # a tap's weights as words of 16 or 8 (its output is freshly allocated)
    tiled = ((K, cin, cout) in TILED_CLASSES and x.data_ptr() % (4 * cin) == 0
             and w.data_ptr() % tap_word_bytes(cin, cout) == 0)
    return launch_conv(x, w, bias, choose_tile(B, H, W, cin, cout)
                       if tiled else GENERIC_TILE, dgrad)


def _tracked(*tensors: torch.Tensor) -> bool:
    """Whether autograd follows any of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dgrad_kernel(w: torch.Tensor) -> torch.Tensor:
    """(K, K, Cin, Cout) -> (K, K, Cout, Cin): the kernel whose "same" conv
    of the upstream gradient is the input gradient (spatially flipped, input
    and output channels swapped)."""
    return torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()


def weight_grad(x: torch.Tensor, g: torch.Tensor, K: int) -> torch.Tensor:
    """dw[kh, kw, ci, co] = sum over (b, h, w) of xpad[b, h + kh, w + kw, ci]
    g[b, h, w, co]: kernel 3's weight gradient (a K x K tap correlation) of
    the zero-padded input."""
    p = K // 2
    dw = cuda_tapconv.weight_grad(F.pad(x, (0, 0, p, p, p, p)), g, K, K)
    return dw.reshape(K, K, x.shape[-1], g.shape[-1])


class Conv2dSameSmallCout(torch.autograd.Function):
    """Kernel 2 under autograd: forward the conv entry, backward the JAX
    ``_bwd`` (input gradient on kernel 2, weight and bias gradients in
    PyTorch)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return _same_conv(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _same_conv(g, dgrad_kernel(w), zero_bias(w.shape[2], g.device),
                            dgrad=True)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, g, w.shape[0]).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2), dtype=torch.float32)
        return dx, dw, db


def conv2d_same_small_cout(x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Stride-1 'same' cross-correlation (torch Conv2d, padding=K//2).
    x (B, H, W, Cin), w (K, K, Cin, Cout), bias (Cout,) -> (B, H, W, Cout),
    in x's type (bf16 x and w: the bf16 class, the bias float32). A CPU
    tensor takes the plain version (plain autograd); a CUDA tensor
    :class:`Conv2dSameSmallCout` where autograd follows an operand, else the
    kernel alone."""
    if x.device.type == "cpu":
        return _plain(x, w, bias)
    _check_shapes(x, w, bias)
    if not _tracked(x, w, bias):
        return _same_conv(x, w, bias)
    return Conv2dSameSmallCout.apply(x, w, bias)


def sa_pool_bf16_plain(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The bf16 class's plain version: :func:`sa_pool_plain` in float32 on
    the bf16 values, rounded once to bf16 (the means; the maxima are
    exact)."""
    return sa_pool_plain(re.float(), im.float()).to(torch.bfloat16)


def sa_gate_bf16_plain(pooled: torch.Tensor, w: torch.Tensor, re: torch.Tensor,
                       im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 class's plain version: :func:`sa_gate_plain` in float32 on
    the bf16 operands (w rounded to bf16), each output rounded once."""
    b16 = torch.bfloat16
    out = sa_gate_plain(pooled.float(), w.to(b16).float(), re.float(), im.float())
    return out[0].to(b16), out[1].to(b16)


def sa_pool_plain(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) re, im -> (B, H, W, 4) = [mean re, max re, mean im,
    max im] over the channels: the order in which the spatial attention's
    packed conv reads its 2 complex input channels (mean, max)."""
    return torch.cat([re.mean(dim=-1, keepdim=True), re.amax(dim=-1, keepdim=True),
                      im.mean(dim=-1, keepdim=True), im.amax(dim=-1, keepdim=True)],
                     dim=-1)


def sa_gate_plain(pooled: torch.Tensor, w: torch.Tensor, re: torch.Tensor,
                  im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re + i im) * sigmoid(conv_same(pooled, w)): the conv's two output
    channels are the attention's (a_re, a_im), broadcast over C."""
    _check_gate_shapes(pooled, w, re, im)
    a = torch.sigmoid(conv2d_same_small_cout_plain(
        pooled, w, torch.zeros(2, device=w.device, dtype=w.dtype)))
    a_re, a_im = a[..., :1], a[..., 1:]
    return re * a_re - im * a_im, re * a_im + im * a_re


def spatial_gate_plain(re: torch.Tensor, im: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spatial-attention gate as the eager sequence of its parts."""
    return sa_gate_plain(sa_pool_plain(re, im), w, re, im)


def _forward_only(entry: str, *tensors: torch.Tensor) -> None:
    """The pool and gate entries have no backward: raise where autograd
    would follow their output on the card."""
    if _tracked(*tensors):
        raise RuntimeError(
            f"{entry} is forward-only: autograd follows its inputs. Take the "
            "un-fused gate (the attention modules' gate does so under grad) "
            "or call it under torch.no_grad()")


def sa_pool(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Channel mean and max of re and im, packed (B, H, W, 4); bf16 re and
    im take the bf16 class (a bf16 map)."""
    bf16 = re.dtype == torch.bfloat16
    if re.device.type == "cpu":
        return sa_pool_bf16_plain(re, im) if bf16 else sa_pool_plain(re, im)
    _forward_only("sa_pool", re, im)
    dev, dtype = re.device, re.dtype if bf16 else torch.float32
    check_cuda_operand("re", re, dev, 4, dtype)
    check_cuda_operand("im", im, dev, 4, dtype)
    if re.shape != im.shape:
        raise ValueError(f"re {tuple(re.shape)} and im {tuple(im.shape)} differ")
    B, H, W, C = re.shape
    pooled = torch.empty((B, H, W, 4), device=dev, dtype=dtype)
    (POOL_BF16 if bf16 else POOL)(dev, ptr(re), ptr(im), ptr(pooled), B, H, W, C)
    return pooled


def sa_gate(pooled: torch.Tensor, w: torch.Tensor, re: torch.Tensor,
            im: torch.Tensor, tile: Optional[Tile] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x * sigmoid(conv_same(pooled, w)) for x = re + i im (B, H, W, C),
    pooled (B, H, W, 4), w (7, 7, 4, 2). ``tile`` defaults to
    :func:`gate_tile`'s. bf16 re and im take the bf16 class, whose pooled
    map and w are bf16 too (the module rounds its packed kernel once)."""
    bf16 = re.dtype == torch.bfloat16
    if re.device.type == "cpu":
        return (sa_gate_bf16_plain if bf16 else sa_gate_plain)(pooled, w, re, im)
    _forward_only("sa_gate", pooled, w, re, im)
    _check_gate_shapes(pooled, w, re, im)
    dev, dtype = re.device, re.dtype if bf16 else torch.float32
    for name, t in (("pooled", pooled), ("w", w), ("re", re), ("im", im)):
        check_cuda_operand(name, t, dev, 4, dtype)
    word = 8 if bf16 else 16
    if pooled.data_ptr() % word or w.data_ptr() % word:
        raise ValueError(f"pooled and w must be {word}-byte aligned")
    B, H, W, C = re.shape
    tile = gate_tile(B, H, W, 4, 2) if tile is None else tile
    _check_tile(tile, 4, 2)
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    (GATE_BF16 if bf16 else GATE)(dev, ptr(pooled), ptr(w), ptr(re), ptr(im),
                                  ptr(out_re), ptr(out_im), B, H, W, C, *tile)
    return out_re, out_im


# --- the fused bf16 gate ------------------------------------------------------

class FusedGeometry(NamedTuple):
    """One launch of the fused bf16 gate (``FGeo`` in the source): a block a
    tile of ``th`` x ``tw`` pixels of one image; its tensor copies bring a
    box of ``br`` x ``bc`` pixels (all C channels) of each plane, placed in
    the image by :func:`fused_box_origin`, as rows of ``bc`` C channels where
    that is at most 256 (``flat``) and of C channels otherwise; the pooled
    map has ``th`` + 6 rows of ``pp`` pixels; ``smem`` bytes of shared memory
    a block; ``grid`` (W tiles, H tiles, B)."""
    th: int
    tw: int
    br: int
    bc: int
    pp: int
    flat: bool
    smem: int
    grid: Tuple[int, int, int]


# the fused conv's k order within a k16 step, (pixel, channel) of each k:
# the fragments give a thread k = 2 t + {0, 1} and 2 t + 8 + {0, 1}, which
# are pooled pixel t's channels (0, 1) and (2, 3): one pixel, one 8-byte load
FUSED_K_ORDER = mma_k_order(4)


def _fused_shape(H: int, W: int, C: int, tile_px: int) -> Tile:
    """(th, tw) of a tile of about ``tile_px`` pixels. At C <= 16 the tile is
    256 / C - 6 columns wide (26 at C = 8, 10 at C = 16), so that a box row
    is at most 256 channels and one tensor copy of rows up to 512 bytes
    brings it (a copy of rows of 16 or 32 bytes, one a pixel, ran at a third
    of the card's rate); at C >= 64 it is 8 columns wide (the sweep's best at
    every such site of the model, where a site is one block's chain); rows
    the rest, a power of two. At C = 24-56 rows the largest power of two up
    to the square root, columns the rest, a power of two from 8. Rows are
    the image's height where that is at most twice as many (the C = 128
    sites, 2-8 rows high, get no halo rows); columns at most the image's
    width (rounded up to a power of two)."""
    if C <= 16 or C >= 64:
        tw = min(256 // C - 6, W) if C <= 16 else 8
        th = _pow2_floor(max(1, tile_px // tw))
        return (H if _pow2_ceil(H) <= 2 * th else th), tw
    th = _pow2_floor(math.isqrt(tile_px))
    if _pow2_ceil(H) <= 2 * th:
        th = H
    return th, min(max(8, _pow2_floor(tile_px // th)), max(8, _pow2_ceil(W)))


def fused_tile(B: int, H: int, W: int, C: int) -> Tile:
    """The fused gate's tile (th, tw) for re, im (B, H, W, C): about
    ``FUSED_TILE_BYTES`` of x (4 C bytes a pixel), 64 to 1024 pixels, halved
    down to 64 while the grid would leave an SM without a block."""
    tile_px = _pow2_floor(min(max(FUSED_TILE_BYTES // (4 * C), 64), 1024))
    while True:
        th, tw = _fused_shape(H, W, C, tile_px)
        if tile_px <= 64 or B * -(-H // th) * -(-W // tw) >= FUSED_MIN_BLOCKS:
            return th, tw
        tile_px //= 2


def fused_geometry(B: int, H: int, W: int, C: int,
                   tile: Optional[Tile] = None) -> FusedGeometry:
    """The launch that :func:`sa_fused_bf16` makes at ``tile`` (default
    :func:`fused_tile`'s), as the source computes it: the box min(th + 6, H)
    x min(tw + 6, W), the pooled map's pitch tw + 8 (two zero columns past
    the halo, which only the products' zero taps read); in shared memory
    both boxes (each rounded up to 128 bytes), the map, the attention map,
    the conv's B words (4 KB) and the mbarrier."""
    th, tw = fused_tile(B, H, W, C) if tile is None else tile
    br, bc, pp = min(th + 6, H), min(tw + 6, W), tw + 8
    box = -(-(br * bc * C * 2) // 128) * 128
    smem = 2 * box + (th + 6) * pp * 8 + th * tw * 8 + 4096 + 8
    return FusedGeometry(th, tw, br, bc, pp, bc * C <= 256, smem,
                         (-(-W // tw), -(-H // th), B))


def fused_box_origin(geo: FusedGeometry, H: int, W: int, h0: int, w0: int
                     ) -> Tuple[int, int]:
    """The image pixel at the box's corner for the tile at (h0, w0): the
    halo's corner (h0 - 3, w0 - 3), clamped so that the box lies in the
    image. The box then holds every image pixel of the tile and its halo,
    and the tensor copy never reads outside x."""
    return (min(max(h0 - 3, 0), H - geo.br), min(max(w0 - 3, 0), W - geo.bc))


def fused_fits(B: int, H: int, W: int, C: int, tile: Optional[Tile] = None) -> bool:
    """Whether the fused entry takes (B, H, W, C) at ``tile``: C a multiple
    of 8 up to 256, the box at most 256 pixels a side, a block's shared
    memory within 227 KB."""
    if (C % 8 or not 8 <= C <= 256 or min(B, H, W) < 1 or B > 65535
            or (tile is not None and min(tile) < 1)):
        return False
    geo = fused_geometry(B, H, W, C, tile)
    return (geo.br <= 256 and geo.bc <= 256 and geo.smem <= FUSED_SMEM_LIMIT
            and geo.grid[1] <= 65535)


def fused_takes(re: torch.Tensor, im: torch.Tensor) -> bool:
    """The routing of a bf16 gate: the fused entry where it takes the shape
    (:func:`fused_fits`) and x lies on 16-byte boundaries (a tensor map's
    base); PR 15's pool and gate pair otherwise."""
    return (re.dtype == torch.bfloat16 and re.dim() == 4 and re.shape == im.shape
            and fused_fits(*re.shape) and re.data_ptr() % 16 == 0
            and im.data_ptr() % 16 == 0)


def fused_b_table(w: torch.Tensor) -> torch.Tensor:
    """The fused conv's B operands (8, 2, 16, 8) from the packed kernel w (7,
    7, 4, 2): the tensor-core body's table at class (7, 4, 2)
    (:func:`mma_b_table`), [d][u][k][n] for a pooled row d rows below a pair
    of tile rows, step u, k = (pooled pixel t, channel ch) =
    ``FUSED_K_ORDER[k]`` of the pixels 4 u + t past a product's column, and
    n = 4 dy + 2 s + c, output c of the tile pixel dy rows down and s
    columns right: w[d - dy][4 u + t - s][ch][c], 0 outside the kernel."""
    if tuple(w.shape) != (7, 7, 4, 2):
        raise ValueError(f"the gate's packed kernel is (7, 7, 4, 2), got {tuple(w.shape)}")
    return mma_b_table(w)


def _check_fused_shapes(re: torch.Tensor, im: torch.Tensor, w: torch.Tensor) -> None:
    if re.dim() != 4 or re.shape != im.shape:
        raise ValueError(f"expected re, im (B,H,W,C) of one shape; got "
                         f"{tuple(re.shape)}, {tuple(im.shape)}")
    if tuple(w.shape) != (7, 7, 4, 2):
        raise ValueError(f"the gate's packed kernel is (7, 7, 4, 2), got "
                         f"{tuple(w.shape)}")


def sa_fused_bf16(re: torch.Tensor, im: torch.Tensor, w: torch.Tensor,
                  tile: Optional[Tile] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x * sigmoid(conv_same(pool(x), w)) for x = re + i im (B, H, W, C)
    bf16 and w (7, 7, 4, 2) bf16 in one launch: what
    ``sa_gate_bf16_plain(sa_pool_bf16_plain(re, im), w, re, im)`` computes,
    which is the CPU's path. ``tile`` defaults to :func:`fused_tile`'s."""
    _check_fused_shapes(re, im, w)
    if re.device.type == "cpu":
        return sa_gate_bf16_plain(sa_pool_bf16_plain(re, im), w, re, im)
    _forward_only("sa_fused_bf16", re, im, w)
    dev = re.device
    for name, t in (("re", re), ("im", im), ("w", w)):
        check_cuda_operand(name, t, dev, 4, torch.bfloat16)
    B, H, W, C = re.shape
    tile = fused_tile(B, H, W, C) if tile is None else tuple(tile)
    if not fused_fits(B, H, W, C, tile):
        raise ValueError(f"the fused bf16 gate does not take {tuple(re.shape)} at tile "
                         f"{tile}: need C % 8 == 0, 8 <= C <= 256 and "
                         f"{FUSED_SMEM_LIMIT} bytes of shared memory at most")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("re and im must be 16-byte aligned")
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    FUSED_BF16(dev, ptr(re), ptr(im), ptr(w), ptr(out_re), ptr(out_im), B, H, W, C,
               *tile)
    return out_re, out_im


def spatial_gate(re: torch.Tensor, im: torch.Tensor, w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spatial-attention gate. At bf16 the fused entry, one launch,
    where it takes the shape (:func:`fused_takes`); otherwise pool, then
    conv + sigmoid + product."""
    if fused_takes(re, im):
        return sa_fused_bf16(re, im, w)
    return sa_gate(sa_pool(re, im), w, re, im)


# --- the real attention's gate (DR / DRS) ------------------------------------

def _check_real_gate_shapes(pooled: torch.Tensor, w: torch.Tensor,
                            x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected x (B,H,W,C); got {tuple(x.shape)}")
    if tuple(pooled.shape) != tuple(x.shape[:3]) + (2,):
        raise ValueError(f"pooled is {tuple(pooled.shape)}, expected "
                         f"{tuple(x.shape[:3]) + (2,)}")
    if tuple(w.shape) != (7, 7, 2, 1):
        raise ValueError(f"the real gate's kernel is (7, 7, 2, 1), got "
                         f"{tuple(w.shape)}")


def sa_pool_real_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 2) = [mean, max] over the channels: the
    order in which the real attention's conv reads them."""
    return torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)],
                     dim=-1)


def sa_pool_real_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """The bf16 class's plain version: :func:`sa_pool_real_plain` in float32
    on the bf16 values, rounded once to bf16 (the mean; the max is
    exact)."""
    return sa_pool_real_plain(x.float()).to(torch.bfloat16)


def sa_gate_real_plain(pooled: torch.Tensor, w: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(conv_same(pooled, w)), the one-channel map broadcast over
    C."""
    _check_real_gate_shapes(pooled, w, x)
    return x * torch.sigmoid(conv2d_same_small_cout_plain(
        pooled, w, torch.zeros(1, device=w.device, dtype=w.dtype)))


def sa_gate_real_bf16_plain(pooled: torch.Tensor, w: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
    """The bf16 class's plain version, rounded where the JAX module rounds:
    the conv's float32 sums on the bf16 pooled map and w to bf16 (the conv
    entry's bf16 class), the sigmoid of that to bf16, the product with the
    bf16 x in float32 to bf16 once."""
    _check_real_gate_shapes(pooled, w, x)
    b16 = torch.bfloat16
    conv = conv2d_same_small_cout_bf16_plain(pooled, w, torch.zeros(1, device=w.device))
    a = torch.sigmoid(conv.float()).to(b16)
    return (x.float() * a.float()).to(b16)


def spatial_gate_real_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The real spatial-attention gate as the eager sequence of its parts
    (at bf16 its bf16 classes')."""
    if x.dtype == torch.bfloat16:
        return sa_gate_real_bf16_plain(sa_pool_real_bf16_plain(x), w, x)
    return sa_gate_real_plain(sa_pool_real_plain(x), w, x)


def sa_pool_real(x: torch.Tensor) -> torch.Tensor:
    """Channel mean and max of x, packed (B, H, W, 2); a bf16 x takes the
    bf16 class (a bf16 map)."""
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        return sa_pool_real_bf16_plain(x) if bf16 else sa_pool_real_plain(x)
    _forward_only("sa_pool_real", x)
    dev, dtype = x.device, x.dtype if bf16 else torch.float32
    check_cuda_operand("x", x, dev, 4, dtype)
    B, H, W, C = x.shape
    pooled = torch.empty((B, H, W, 2), device=dev, dtype=dtype)
    (POOL_REAL_BF16 if bf16 else POOL_REAL)(dev, ptr(x), ptr(pooled), B, H, W, C)
    return pooled


def sa_gate_real(pooled: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                 tile: Optional[Tile] = None) -> torch.Tensor:
    """x * sigmoid(conv_same(pooled, w)) for x (B, H, W, C), pooled (B, H, W,
    2), w (7, 7, 2, 1). ``tile`` defaults to :func:`gate_tile`'s. A bf16 x
    takes the bf16 class, whose pooled map and w are bf16 too (the module
    rounds its packed kernel once)."""
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        return (sa_gate_real_bf16_plain if bf16 else sa_gate_real_plain)(pooled, w, x)
    _forward_only("sa_gate_real", pooled, w, x)
    _check_real_gate_shapes(pooled, w, x)
    dev, dtype = x.device, x.dtype if bf16 else torch.float32
    for name, t in (("pooled", pooled), ("w", w), ("x", x)):
        check_cuda_operand(name, t, dev, 4, dtype)
    word = 4 if bf16 else 8
    if pooled.data_ptr() % word or w.data_ptr() % word:
        raise ValueError(f"pooled and w must be {word}-byte aligned")
    B, H, W, C = x.shape
    tile = gate_tile(B, H, W, 2, 1) if tile is None else tile
    _check_tile(tile, 2, 1)
    out = torch.empty_like(x)
    (GATE_REAL_BF16 if bf16 else GATE_REAL)(dev, ptr(pooled), ptr(w), ptr(x), ptr(out),
                                            B, H, W, C, *tile)
    return out


def spatial_gate_real(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The real spatial-attention gate: pool, then conv + sigmoid + product."""
    return sa_gate_real(sa_pool_real(x), w, x)
