"""Kernel 1: the fused STFT front end (``csrc/stft.cu``) and its plain version.

Replaces the Pallas kernel ``dcs_net_tpu/dsp/stft_pallas.py:_forward``. On the
H100 the function is bound by bytes (~17.4 MB for a batch of four 4 s
utterances, nearly all of it the output). The source has two entry points,
and :func:`choose_entry` picks one from the shape alone:

* the FFT entry (``KERNEL``), for every even ``n_fft`` from 16 to 2048 whose
  half has no prime factor above 7 (the radices cuFFT has natively), at
  ``0 < hop <= n_fft``: each frame's windowed real DFT as a complex FFT of
  ``n_fft/2`` points in in-register stages of radix <= 16
  (:func:`fft_radices`: at most three stages, four for 625 and 875 points)
  plus the real-input split step, written straight to (B, F, T). It takes
  the window, one twiddle table per stage boundary, the split twiddles and
  the row of each FFT output in the shared tile as small tables
  (:func:`fft_tables`, computed in float64). n_fft 512, the model's size,
  runs its compiled two-stage instantiation (:data:`FFT_COMPILED`), every
  other size one kernel whose stage radices are runtime switches over the
  codelets;
* the dense entry (``KERNEL_DENSE``), for the rest (odd ``n_fft``, a half
  with a prime factor of 11 or more, ``n_fft`` above 2048, ``hop`` above
  ``n_fft``): the frames times the folded (n_fft, 2F) cos/sin basis as an
  implicit GEMM on the tensor cores (``wgmma``) at float32 accuracy
  (3xTF32), the basis packed and split into TF32 parts by
  :func:`dense_basis`, the reduction split over a cluster
  where the grid is under a wave (:func:`dense_split`, from the blocks an
  SM the card reports, :func:`blocks_per_sm`);
* the dense entry's bf16 class, for every size at ``dft_dtype="bfloat16"``:
  the JAX package's function at that type, the frames and the folded basis
  rounded to bf16 (the basis once, on the host) into float32 sums and a
  float32 output. Two bodies, by shape (:func:`choose_entry`): the span body
  (``KERNEL_DENSE_BF16``) where ``hop`` is a multiple of 16 and a column
  block's basis fits shared memory (the model's 512 / 32): a block stages
  its frames' sample span once as rows of ``hop`` bf16 samples, so the
  frames are ``ceil(n_fft / hop)`` shifted views of it that ``wgmma`` reads
  through descriptors, against the column block's basis
  (:func:`span_basis_bf16`) resident in shared memory, each block walking
  several tiles of frames (:func:`span_plan`); and the chunked body
  (``KERNEL_DENSE_BF16_CHUNKED``) for the rest: the dense entry's kernel
  with one bf16 ``wgmma`` where 3xTF32 takes three, on
  :func:`dense_basis_bf16`.

:func:`stft_analysis` is the one entry: it takes a tensor on the CPU through
:func:`stft_dft_plain` (reflect pad, framing, two matmuls) and a CUDA tensor
through the entry :func:`choose_entry` names, and never falls back from one
to the other or to the plain version. A plan made at bf16 (``STFTPlan.bf16``)
takes the bf16 class on the card and :func:`stft_dft_plain` on the rounded
samples and basis on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.utils.cuda_lib import KERNELS, CudaKernel, check_cuda_operand, ptr

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "stft", "stft.cu", "dcs_stft_fft",
    [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
     _p])
KERNEL_DENSE = CudaKernel(
    "stft_dense", "stft.cu", "dcs_stft_forward",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p])
KERNEL_DENSE_BF16 = CudaKernel(
    "stft_dense_bf16", "stft.cu", "dcs_stft_forward_bf16",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p])
KERNEL_DENSE_BF16_CHUNKED = CudaKernel(
    "stft_dense_bf16_chunked", "stft.cu", "dcs_stft_forward_bf16_chunked",
    KERNEL_DENSE.argtypes)

# the in-register DFT sizes of csrc/stft.cu (dft_any<R>)
CODELETS = (3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16)
FFT_MAX_STAGES = 4
FFT_N_FFT_RANGE = (16, 2048)
# the n_fft of the compiled two-stage instantiation stft_fft_kernel<16, 16>
# (the enhance and train paths'); its plan is (16, 16)
FFT_COMPILED = 512
# the mixed kernel's frames per block (one FFT row a lane group)
FFT_TILE_FRAMES = (32, 16, 8)
SMEM_LIMIT = 227 * 1024
H100_SMS = 132
# the dense entry's tiles (csrc/stft.cu: DM frames x 2 DB basis columns, DK
# samples a reduction chunk), its largest cluster, its shared memory (two
# stages of a chunk's hi and lo basis slabs and frames), and the blocks an
# H100's SM holds at once, for plans made without a card (the card's own
# count is :func:`blocks_per_sm`)
DENSE_FRAMES, DENSE_BINS, DENSE_CHUNK, DENSE_MAX_SPLIT = 64, 32, 32, 8
DENSE_SMEM = 4 * 2 * (2 * DENSE_CHUNK * 2 * DENSE_BINS + DENSE_FRAMES * (DENSE_CHUNK + 4))
# the bf16 class's chunked body: one bf16 slab a chunk in place of the hi
# and lo ones
DENSE_SMEM_BF16 = 4 * 2 * (DENSE_CHUNK * DENSE_BINS + DENSE_FRAMES * (DENSE_CHUNK + 4))
DENSE_RESIDENT = 4
# the bf16 class's span body: the frames of a tile (its instantiations,
# largest first), the k16 step its hop must be a multiple of, and the share
# of the SMs its tiles should give a block
SPAN_FRAMES = (128, 64, 32)
SPAN_HOP_STEP = 16
SPAN_FILL = 0.7


@functools.lru_cache(maxsize=None)
def fft_radices(n_fft: int) -> Optional[Tuple[int, ...]]:
    """The FFT entry's stage plan for ``n_fft``: radices from
    :data:`CODELETS` whose product is ``n_fft / 2``, first stage first, or
    None where the FFT entry does not take the size. The fewest stages win,
    then the smallest largest radix, then the smaller tuple in descending
    order (200 = 8 x 5 x 5, 1024 = 16 x 8 x 8, 256 = 16 x 16)."""
    lo, hi = FFT_N_FFT_RANGE
    if n_fft % 2 or not lo <= n_fft <= hi:
        return None
    plans = []

    def factor(rest, prefix):
        if rest == 1:
            plans.append(tuple(prefix))
        elif len(prefix) < FFT_MAX_STAGES:
            for r in CODELETS:
                if r <= (prefix[-1] if prefix else 16) and rest % r == 0:
                    factor(rest // r, prefix + [r])

    factor(n_fft // 2, [])
    return min(plans, key=lambda p: (len(p), p)) if plans else None


def span_taps(n_fft: int, hop: int) -> int:
    """Rows of ``hop`` samples a frame spans in the span body: the taps of its
    correlation, ``ceil(n_fft / hop)`` (basis rows past n_fft are zero)."""
    return -(-n_fft // hop)


def span_smem_bytes(n_fft: int, hop: int, frames: int) -> int:
    """Shared memory of one span-body block with tiles of ``frames`` frames
    (``span_smem_bytes`` in the source): the column block's basis (taps *
    hop rows of 64 bf16), two span images (frames + taps - 1 rows of hop
    bf16), two float32 output tiles (64 rows of frames + 8 words), two
    float32 raw spans and the mbarriers (one a tap, ten for the rings)."""
    taps = span_taps(n_fft, hop)
    return (taps * hop * 128 + 2 * (frames + taps - 1) * hop * 2
            + 2 * 64 * (frames + 8) * 4 + 2 * (frames + taps - 1) * hop * 4
            + 8 * (taps + 10))


def choose_entry(n_fft: int, hop: int, dft_dtype: str = "float32") -> str:
    """``"fft"``, ``"dense"``, ``"dense_bf16"`` or ``"dense_bf16_chunked"``:
    which entry point (at bf16, which body of the dense entry's bf16 class) a
    CUDA tensor takes, from the shape and the operand type alone. At bfloat16
    the span body takes every hop that is a multiple of 16 whose smallest
    block fits shared memory, the chunked body every other size."""
    if dft_dtype == "bfloat16":
        fits = span_smem_bytes(n_fft, hop, SPAN_FRAMES[-1]) <= SMEM_LIMIT
        return "dense_bf16" if hop % SPAN_HOP_STEP == 0 and fits else "dense_bf16_chunked"
    return "fft" if fft_radices(n_fft) is not None and 0 < hop <= n_fft else "dense"


def span_plan(n_fft: int, hop: int, n_bins: int, batch: int, n_frames: int,
              sms: int = H100_SMS) -> Tuple[int, int]:
    """(frames, groups) of the span body: one block an SM, ``groups`` blocks
    a (batch row, column block) each walking every groups-th tile (its
    basis loaded once), with tiles of the most of :data:`SPAN_FRAMES` frames
    whose block fits shared memory and whose tiles give at least
    :data:`SPAN_FILL` of the SMs a block, else the fewest that fit. The
    smoke's sweep of (frames, groups) at the serving shapes (phase "bf16",
    lines ``kernel stft_dense_bf16 sweep:``) found these fastest on the
    H100: a block's set-up (the basis) is paid once, and a tile's products,
    the next one's span and the last one's stores overlap."""
    fit = [f for f in SPAN_FRAMES if span_smem_bytes(n_fft, hop, f) <= SMEM_LIMIT]
    rows = batch * -(-n_bins // DENSE_BINS)
    frames = next((f for f in fit if rows * -(-n_frames // f) >= SPAN_FILL * sms), fit[-1])
    return frames, max(1, min(-(-n_frames // frames), sms // rows))


def _skewed_words(span: int) -> int:
    return span + (span - 1) // 32


def fft_twiddles(radices: Tuple[int, ...]) -> int:
    """Twiddles in the FFT entry's ``tw`` table: a (Qs, Rs) block for every
    stage but the last."""
    return sum(r * math.prod(radices[s + 1:]) for s, r in enumerate(radices[:-1]))


def fft_smem_bytes(n_fft: int, hop: int, ft: int) -> int:
    """Shared memory of one block of the mixed kernel owning ``ft`` frames:
    the (n_fft/2, ft) complex tile, its tables and the skewed sample span
    (as ``csrc/stft.cu:launch_mixed``)."""
    n2 = n_fft // 2
    return (8 * (n2 * ft + 2 * n2 + 1 + fft_twiddles(fft_radices(n_fft))) + 4 * n2
            + 4 * _skewed_words(hop * (ft - 1) + n_fft))


def fft_tile_frames(n_fft: int, hop: int, batch: int, n_frames: int) -> int:
    """Frames a block of the FFT entry owns. The compiled size keeps its
    32. The mixed kernel takes the most of 32, 16 and 8 whose block fits
    shared memory and whose grid still gives every SM two blocks, else 8 (the
    smallest block: a grid under a wave is latency-bound, and halving the
    frames halves a block's work)."""
    if n_fft == FFT_COMPILED:
        return 32
    for ft in FFT_TILE_FRAMES:
        if (fft_smem_bytes(n_fft, hop, ft) <= SMEM_LIMIT
                and batch * -(-n_frames // ft) >= 2 * H100_SMS):
            return ft
    return FFT_TILE_FRAMES[-1]


def fft_rows(radices: Tuple[int, ...]) -> np.ndarray:
    """Row of the shared tile that holds FFT output k, for k < n_fft/2. The
    stages after the first run in place, so output k = k1 + R1 k2 + R1 R2 k3
    + ... lies at row k1 + R1 (Q2 k2 + ... + QS kS), Qs being the product of
    the radices after stage s (the identity for one or two stages)."""
    k = np.arange(math.prod(radices))
    row = k % radices[0]
    for s in range(1, len(radices)):
        digit = (k // math.prod(radices[:s])) % radices[s]
        row = row + radices[0] * math.prod(radices[s + 1:]) * digit
    return row.astype(np.int32)


def fft_tables(window: np.ndarray) -> Optional[Tuple[np.ndarray, ...]]:
    """The FFT entry's tables for an analysis window of ``n_fft`` points
    (scale folded in), computed in float64 and rounded once, or None where
    the FFT entry does not take the size. Twiddles are (cos, -sin) pairs:

    * ``win2`` (n_fft/2, 2): (w[2n], w[2n+1]) / 2, the packing of the real
      frame into complex points with the split step's halves folded in;
    * ``tw`` (sum of Qs Rs over the stages but the last, 2): for each stage
      s before the last, the (Qs, Rs) block exp(-2 pi i q ks / (Rs Qs));
    * ``sp`` (n_fft/2 + 1, 2): exp(-2 pi i k / n_fft), the split step's;
    * ``rows`` (n_fft/2,) int32: :func:`fft_rows`, which the compiled
      size does not read (its rows are the identity)."""
    n_fft = window.shape[0]
    radices = fft_radices(n_fft)
    if radices is None:
        return None
    n2 = n_fft // 2
    win2 = 0.5 * np.asarray(window, np.float64).reshape(n2, 2)
    blocks = []
    for s in range(len(radices) - 1):
        r, q = radices[s], math.prod(radices[s + 1:])
        ang = -2.0 * np.pi * np.outer(np.arange(q), np.arange(r)) / (r * q)
        blocks.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1, 2))
    tw = np.concatenate(blocks) if blocks else np.zeros((0, 2))
    ang = -2.0 * np.pi * np.arange(n2 + 1) / n_fft
    sp = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return (*(np.ascontiguousarray(a, np.float32) for a in (win2, tw, sp)),
            fft_rows(radices))


def root_values(r: int) -> np.ndarray:
    """(r, 2) float32: cos and sin of 2 pi m / r for m < r, rounded once from
    float64, the float64 residue of an exact zero (~1e-16) snapped to 0."""
    ang = 2.0 * np.pi * np.arange(r) / r
    v = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return np.where(np.abs(v) < 1e-12, 0.0, v).astype(np.float32)


def root_cases_source() -> str:
    """The cases of ``root_entry`` in ``csrc/stft.cu`` as C source: entry
    ``i`` of :func:`root_values` of every codelet size that is no power of
    two, one line a size, in :data:`CODELETS` order, each float32 printed
    in the fewest digits that read back to it."""
    def lit(v):
        return np.format_float_positional(v, unique=True) + "f"

    lines, i = [], 0
    for r in (c for c in CODELETS if c & (c - 1)):
        cases = []
        for c, sn in root_values(r):
            cases.append(f"case {i}: return {{{lit(c)}, {lit(sn)}}};")
            i += 1
        lines.append(f"    /* {r} */ " + " ".join(cases))
    return "\n".join(lines)


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits), nearest with ties
    away from zero, on the bits, as ``cvt.rna.tf32.f32`` does."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def dense_basis(cos_b: np.ndarray, sin_b: np.ndarray) -> np.ndarray:
    """The dense entry's basis, packed for it. The folded (n_fft, F) cos and
    sin bases become one (Kp, 2 Fp) float32 matrix B, Kp = n_fft and Fp = F
    rounded up to 32 with zeros, each 64-column block the cos then the sin
    of 32 bins (the columns one block of the kernel owns), split for 3xTF32
    into hi = TF32(B) and lo = TF32(B - hi). Returned as (Fp/32, Kp/32, 2,
    8, 64, 4): for column block j and chunk c of 32 rows, the hi then the lo
    slab, element (k, n) of a slab at [k // 4, n, k % 4], the shared-memory
    image of the K-major core-matrix layout ``wgmma`` reads, so one chunk's
    basis is one contiguous copy."""
    k, f = cos_b.shape
    kp, fp = -(-k // DENSE_CHUNK) * DENSE_CHUNK, -(-f // DENSE_BINS) * DENSE_BINS
    out = np.zeros((kp, fp // DENSE_BINS, 2, DENSE_BINS), np.float64)
    for j, b in enumerate((cos_b, sin_b)):
        out[:k, :, j, :] = np.pad(np.asarray(b, np.float64), ((0, 0), (0, fp - f))
                                  ).reshape(k, fp // DENSE_BINS, DENSE_BINS)
    v = out.reshape(kp, 2 * fp).astype(np.float32)
    hi = tf32_round(v)
    parts = np.stack([hi, tf32_round(v - hi)])        # (2, Kp, 2 Fp)
    # (part, chunk, k // 4 in it, k % 4, column block, n) -> the slabs
    parts = parts.reshape(2, kp // DENSE_CHUNK, DENSE_CHUNK // 4, 4, fp // DENSE_BINS,
                          2 * DENSE_BINS)
    return np.ascontiguousarray(parts.transpose(4, 1, 0, 2, 5, 3))


def bf16_round(a: np.ndarray) -> torch.Tensor:
    """float32 ``a`` rounded to bf16 (nearest even, as ``.to(torch.bfloat16)``
    and ``jnp.asarray(a, jnp.bfloat16)`` round), as a bf16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def dense_basis_bf16(cos_b: np.ndarray, sin_b: np.ndarray,
                     rows: Optional[int] = None) -> torch.Tensor:
    """The dense entry's bf16 basis: the folded float32 (n_fft, F) cos and sin
    bases rounded once to bf16 (the JAX package's float64 fold -> float32
    -> bf16), as one (Kp, 2 Fp) matrix laid out as :func:`dense_basis` lays
    it, without the split. Returned as (Fp/32, Kp/32, 4, 64, 8) bf16: for
    column block j and chunk c of 32 rows, element (k, n) at [k // 8, n,
    k % 8], the K-major core-matrix image (8 n x 8 k bf16, 16 bytes a row)
    that the bf16 ``wgmma`` reads, one contiguous copy a chunk (the chunked
    body's basis). ``rows``, a multiple of 32 not under n_fft, sets Kp."""
    k, f = cos_b.shape
    kp = rows or -(-k // DENSE_CHUNK) * DENSE_CHUNK
    fp = -(-f // DENSE_BINS) * DENSE_BINS
    out = np.zeros((kp, fp // DENSE_BINS, 2, DENSE_BINS), np.float32)
    for j, b in enumerate((cos_b, sin_b)):
        out[:k, :, j, :] = np.pad(np.asarray(b, np.float32), ((0, 0), (0, fp - f))
                                  ).reshape(k, fp // DENSE_BINS, DENSE_BINS)
    v = bf16_round(out.reshape(kp, 2 * fp))
    # (chunk, k // 8 in it, k % 8, column block, n) -> the slabs
    v = v.reshape(kp // DENSE_CHUNK, DENSE_CHUNK // 8, 8, fp // DENSE_BINS, 2 * DENSE_BINS)
    return v.permute(3, 0, 1, 4, 2).contiguous()


def span_basis_bf16(cos_b: np.ndarray, sin_b: np.ndarray, hop: int) -> torch.Tensor:
    """The span body's bf16 basis: :func:`dense_basis_bf16`'s values and
    K-major core-matrix order over ``taps * hop`` rows (:func:`span_taps`;
    rows past n_fft zero), as (Fp/32, taps * hop / 8, 64, 8) bf16: row k of
    column c of column block j at [j, k // 8, c, k % 8]. A column block is
    one contiguous run, a tap's ``hop`` rows one bulk copy of it."""
    kp = span_taps(cos_b.shape[0], hop) * hop
    packed = dense_basis_bf16(cos_b, sin_b, -(-kp // DENSE_CHUNK) * DENSE_CHUNK)
    nb = packed.shape[0]
    return packed.reshape(nb, -1, 2 * DENSE_BINS, 8)[:, :kp // 8].contiguous()


def dense_split(n_fft: int, n_bins: int, batch: int, n_frames: int,
                resident: int = DENSE_RESIDENT) -> int:
    """Blocks of a cluster that share one output tile of the dense entry,
    each reducing its share of the n_fft samples (1, 2, 4 or 8): doubled
    while the doubled grid still runs at once (``resident`` blocks an SM: on
    the card :func:`blocks_per_sm`) and every rank keeps at least two
    chunks of 32 samples."""
    tiles = (-(-n_frames // DENSE_FRAMES) * -(-n_bins // DENSE_BINS) * batch)
    chunks = -(-n_fft // DENSE_CHUNK)
    split = 1
    while (split < DENSE_MAX_SPLIT and 2 * tiles * split <= resident * H100_SMS
           and chunks >= 4 * split):
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def blocks_per_sm(entry: str, smem: int) -> int:
    """Blocks of the mixed FFT kernel (``"fft"``), of the dense kernel
    (``"dense"``) or of its bf16 class's chunked body
    (``"dense_bf16_chunked"``) one SM of the card
    holds at once with ``smem`` bytes of dynamic shared memory each (a query
    of the CUDA occupancy calculator; builds the library, launches nothing;
    asked once a process)."""
    # through the registry: KERNEL itself may be wrapped (shape logs, tests)
    fn = KERNELS["stft"].library_function("dcs_stft_blocks_per_sm", [_i, _i, _p])
    out = ctypes.c_int(0)
    rc = fn(("fft", "dense", "dense_bf16_chunked").index(entry), smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"dcs_stft_blocks_per_sm failed: error {rc}")
    return out.value


class STFTPlan(NamedTuple):
    """What one STFT configuration hands kernel 1 on one device: the framing,
    the first bin kept, and the constants that device's route reads. A plan
    on the card holds only what its entry reads: the FFT's tables (``rows``
    None for the compiled size; the radices follow from n_fft), or the
    dense entry's packed basis. A plan on the CPU holds the folded (n_fft,
    F) bases of the plain version, and the FFT tables too where the FFT
    entry takes the size. A plan at bf16 (``bf16``) holds on the card in
    ``dense`` the bf16 basis of the body :func:`choose_entry` routes the size
    to (:func:`span_basis_bf16` or :func:`dense_basis_bf16`), on the CPU the
    bases rounded to bf16 (as float32 values) in ``cos_b`` and ``sin_b``."""

    n_fft: int
    n_bins: int
    hop: int
    pad: int
    first_bin: int
    cos_b: Optional[torch.Tensor]
    sin_b: Optional[torch.Tensor]
    fft: Optional[Tuple[torch.Tensor, ...]]
    dense: Optional[torch.Tensor] = None
    bf16: bool = False


def _check(x: torch.Tensor, n_fft: int, hop: int, pad: int) -> int:
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n), got {tuple(x.shape)}")
    n = x.shape[-1]
    if pad and n <= pad:
        raise ValueError(f"reflect padding by {pad} needs more than {pad} "
                         f"samples, got {n}")
    n_frames = 1 + (n + 2 * pad - n_fft) // hop
    if n_frames < 1:
        raise ValueError(f"{n} samples give no full frame of {n_fft}")
    return n_frames


def stft_dft_plain(x: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor,
                   hop: int, pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: reflect pad, frames (B, T, n_fft), two matmuls against
    the (n_fft, F) bases, transpose to (B, F, T)."""
    _check(x, cos_b.shape[0], hop, pad)
    if pad:
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cos_b.shape[0], hop)
    re = torch.matmul(frames, cos_b).transpose(-1, -2)
    im = torch.matmul(frames, sin_b).transpose(-1, -2)
    return re.contiguous(), im.contiguous()


def _outputs(x: torch.Tensor, n_bins: int, n_frames: int):
    re = torch.empty((x.shape[0], n_bins, n_frames), device=x.device,
                     dtype=torch.float32)
    return re, torch.empty_like(re)


def _launch_dense(x: torch.Tensor, plan: STFTPlan, n_frames: int,
                  body: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense entry, or at a bf16 plan its bf16 class, on a CUDA tensor,
    from the plan's packed basis: the body ``body`` names (``"dense_bf16"``
    or ``"dense_bf16_chunked"``, on the basis that body reads), by default
    :func:`choose_entry`'s."""
    dev = x.device
    if plan.dense is None:
        raise ValueError(f"the plan holds no dense basis for n_fft {plan.n_fft}")
    nb, nc = -(-plan.n_bins // DENSE_BINS), -(-plan.n_fft // DENSE_CHUNK)
    if plan.bf16 and (body or choose_entry(plan.n_fft, plan.hop, "bfloat16")) == "dense_bf16":
        return _launch_span(x, plan, n_frames)
    if plan.bf16:
        entry, kernel, smem = ("dense_bf16_chunked", KERNEL_DENSE_BF16_CHUNKED,
                               DENSE_SMEM_BF16)
        dtype, shape = torch.bfloat16, (nb, nc, DENSE_CHUNK // 8, 2 * DENSE_BINS, 8)
    else:
        entry, kernel, smem = "dense", KERNEL_DENSE, DENSE_SMEM
        dtype, shape = torch.float32, (nb, nc, 2, DENSE_CHUNK // 4, 2 * DENSE_BINS, 4)
    check_cuda_operand("dense", plan.dense, dev, len(shape), dtype)
    if tuple(plan.dense.shape) != shape or plan.dense.data_ptr() % 16:
        raise ValueError(f"the dense basis must be {shape} and 16-byte aligned, "
                         f"got {tuple(plan.dense.shape)}")
    re, im = _outputs(x, plan.n_bins, n_frames)
    split = dense_split(plan.n_fft, plan.n_bins, x.shape[0], n_frames,
                        blocks_per_sm(entry, smem) if x.is_cuda else DENSE_RESIDENT)
    kernel(dev, ptr(x), ptr(plan.dense), ptr(re), ptr(im), x.shape[0],
           x.shape[1], plan.n_fft, plan.hop, plan.n_bins, n_frames, plan.pad, split)
    return re, im


def _launch_span(x: torch.Tensor, plan: STFTPlan, n_frames: int,
                 tiles: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 class's span body on a CUDA tensor, from the plan's
    :func:`span_basis_bf16` basis, at ``tiles`` = (frames, groups), by
    default :func:`span_plan`'s."""
    dev = x.device
    nb = -(-plan.n_bins // DENSE_BINS)
    shape = (nb, span_taps(plan.n_fft, plan.hop) * plan.hop // 8, 2 * DENSE_BINS, 8)
    check_cuda_operand("dense", plan.dense, dev, len(shape), torch.bfloat16)
    if tuple(plan.dense.shape) != shape or plan.dense.data_ptr() % 16:
        raise ValueError(f"the span basis must be {shape} and 16-byte aligned, "
                         f"got {tuple(plan.dense.shape)}")
    re, im = _outputs(x, plan.n_bins, n_frames)
    frames, groups = tiles or span_plan(plan.n_fft, plan.hop, plan.n_bins, x.shape[0],
                                        n_frames, _sm_count(dev))
    KERNEL_DENSE_BF16(dev, ptr(x), ptr(plan.dense), ptr(re), ptr(im), x.shape[0],
                      x.shape[1], plan.n_fft, plan.hop, plan.n_bins, n_frames, plan.pad,
                      frames, groups)
    return re, im


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_fft(x: torch.Tensor, plan: STFTPlan, n_frames: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFT entry on a CUDA tensor, from the plan's radices and tables."""
    dev = x.device
    n_fft = plan.n_fft
    radices = fft_radices(n_fft)
    if plan.fft is None:
        raise ValueError(f"the plan holds no FFT tables for n_fft {n_fft}")
    n2, compiled = n_fft // 2, n_fft == FFT_COMPILED
    win2, tw, sp, rows = plan.fft
    for name, t, shape in (("win2", win2, (n2, 2)), ("tw", tw, (fft_twiddles(radices), 2)),
                           ("sp", sp, (n2 + 1, 2))):
        check_cuda_operand(name, t, dev, 2)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if compiled != (rows is None):
        raise ValueError(f"rows must be {'None' if compiled else 'given'} for "
                         f"n_fft {n_fft}")
    if rows is not None and (rows.device != dev or rows.dtype != torch.int32
                             or tuple(rows.shape) != (n2,) or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous int32 ({n2},) tensor on {dev}")
    re, im = _outputs(x, plan.n_bins, n_frames)
    ft = fft_tile_frames(n_fft, plan.hop, x.shape[0], n_frames)
    r = radices + (0,) * (FFT_MAX_STAGES - len(radices))
    KERNEL(dev, ptr(x), ptr(win2), ptr(tw), ptr(sp),
           None if rows is None else ptr(rows), ptr(re), ptr(im),
           x.shape[0], x.shape[1], n_fft, plan.hop, plan.first_bin, plan.n_bins,
           n_frames, plan.pad, *r, ft)
    return re, im


def stft_analysis(x: torch.Tensor, plan: STFTPlan
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, n) float32 -> (re, im), each (B, F, T): the windowed real DFT of
    the frames of the signal reflect-padded by ``pad`` at stride ``hop``, bins
    ``first_bin .. first_bin + F - 1``. CPU tensors take the plain version
    (at a bf16 plan on the samples rounded to bf16, against the plan's
    rounded bases); CUDA tensors the entry point :func:`choose_entry` names."""
    if x.device.type == "cpu":
        if plan.bf16:
            x = x.to(torch.bfloat16).to(x.dtype)
        return stft_dft_plain(x, plan.cos_b, plan.sin_b, plan.hop, plan.pad)
    n_frames = _check(x, plan.n_fft, plan.hop, plan.pad)
    check_cuda_operand("x", x, x.device, 2)
    if plan.bf16 or choose_entry(plan.n_fft, plan.hop) == "dense":
        return _launch_dense(x, plan, n_frames)
    return _launch_fft(x, plan, n_frames)
