"""Kernel 1: the fused STFT front end (``csrc/stft.cu``) and its plain version.

Replaces the Pallas kernel ``dcs_net_tpu/dsp/stft_pallas.py:_forward``. On the
H100 the function is bound by bytes (~17.4 MB for a batch of four 4 s
utterances, nearly all of it the output). The source has two entry points:

* the FFT kernel (``KERNEL``), for ``n_fft`` in :data:`FFT_RADICES`: each
  frame's windowed real DFT as a complex FFT of ``n_fft/2`` points in two
  in-register radix stages plus the real-input split step, one lane per
  frame, written straight to (B, F, T). It takes the window, the stage
  twiddles and the split twiddles as small float32 tables
  (:func:`fft_tables`, computed in float64);
* the dense DFT kernel (``KERNEL_DENSE``), for every other size: generic
  (n_fft, F) bases streamed through shared memory.

:func:`choose_entry` picks between them from the shape alone. See the source
for the design notes.

:func:`stft_analysis` is the one entry: it takes a tensor on the CPU through
:func:`stft_dft_plain` (reflect pad, framing, two matmuls) and a CUDA tensor
through the kernel that :func:`choose_entry` names, and never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.utils.cuda_lib import CudaKernel, check_cuda_operand, ptr

_i = ctypes.c_int
_p = ctypes.c_void_p
KERNEL = CudaKernel(
    "stft", "stft.cu", "dcs_stft_fft",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p])
KERNEL_DENSE = CudaKernel(
    "stft_dense", "stft.cu", "dcs_stft_forward",
    [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p])

# n_fft -> (R1, R2): the FFT kernel's instantiations. The real frame becomes
# n_fft/2 = R1 * R2 complex points; stage 1 is radix R1, stage 2 radix R2.
FFT_RADICES = {64: (8, 4), 128: (8, 8), 256: (16, 8), 512: (16, 16)}


def choose_entry(n_fft: int, hop: int) -> str:
    """``"fft"`` or ``"dense"``: which entry point a CUDA tensor takes, from
    the shape alone."""
    return "fft" if n_fft in FFT_RADICES and 0 < hop <= n_fft else "dense"


def fft_tables(window: np.ndarray) -> Optional[Tuple[np.ndarray, ...]]:
    """The FFT kernel's float32 tables for an analysis window of ``n_fft``
    points (scale folded in), computed in float64, or None when the kernel is
    not instantiated for that size. All are (cos, -sin) pairs:

    * ``win2`` (n_fft/2, 2): (w[2n], w[2n+1]) / 2, the packing of the real
      frame into complex points with the split step's halves folded in;
    * ``tw`` (R2, R1, 2): exp(-2 pi i q k1 / (n_fft/2)), between the stages;
    * ``sp`` (n_fft/2 + 1, 2): exp(-2 pi i k / n_fft), the split step's."""
    n_fft = window.shape[0]
    if n_fft not in FFT_RADICES:
        return None
    r1, r2 = FFT_RADICES[n_fft]
    n2 = n_fft // 2
    win2 = 0.5 * np.asarray(window, np.float64).reshape(n2, 2)
    ang = -2.0 * np.pi * np.outer(np.arange(r2), np.arange(r1)) / n2
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    ang = -2.0 * np.pi * np.arange(n2 + 1) / n_fft
    sp = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (win2, tw, sp))


class STFTPlan(NamedTuple):
    """What one STFT configuration hands kernel 1 on one device: the framing,
    the first bin kept, and the constants that device's route reads. The
    folded (n_fft, F) bases serve the plain version and the dense kernel, the
    tables the FFT kernel: a plan on the card holds only what its entry point
    reads (the other is None), a plan on the CPU holds the bases, and the
    tables too where the FFT kernel is instantiated for the size."""

    n_fft: int
    n_bins: int
    hop: int
    pad: int
    first_bin: int
    cos_b: Optional[torch.Tensor]
    sin_b: Optional[torch.Tensor]
    fft: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


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


def _launch_dense(x: torch.Tensor, plan: STFTPlan, n_frames: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense DFT kernel on a CUDA tensor, from the plan's bases."""
    dev = x.device
    if plan.cos_b is None or plan.sin_b is None:
        raise ValueError(f"the plan holds no dense bases for n_fft {plan.n_fft}")
    shape = (plan.n_fft, plan.n_bins)
    for name, t in (("cos_b", plan.cos_b), ("sin_b", plan.sin_b)):
        check_cuda_operand(name, t, dev, 2)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    re, im = _outputs(x, plan.n_bins, n_frames)
    KERNEL_DENSE(dev, ptr(x), ptr(plan.cos_b), ptr(plan.sin_b), ptr(re), ptr(im),
                 x.shape[0], x.shape[1], plan.n_fft, plan.hop, plan.n_bins,
                 n_frames, plan.pad)
    return re, im


def _launch_fft(x: torch.Tensor, plan: STFTPlan, n_frames: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFT kernel on a CUDA tensor, from the plan's tables."""
    dev = x.device
    n_fft = plan.n_fft
    if plan.fft is None:
        raise ValueError(f"the plan holds no FFT tables for n_fft {n_fft}")
    r1, r2 = FFT_RADICES[n_fft]
    shapes = ((n_fft // 2, 2), (r2, r1, 2), (n_fft // 2 + 1, 2))
    for name, t, shape in zip(("win2", "tw", "sp"), plan.fft, shapes):
        check_cuda_operand(name, t, dev, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    re, im = _outputs(x, plan.n_bins, n_frames)
    win2, tw, sp = plan.fft
    KERNEL(dev, ptr(x), ptr(win2), ptr(tw), ptr(sp), ptr(re), ptr(im),
           x.shape[0], x.shape[1], n_fft, plan.hop, plan.first_bin, plan.n_bins,
           n_frames, plan.pad)
    return re, im


def stft_analysis(x: torch.Tensor, plan: STFTPlan
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, n) float32 -> (re, im), each (B, F, T): the windowed real DFT of
    the frames of the signal reflect-padded by ``pad`` at stride ``hop``, bins
    ``first_bin .. first_bin + F - 1``. CPU tensors take the plain version;
    CUDA tensors the entry point :func:`choose_entry` names."""
    if x.device.type == "cpu":
        return stft_dft_plain(x, plan.cos_b, plan.sin_b, plan.hop, plan.pad)
    n_frames = _check(x, plan.n_fft, plan.hop, plan.pad)
    check_cuda_operand("x", x, x.device, 2)
    if choose_entry(plan.n_fft, plan.hop) == "dense":
        return _launch_dense(x, plan, n_frames)
    return _launch_fft(x, plan, n_frames)
