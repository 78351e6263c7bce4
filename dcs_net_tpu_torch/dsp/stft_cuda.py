"""Kernel 1: the fused STFT front end (``csrc/stft.cu``) and its plain version.

Replaces the Pallas kernel ``dcs_net_tpu/dsp/stft_pallas.py:_forward``. On the
H100 the function is bound by bytes (~18 MB for a batch of four 4 s
utterances; an FFT would need ~0.09 GFLOP), but this kernel computes a dense
DFT (4.2 GFLOP of float32 FMAs), so its design ceiling is the float32 rate,
about 12x the bound. The kernel stages each frame tile's
contiguous sample span once in shared memory, streams the folded DFT bases
through shared memory and writes (B, F, T) directly. See the source for the
design notes.

:func:`stft_dft` takes a tensor on the CPU through :func:`stft_dft_plain`
(reflect pad, framing, two matmuls) and a CUDA tensor through the kernel; it
never falls back from one to the other.
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
    "stft", "stft.cu", "dcs_stft_forward",
    [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p])


def _check(x: torch.Tensor, cos_b: torch.Tensor, hop: int, pad: int) -> int:
    if x.dim() != 2:
        raise ValueError(f"x must be (B, n), got {tuple(x.shape)}")
    n_fft = cos_b.shape[0]
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
    _check(x, cos_b, hop, pad)
    if pad:
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cos_b.shape[0], hop)
    re = torch.matmul(frames, cos_b).transpose(-1, -2)
    im = torch.matmul(frames, sin_b).transpose(-1, -2)
    return re.contiguous(), im.contiguous()


def stft_dft(x: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor,
             hop: int, pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, n) float32 -> (re, im), each (B, F, T): frames of the signal
    reflect-padded by ``pad`` at stride ``hop``, dotted with the (n_fft, F)
    bases. CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return stft_dft_plain(x, cos_b, sin_b, hop, pad)
    n_frames = _check(x, cos_b, hop, pad)
    dev = x.device
    for name, t, nd in (("x", x, 2), ("cos_b", cos_b, 2), ("sin_b", sin_b, 2)):
        check_cuda_operand(name, t, dev, nd)
    if sin_b.shape != cos_b.shape:
        raise ValueError("cos_b and sin_b must have the same shape")
    B, n = x.shape
    n_fft, n_bins = cos_b.shape
    re = torch.empty((B, n_bins, n_frames), device=dev, dtype=torch.float32)
    im = torch.empty_like(re)
    KERNEL(dev, ptr(x), ptr(cos_b), ptr(sin_b), ptr(re), ptr(im),
           B, n, n_fft, hop, n_bins, n_frames, pad)
    return re, im
