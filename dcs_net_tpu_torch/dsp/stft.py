"""STFT / iSTFT with torch.stft / torch.istft semantics.

* center=True reflect padding of n_fft//2 on both ends;
* normalized=True multiplies by n_fft**-0.5;
* the DC bin is dropped after analysis (bins 1..n_fft/2);
* resynthesis reproduces the pad-one-zero-TOP-bin quirk behind
  ``Quirks.istft_pad_top_bin``.

The analysis is the windowed, scaled real DFT of every frame, computed by
kernel 1 (``dsp/stft_cuda.py``): on the card an FFT inside the kernel, fed the
window and twiddle tables (folded in float64, then cast), for every even
``n_fft`` up to 2048 whose half is 7-smooth, or the dense DFT on the tensor
cores for the rest; on the CPU the plain
version, one product against (n_fft, F) cos/sin bases with the window and
scale folded in. The synthesis is a matmul against folded inverse bases plus
an overlap-add, as in the JAX package.

At ``dft_dtype="bfloat16"`` (the JAX package's ``--dtype bfloat16``) the
analysis is the frames rounded to bf16 times the folded basis rounded to bf16
(float64 fold -> float32 -> bf16), float32 accumulation and output: kernel
1's dense bf16 class on the card for every size (its span body at the
model's size), the plain version on the
rounded values on the CPU. The synthesis multiplies the spectrogram and the
inverse bases, both rounded to bf16, in float32 (the products of bf16 values
are exact in float32), and overlap-adds in float32, as the JAX ``istft``.

Gradients. On a CUDA tensor :func:`stft` is :class:`STFT`, whose backward is
the JAX ``_adjoint`` (``dcs_net_tpu/dsp/stft_pallas.py:152-188``) in PyTorch:
the transposed analysis bases, an overlap-add and the transpose of the
reflect padding (:func:`stft_adjoint`), the same matmul and overlap-add as
the iSTFT. On a CPU tensor the plain version runs under plain autograd. At
bf16 the STFT takes no gradient, as in the JAX package's train step, whose
waves take none: the analysis at bf16 has no backward.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.core.config import STFTConfig
from dcs_net_tpu_torch.dsp.stft_cuda import (FFT_COMPILED, STFTPlan, bf16_round,
                                             choose_entry, dense_basis, dense_basis_bf16,
                                             fft_tables, span_basis_bf16, stft_analysis)
from dcs_net_tpu_torch.utils.carray import CArray
from dcs_net_tpu_torch.utils.device import device_cache


@functools.lru_cache(maxsize=8)
def window_np(cfg: STFTConfig) -> np.ndarray:
    """Periodic Hann window (float64), centre-padded to n_fft."""
    if cfg.window != "hann":
        raise NotImplementedError(f"window {cfg.window!r}")
    n = np.arange(cfg.win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.win_length)
    if cfg.win_length < cfg.n_fft:
        pad = (cfg.n_fft - cfg.win_length) // 2
        w = np.pad(w, (pad, cfg.n_fft - cfg.win_length - pad))
    return w


@functools.lru_cache(maxsize=8)
def _dft_basis_eff(cfg: STFTConfig, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_bins) analysis bases with the window and the normalized
    scale folded in (float64 at fold time), cast to ``dtype``: raw frames @
    basis == (frames * window) @ dft * scale."""
    n_bins_full = cfg.n_fft // 2 + 1
    k = np.arange(n_bins_full)
    n = np.arange(cfg.n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / cfg.n_fft
    w = window_np(cfg).astype(np.float64)[:, None]
    scale = cfg.n_fft ** -0.5 if cfg.normalized else 1.0
    cos_b, sin_b = np.cos(ang) * w * scale, np.sin(ang) * w * scale
    if cfg.drop_dc:
        cos_b, sin_b = cos_b[:, 1:], sin_b[:, 1:]
    return cos_b.astype(dtype), sin_b.astype(dtype)


@functools.lru_cache(maxsize=8)
def _idft_basis_eff(cfg: STFTConfig, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(n_bins_full, n_fft) inverse bases with the hermitian doubling
    weights, the normalized sqrt(N) pre-scale and the synthesis window
    post-multiply folded in (float64 at fold time), cast to ``dtype``."""
    n_bins_full = cfg.n_fft // 2 + 1
    k = np.arange(n_bins_full)
    n = np.arange(cfg.n_fft)
    ang = 2.0 * np.pi * np.outer(k, n) / cfg.n_fft
    weights = np.full((n_bins_full, 1), 2.0)
    weights[0] = weights[-1] = 1.0
    w = window_np(cfg).astype(np.float64)[None, :]
    scale = cfg.n_fft ** 0.5 if cfg.normalized else 1.0
    cos_b = weights * np.cos(ang) / cfg.n_fft * w * scale
    sin_b = -weights * np.sin(ang) / cfg.n_fft * w * scale
    return cos_b.astype(dtype), sin_b.astype(dtype)


@device_cache(32)
def _on_device(fn, cfg: STFTConfig, device: torch.device, dtype=np.float32):
    """The constants ``fn(cfg, dtype)`` as tensors on ``device``, copied
    once: a host-to-device copy per call would stall the host until the card
    drains its queue."""
    return tuple(torch.from_numpy(a).to(device) for a in fn(cfg, dtype))


def _work_dtype(x: torch.Tensor):
    """float32, the kernels' type; float64 stays float64, which only the
    plain versions on the CPU take (a float64 witness of a float32 run)."""
    return np.float64 if x.dtype == torch.float64 else np.float32


@device_cache(32)
def _bf16_bases(fn, cfg: STFTConfig, device: torch.device):
    """The float32 constants ``fn(cfg)`` rounded to bf16, as float32 tensors
    on ``device``: the operands of the plain bf16 products."""
    return tuple(bf16_round(a).float().to(device) for a in fn(cfg, np.float32))


@device_cache(32)
def _analysis_plan(cfg: STFTConfig, device: torch.device,
                   dtype=np.float32) -> STFTPlan:
    """Kernel 1's constants for ``cfg`` on ``device``, copied once. The card
    gets only what its entry point reads: the FFT's tables (no row table
    for the compiled size), or the dense entry's packed basis (at bf16 that
    of the body its bf16 class routes the size to); the CPU gets the plain version's bases (at bf16 rounded),
    and the FFT tables where the FFT entry takes the size (the tests model
    the kernel from them)."""
    on_cpu = torch.device(device).type == "cpu"
    if cfg.dft_dtype == "bfloat16":
        cos_b = sin_b = dense = None
        if on_cpu:
            cos_b, sin_b = _bf16_bases(_dft_basis_eff, cfg, device)
        elif choose_entry(cfg.n_fft, cfg.hop, "bfloat16") == "dense_bf16":
            dense = span_basis_bf16(*_dft_basis_eff(cfg, np.float32), cfg.hop).to(device)
        else:
            dense = dense_basis_bf16(*_dft_basis_eff(cfg, np.float32)).to(device)
        return STFTPlan(cfg.n_fft, cfg.n_bins, cfg.hop,
                        cfg.n_fft // 2 if cfg.center else 0,
                        1 if cfg.drop_dc else 0, cos_b, sin_b, None, dense, bf16=True)
    scale = cfg.n_fft ** -0.5 if cfg.normalized else 1.0
    tables = fft_tables(window_np(cfg).astype(np.float64) * scale)
    fft = choose_entry(cfg.n_fft, cfg.hop) == "fft"
    cos_b = sin_b = dense = None
    if on_cpu:
        cos_b, sin_b = _on_device(_dft_basis_eff, cfg, device, dtype)
    elif not fft:
        dense = torch.from_numpy(dense_basis(*_dft_basis_eff(cfg, np.float64))
                                 ).to(device)
    if tables is not None and (on_cpu or fft):
        if not on_cpu and cfg.n_fft == FFT_COMPILED:
            tables = tables[:3] + (None,)
        tables = tuple(None if a is None else torch.from_numpy(a).to(device)
                       for a in tables)
    else:
        tables = None
    return STFTPlan(cfg.n_fft, cfg.n_bins, cfg.hop,
                    cfg.n_fft // 2 if cfg.center else 0,
                    1 if cfg.drop_dc else 0, cos_b, sin_b, tables, dense)


@device_cache(16)
def _inv_window_envelope(cfg: STFTConfig, n_frames: int, device: torch.device,
                         dtype=np.float32) -> torch.Tensor:
    """1 / the overlap-added squared window (data-independent, floored at
    1e-11), on ``device``."""
    w = window_np(cfg) ** 2
    total = cfg.n_fft + cfg.hop * (n_frames - 1)
    env = np.zeros(total)
    for t in range(n_frames):
        env[t * cfg.hop:t * cfg.hop + cfg.n_fft] += w
    inv = 1.0 / np.maximum(env, 1e-11).astype(dtype)
    return torch.from_numpy(inv).to(device)


def _check_dft_dtype(cfg: STFTConfig) -> bool:
    """Whether ``cfg`` runs its DFT products at bf16; raises on a type other
    than float32 and bfloat16."""
    if cfg.dft_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"dft_dtype={cfg.dft_dtype!r}: the port takes "
                                  "float32 and bfloat16")
    return cfg.dft_dtype == "bfloat16"


def stft_adjoint(g_re: torch.Tensor, g_im: torch.Tensor, cfg: STFTConfig,
                 n: int) -> torch.Tensor:
    """The adjoint of the (linear) analysis of (B, n) signals: gradients
    (B, F, T) of re and im -> (B, n). Frames g_re^T cos^T + g_im^T sin^T
    through the folded bases, overlap-added, then the reflect padding
    transposed: padded sample i < pad came from x[pad - i], padded sample
    pad + n + j from x[n - 2 - j]."""
    cos_b, sin_b = _on_device(_dft_basis_eff, cfg, g_re.device)
    frames = (torch.matmul(g_re.transpose(-1, -2), cos_b.t())
              + torch.matmul(g_im.transpose(-1, -2), sin_b.t()))
    total = cfg.n_fft + cfg.hop * (frames.shape[-2] - 1)
    acc = _overlap_add(frames, cfg, total)
    pad = cfg.n_fft // 2 if cfg.center else 0
    if total < n + 2 * pad:     # samples past the last frame get no gradient
        acc = F.pad(acc, (0, n + 2 * pad - total))
    dx = acc[..., pad:pad + n].clone()
    if pad:
        dx[..., 1:pad + 1] += acc[..., :pad].flip(-1)
        dx[..., n - 1 - pad:n - 1] += acc[..., pad + n:2 * pad + n].flip(-1)
    return dx


class STFT(torch.autograd.Function):
    """Kernel 1 under autograd: forward the analysis of (B, n) float32
    signals, backward :func:`stft_adjoint`."""

    @staticmethod
    def forward(ctx, x, cfg):
        ctx.cfg, ctx.n = cfg, x.shape[-1]
        return stft_analysis(x, _analysis_plan(cfg, x.device))

    @staticmethod
    def backward(ctx, g_re, g_im):
        return stft_adjoint(g_re, g_im, ctx.cfg, ctx.n), None


def stft(x: torch.Tensor, cfg: STFTConfig) -> CArray:
    """(..., n) real float32 signal -> CArray of shape (..., F, T).

    Matches torch.stft(..., normalized=cfg.normalized)[..., 1:257, :] for the
    default config. A CUDA tensor runs kernel 1, through :class:`STFT` where
    autograd follows it; a CPU tensor its plain version (plain autograd). At
    ``dft_dtype="bfloat16"`` a float32 signal, and no gradient."""
    bf16 = _check_dft_dtype(cfg)
    if cfg.center and cfg.pad_mode != "reflect":
        raise NotImplementedError(f"pad_mode {cfg.pad_mode!r}")
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.promote_types(x.dtype, torch.float32)
                                       ).contiguous()
    dtype = _work_dtype(x2)
    tracked = torch.is_grad_enabled() and x2.requires_grad
    if bf16 and (tracked or x2.dtype != torch.float32):
        raise NotImplementedError(
            "the STFT at dft_dtype='bfloat16' takes a float32 signal without "
            "autograd: its bf16 class has no backward (the train step's waves "
            "take no gradient)")
    if x.device.type != "cpu" and tracked:
        re, im = STFT.apply(x2, cfg)
    else:
        re, im = stft_analysis(x2, _analysis_plan(cfg, x.device, dtype))
    return CArray(re.reshape(batch_shape + re.shape[-2:]),
                  im.reshape(batch_shape + im.shape[-2:]))


def _overlap_add(frames: torch.Tensor, cfg: STFTConfig, total: int) -> torch.Tensor:
    """(..., T, n_fft) -> (..., total): sum of the frames at stride hop."""
    n_frames = frames.shape[-2]
    batch = frames.shape[:-2]
    if cfg.n_fft % cfg.hop == 0:
        r = cfg.n_fft // cfg.hop
        pieces = frames.reshape(batch + (n_frames, r, cfg.hop))
        acc = frames.new_zeros(batch + (n_frames + r - 1, cfg.hop))
        for i in range(r):
            acc[..., i:i + n_frames, :] += pieces[..., i, :]
        return acc.reshape(batch + (total,))
    out = frames.new_zeros(batch + (total,))
    for t in range(n_frames):
        out[..., t * cfg.hop:t * cfg.hop + cfg.n_fft] += frames[..., t, :]
    return out


def istft(spec: CArray, cfg: STFTConfig, *, length: Optional[int] = None
          ) -> torch.Tensor:
    """iSTFT of a FULL-bin spectrogram (..., n_fft//2+1, T) -> (..., n).

    Matches torch.istft(center=True, normalized=cfg.normalized). At
    ``dft_dtype="bfloat16"`` the spectrogram and the bases are rounded to
    bf16 and multiplied in float32 (``torch.matmul``, as the JAX package
    leaves the product to XLA), the sum and the overlap-add in float32."""
    bf16 = _check_dft_dtype(cfg)
    n_bins_full = cfg.n_fft // 2 + 1
    if spec.shape[-2] != n_bins_full:
        raise ValueError(
            f"istft expects {n_bins_full} bins, got {spec.shape[-2]}; "
            "use pad_bins()/polar_to_wave() for DC-dropped spectrograms")
    dtype = _work_dtype(spec.re)
    re = spec.re.transpose(-1, -2)
    im = spec.im.transpose(-1, -2)
    if bf16:
        cos_b, sin_b = _bf16_bases(_idft_basis_eff, cfg, spec.device)
        re, im = (p.to(torch.bfloat16).float() for p in (re, im))
    else:
        cos_b, sin_b = _on_device(_idft_basis_eff, cfg, spec.device, dtype)
    frames = torch.matmul(re, cos_b) + torch.matmul(im, sin_b)  # (..., T, n_fft)
    n_frames = frames.shape[-2]
    total = cfg.n_fft + cfg.hop * (n_frames - 1)
    out = _overlap_add(frames, cfg, total) * _inv_window_envelope(
        cfg, n_frames, spec.device, dtype)
    if cfg.center:
        half = cfg.n_fft // 2
        out = out[..., half:total - half]
    if length is not None:
        out = out[..., :length]
    return out


def pad_bins(spec: CArray, cfg: STFTConfig, *, pad_top: bool) -> CArray:
    """Recreate a full (n_fft//2+1)-bin spectrogram from the DC-dropped one.

    pad_top=True reproduces the original code's quirk: the zero goes on TOP
    (the Nyquist slot), so the 256 content bins land one bin lower than where
    they were analysed. pad_top=False re-inserts the zero at the DC slot."""
    zeros = spec.re.new_zeros(spec.shape[:-2] + (1,) + spec.shape[-1:])
    if pad_top:
        return CArray(torch.cat([spec.re, zeros], dim=-2),
                      torch.cat([spec.im, zeros], dim=-2))
    return CArray(torch.cat([zeros, spec.re], dim=-2),
                  torch.cat([zeros, spec.im], dim=-2))


def polar_to_wave(mag: torch.Tensor, phase: torch.Tensor, cfg: STFTConfig, *,
                  pad_top: bool = True, length: Optional[int] = None
                  ) -> torch.Tensor:
    """mag/phase (..., F=256, T) -> waveform."""
    spec = CArray.from_polar(mag, phase)
    return istft(pad_bins(spec, cfg, pad_top=pad_top), cfg, length=length)


def spec_to_wave(spec: CArray, cfg: STFTConfig, *, atan2_eps: float,
                 pad_top: bool = True, length: Optional[int] = None,
                 polar: bool = True) -> torch.Tensor:
    """CArray spectrogram -> waveform.

    polar=True routes through the mag/atan2(+eps) polar decomposition of the
    original code (not quite the identity because of the eps shift);
    polar=False feeds the spectrogram to the iSTFT directly."""
    if polar:
        return polar_to_wave(spec.abs(), spec.angle(atan2_eps), cfg,
                             pad_top=pad_top, length=length)
    return istft(pad_bins(spec, cfg, pad_top=pad_top), cfg, length=length)

