"""Host-side WAV decode/encode and the polyphase windowed-sinc resampler
(torchaudio's design: lowpass_filter_width 6, rolloff 0.99, Hann-squared
window), in numpy; ``resample_torch``, the same resampler on a tensor, the
JAX package's ``resample_jax``. The module imports torch only inside
``resample_torch``: the data loader's threads use the rest."""

from __future__ import annotations

import functools
import math
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str, normalize: bool = True) -> Tuple[np.ndarray, int]:
    """PCM16/PCM32 wav -> (float32 mono in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        scale = 2.0 ** 15
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32)
        scale = 2.0 ** 31
    else:
        raise ValueError(f"unsupported sample width {sw} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if normalize:
        x = x / scale
    return x, sr


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """float [-1, 1] -> PCM16 wav."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    pcm = np.round(x * (2.0 ** 15 - 1)).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@functools.lru_cache(maxsize=8)
def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 6,
                         rolloff: float = 0.99
                         ) -> Tuple[np.ndarray, int, int, int]:
    """Returns (kernels (new_r, 2*width + orig_r), width, orig_r, new_r) with
    the frequencies reduced by their gcd."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    kernels = []
    for i in range(new):
        t = (-i / new + idx) * base_freq
        t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
        window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
        t_pi = t * np.pi
        kernel = np.where(t_pi == 0, 1.0,
                          np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
        kernels.append(kernel * window)
    scale = base_freq / orig
    return (np.stack(kernels).astype(np.float32) * scale, width, orig, new)


def resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Polyphase resample of (..., n) float32."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig, new = sinc_resample_kernel(orig_freq, new_freq)
    n = x.shape[-1]
    target_len = int(math.ceil(new * n / orig))
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(width, width + orig)])
    klen = kernels.shape[1]
    n_frames = (xp.shape[-1] - klen) // orig + 1
    idx = np.arange(n_frames)[:, None] * orig + np.arange(klen)[None, :]
    phases = xp[..., idx] @ kernels.T            # (..., frames, new)
    out = phases.reshape(x.shape[:-1] + (-1,))   # interleaved phases
    return out[..., :target_len].astype(np.float32)


def resample_torch(x, orig_freq: int, new_freq: int):
    """:func:`resample` of a (..., n) float32 tensor on its device: one
    ``F.conv1d`` with stride ``orig`` and one output channel per phase (for
    48 -> 16 kHz a single stride-3 conv)."""
    import torch
    import torch.nn.functional as F

    if orig_freq == new_freq:
        return x
    kernels, width, orig, new = sinc_resample_kernel(orig_freq, new_freq)
    n = x.shape[-1]
    target_len = int(math.ceil(new * n / orig))
    xp = F.pad(x.reshape(-1, 1, n), (width, width + orig))
    w = torch.as_tensor(kernels, dtype=x.dtype, device=x.device)[:, None, :]
    out = F.conv1d(xp, w, stride=orig)                 # (B, new, frames)
    out = out.transpose(1, 2).reshape(xp.shape[0], -1)  # interleaved phases
    return out[:, :target_len].reshape(x.shape[:-1] + (target_len,))
