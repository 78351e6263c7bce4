"""STOI, Short-Time Objective Intelligibility (Taal et al. 2011): the port's
copy of the JAX package's ``metrics/stoi.py``.

The published algorithm with pystoi's constants (pystoi is not a dependency):

  * resample to 10 kHz (``data/audio_io.resample``)
  * remove silent frames (40 dB range, 256-sample frames, 50% overlap)
  * 512-point STFT of 256-sample hann frames
  * 15 one-third-octave bands, 150 Hz .. ~4.3 kHz
  * 384 ms analysis segments (N = 30 frames)
  * normalization + clipping (beta = -15 dB), correlation per band/segment

Pure numpy, on the host, on audio fetched from the device once per batch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

FS = 10000          # internal sample rate
N_FRAME = 256       # frame length at 10 kHz
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30              # frames per analysis segment
BETA = -15.0        # lower SDR bound, dB
DYN_RANGE = 40.0    # silent-frame removal range, dB


@functools.lru_cache(maxsize=1)
def _third_octave_bands() -> Tuple[np.ndarray, np.ndarray]:
    """Returns (obm (15, 257), center_freqs)."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUM_BANDS)
    cf = 2.0 ** (k / 3.0) * MIN_FREQ
    lo = MIN_FREQ * 2.0 ** ((2 * k - 1) / 6.0)
    hi = MIN_FREQ * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        lo_idx = int(np.argmin((f - lo[i]) ** 2))
        hi_idx = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_idx:hi_idx] = 1.0
    return obm, cf


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    from dcs_net_tpu_torch.data.audio_io import resample

    return resample(x.astype(np.float32), fs, FS)


def _frame(x: np.ndarray, flen: int, hop: int) -> np.ndarray:
    n = (len(x) - flen) // hop + 1
    if n <= 0:
        return np.zeros((0, flen))
    idx = np.arange(n)[:, None] * hop + np.arange(flen)[None, :]
    return x[idx]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frame(x, N_FRAME, hop) * w
    yf = _frame(y, N_FRAME, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (energies.max() - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (len(xf) - 1) * hop + N_FRAME if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop:i * hop + N_FRAME] += xf[i]
        ys[i * hop:i * hop + N_FRAME] += yf[i]
    return xs, ys


def _band_env(x: np.ndarray) -> np.ndarray:
    """(n,) -> (15, n_frames) one-third-octave band envelopes."""
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frame(x, N_FRAME, hop) * w
    spec = np.fft.rfft(frames, NFFT, axis=1)
    power = np.abs(spec) ** 2
    obm, _ = _third_octave_bands()
    return np.sqrt(power @ obm.T).T  # (15, n_frames)


def stoi(clean: np.ndarray, denoised: np.ndarray, fs: int, extended: bool = False) -> float:
    """Intelligibility in [~0, 1]; call signature mirrors pystoi.stoi."""
    clean = np.asarray(clean, np.float64).ravel()
    denoised = np.asarray(denoised, np.float64).ravel()
    if clean.shape != denoised.shape:
        raise ValueError("clean and denoised must have the same shape")
    x = _resample_to_10k(clean, fs)
    y = _resample_to_10k(denoised, fs)
    x, y = _remove_silent_frames(x, y)
    X = _band_env(x)  # (15, T)
    Y = _band_env(y)
    if X.shape[1] < N:
        return float("nan")

    beta_factor = 10 ** (-BETA / 20.0)
    scores = []
    for m in range(N, X.shape[1] + 1):
        Xs = X[:, m - N:m]  # (15, N)
        Ys = Y[:, m - N:m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12)
        Ys_n = Ys * alpha
        if extended:
            Xn = (Xs - Xs.mean(1, keepdims=True))
            Yn = (Ys - Ys.mean(1, keepdims=True))
            Xn /= np.linalg.norm(Xn, axis=1, keepdims=True) + 1e-12
            Yn /= np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-12
            scores.append(np.sum(Xn * Yn) / NUM_BANDS)
            continue
        Ys_c = np.minimum(Ys_n, Xs * (1 + beta_factor))
        xm = Xs - Xs.mean(1, keepdims=True)
        ym = Ys_c - Ys_c.mean(1, keepdims=True)
        corr = np.sum(xm * ym, axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12)
        scores.append(corr.mean())
    return float(np.mean(scores))
