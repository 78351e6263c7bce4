"""Composite objective speech-quality measures, SegSNR, LLR, WSS and
CSIG/CBAK/COVL: the port's copy of the JAX package's ``metrics/composite.py``.

The original code computes these through MATLAB (the ``semetrics``
package's composite.m); this module follows the published algorithms in
numpy (Hu & Loizou 2008, "Evaluation of objective quality measures for
speech enhancement"; Quackenbush/Barnwell/Clements for SegSNR and WSS;
Itakura for LLR), on the host, per utterance.

Conventions (matching composite.m):
  * 30 ms frames, 75% overlap, MATLAB-hanning windowed
    (w[k] = 0.5*(1 - cos(2*pi*k/(N+1))), k = 1..N, in snr_seg, llr and wss);
  * SegSNR clamped to [-10, 35] dB per frame;
  * LLR mean over the smallest 95% of frames;
  * WSS mean over the smallest 95% of frames;
  * CSIG/CBAK/COVL = affine combinations of PESQ/LLR/WSS/SegSNR clamped
    to the MOS range [1, 5].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = [
    "segsnr", "llr", "wss", "composite", "csig_cbak_covl",
]


def _frames(x: np.ndarray, win: int, skip: int) -> np.ndarray:
    n = 1 + max(len(x) - win, 0) // skip
    idx = np.arange(win)[None, :] + skip * np.arange(n)[:, None]
    return x[idx]


def _hann_matlab(n: int) -> np.ndarray:
    """MATLAB hanning(n): 0.5*(1 - cos(2*pi*k/(n+1))), k = 1..n — no zero
    endpoints (unlike numpy.hanning). This is the window composite.m applies
    in snr_seg/llr/wss."""
    k = np.arange(1, n + 1)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n + 1)))


def segsnr(clean: np.ndarray, processed: np.ndarray, sr: int,
           *, floor_db: float = -10.0, ceil_db: float = 35.0,
           eps: float = np.finfo(np.float64).eps) -> float:
    """Segmental SNR over MATLAB-hanning-windowed frames, per-frame dB
    clamped to [floor, ceil], mean over frames (composite.m snr_seg)."""
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    n = min(len(clean), len(processed))
    clean, processed = clean[:n], processed[:n]
    win = int(round(30 * sr / 1000))
    skip = win // 4
    w = _hann_matlab(win)
    cf = _frames(clean, win, skip) * w
    df = _frames(clean - processed, win, skip) * w
    num = np.sum(cf * cf, axis=1)
    den = np.sum(df * df, axis=1)
    snr = 10.0 * np.log10((num + eps) / (den + eps))
    return float(np.mean(np.clip(snr, floor_db, ceil_db)))


def _lpc(frame: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Levinson-Durbin LPC. Returns (a, R): a = [1, -a1, ...], R = autocorr."""
    n = len(frame)
    R = np.empty(order + 1)
    for k in range(order + 1):
        R[k] = np.dot(frame[: n - k], frame[k:])
    if R[0] <= 0:
        return np.concatenate([[1.0], np.zeros(order)]), R
    a = np.zeros(order + 1)
    a[0] = 1.0
    err = R[0]
    for i in range(1, order + 1):
        acc = R[i] + np.dot(a[1:i], R[i - 1:0:-1])
        k = -acc / err
        a[1:i + 1] = a[1:i + 1] + k * a[i - 1::-1][:i]
        a[i] = k
        err *= (1.0 - k * k)
        if err <= 0:
            break
    return a, R


def _toeplitz_quad(a: np.ndarray, R: np.ndarray) -> float:
    """a^T Toeplitz(R) a without forming the matrix: uses the autocorrelation
    identity a^T T(R) a = R[0]*sum(a^2) + 2*sum_k R[k]*sum_i a[i]a[i+k]."""
    order = len(a) - 1
    total = R[0] * np.dot(a, a)
    for k in range(1, order + 1):
        total += 2.0 * R[k] * np.dot(a[:-k], a[k:])
    return float(total)


def llr(clean: np.ndarray, processed: np.ndarray, sr: int,
        *, alpha: float = 0.95) -> float:
    """Log-likelihood ratio (Itakura distance between frame LPC models).

    Per frame: log( a_p^T R_c a_p / a_c^T R_c a_c ), a = LPC of the MATLAB-hanning-
    windowed frame (order 16 @16 kHz, 10 @8 kHz); mean over the smallest
    ``alpha`` fraction of frames.
    """
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    n = min(len(clean), len(processed))
    clean, processed = clean[:n], processed[:n]
    win = int(round(30 * sr / 1000))
    skip = win // 4
    order = 16 if sr >= 10000 else 10
    w = _hann_matlab(win)
    cf = _frames(clean, win, skip) * w
    pf = _frames(processed, win, skip) * w
    vals = []
    for c, p in zip(cf, pf):
        a_c, R_c = _lpc(c, order)
        a_p, _ = _lpc(p, order)
        num = _toeplitz_quad(a_p, R_c)
        den = _toeplitz_quad(a_c, R_c)
        if den > 0 and num > 0:
            vals.append(np.log(num / den))
    if not vals:
        return float("nan")
    vals = np.sort(np.asarray(vals))
    keep = max(int(round(len(vals) * alpha)), 1)
    return float(np.mean(vals[:keep]))


# 25 critical-band center frequencies / bandwidths (Hz) used by wss
# (Quackenbush et al.; identical table in composite.m).
_CENT = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63])
_BW = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056,
    95.3398, 105.411, 116.256, 127.914, 140.423, 153.823, 168.154,
    183.457, 199.776, 217.153, 235.631, 255.255, 276.072, 298.126,
    321.465, 346.136])


def wss(clean: np.ndarray, processed: np.ndarray, sr: int,
        *, alpha: float = 0.95) -> float:
    """Weighted spectral-slope distance (Klatt 1982, as in composite.m).

    Per frame: critical-band dB spectra -> adjacent-band slopes -> slope
    differences weighted by peak/max proximity; mean over the smallest
    ``alpha`` fraction of frames.
    """
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    n = min(len(clean), len(processed))
    clean, processed = clean[:n], processed[:n]

    win = int(round(30 * sr / 1000))
    skip = win // 4
    max_freq = sr / 2
    n_crit = 25
    n_fft = int(2 ** np.ceil(np.log2(2 * win)))
    n_fftby2 = n_fft // 2

    Kmax = 20.0
    Klocmax = 1.0

    # Gaussian critical-band filterbank on the FFT grid (composite.m builds
    # filters with min activity -30 dB at band edges)
    bw_min = _BW[0]
    crit_filter = np.zeros((n_crit, n_fftby2))
    j = np.arange(n_fftby2)
    for i in range(n_crit):
        f0 = (_CENT[i] / max_freq) * n_fftby2
        bw = (_BW[i] / max_freq) * n_fftby2
        norm_factor = np.log(bw_min) - np.log(_BW[i])
        crit_filter[i] = np.exp(-11.0 * (((j - np.floor(f0)) / bw) ** 2)
                                + norm_factor)
        crit_filter[i] *= crit_filter[i] > np.exp(-30.0 / (2 * 2.303))

    w = _hann_matlab(win)
    cf = _frames(clean, win, skip) * w
    pf = _frames(processed, win, skip) * w

    eps = np.finfo(np.float64).eps
    vals = []
    for c, p in zip(cf, pf):
        cs = np.abs(np.fft.fft(c, n_fft))[:n_fftby2] ** 2
        ps = np.abs(np.fft.fft(p, n_fft))[:n_fftby2] ** 2
        c_energy = crit_filter @ cs
        p_energy = crit_filter @ ps
        c_db = 10.0 * np.log10(np.maximum(c_energy, 1e-10))
        p_db = 10.0 * np.log10(np.maximum(p_energy, 1e-10))

        c_slope = np.diff(c_db)
        p_slope = np.diff(p_db)

        # nearest peak above each band (for rising slopes) or the band's own
        # max-proximity (falling slopes): composite.m's peak/valley search
        def peaks(db, slope):
            pk = np.empty(n_crit - 1)
            for k in range(n_crit - 1):
                if slope[k] > 0:
                    m = k
                    while m < n_crit - 1 and db[m + 1] > db[m]:
                        m += 1
                    pk[k] = db[m]
                else:
                    m = k
                    while m > 0 and db[m - 1] > db[m]:
                        m -= 1
                    pk[k] = db[m]
            return pk

        c_peak = peaks(c_db, c_slope)
        p_peak = peaks(p_db, p_slope)

        dbmax_c = np.max(c_db)
        dbmax_p = np.max(p_db)
        Wmax_c = Kmax / (Kmax + dbmax_c - c_db[:-1])
        Wlocmax_c = Klocmax / (Klocmax + c_peak - c_db[:-1])
        W_c = Wmax_c * Wlocmax_c
        Wmax_p = Kmax / (Kmax + dbmax_p - p_db[:-1])
        Wlocmax_p = Klocmax / (Klocmax + p_peak - p_db[:-1])
        W_p = Wmax_p * Wlocmax_p
        W = (W_c + W_p) / 2.0
        d = np.sum(W * (c_slope - p_slope) ** 2) / (np.sum(W) + eps)
        vals.append(d)
    if not vals:
        return float("nan")
    vals = np.sort(np.asarray(vals))
    keep = max(int(round(len(vals) * alpha)), 1)
    return float(np.mean(vals[:keep]))


def _mos_clip(x: float) -> float:
    return float(np.clip(x, 1.0, 5.0))


def csig_cbak_covl(pesq_mos: float, llr_v: float, wss_v: float,
                   segsnr_v: float) -> Dict[str, float]:
    """Hu & Loizou 2008 composite regressions (composite.m coefficients)."""
    csig = 3.093 - 1.029 * llr_v + 0.603 * pesq_mos - 0.009 * wss_v
    cbak = 1.634 + 0.478 * pesq_mos - 0.007 * wss_v + 0.063 * segsnr_v
    covl = 1.594 + 0.805 * pesq_mos - 0.512 * llr_v - 0.007 * wss_v
    return {"csig": _mos_clip(csig), "cbak": _mos_clip(cbak),
            "covl": _mos_clip(covl)}


def composite(clean: np.ndarray, processed: np.ndarray, sr: int,
              *, pesq_mos: Optional[float] = None) -> Dict[str, float]:
    """All composite measures for one utterance.

    ``pesq_mos``: pass a precomputed PESQ score to avoid recomputation; when
    None it is computed with metrics.pesq (composite.m likewise feeds PESQ
    into the regression).
    """
    if pesq_mos is None:
        from dcs_net_tpu_torch.metrics.pesq import pesq
        pesq_mos = pesq(np.asarray(clean), np.asarray(processed), sr)
    seg = segsnr(clean, processed, sr)
    llr_v = llr(clean, processed, sr)
    wss_v = wss(clean, processed, sr)
    out = {"pesq": float(pesq_mos), "segsnr": seg, "llr": llr_v, "wss": wss_v}
    out.update(csig_cbak_covl(pesq_mos, llr_v, wss_v, seg))
    return out
