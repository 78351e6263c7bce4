"""Batched objective-metric harness, the port's copy of the JAX package's
``metrics/harness.py``: loop over a batch, one metric per utterance, drop
NaNs and failures, return the batch mean (the original code's
``calc_metric``)."""

from __future__ import annotations

from typing import Callable

import numpy as np


def calc_metric(clean_audio: np.ndarray, predict_audio: np.ndarray, sr: int,
                metric: Callable[[np.ndarray, np.ndarray, int], float]) -> float:
    """Mean of ``metric(clean_i, predict_i, sr)`` over the batch, NaNs and
    utterances whose metric raised left out; 0.0 when none is left (the
    original code divides by max(len, 1))."""
    clean_audio = np.asarray(clean_audio)
    predict_audio = np.asarray(predict_audio)
    vals = []
    for i in range(predict_audio.shape[0]):
        try:
            v = metric(clean_audio[i], predict_audio[i], sr)
        except Exception:   # one utterance's failure leaves it out, as the original does
            continue
        if not np.isnan(v):
            vals.append(float(v))
    return float(sum(vals)) / max(len(vals), 1)


def stoi_metric(clean: np.ndarray, predicted: np.ndarray, sr: int) -> float:
    from dcs_net_tpu_torch.metrics.stoi import stoi

    return stoi(clean, predicted, sr)


def pesq_metric(clean: np.ndarray, predicted: np.ndarray, sr: int) -> float:
    """Raw P.862-style MOS through ``metrics/pesq.py``, called as pypesq is
    (clean, degraded, sr)."""
    from dcs_net_tpu_torch.metrics.pesq import pesq

    return pesq(clean, predicted, sr)


def si_sdr(clean: np.ndarray, predicted: np.ndarray, sr: int = 0) -> float:
    """Scale-invariant SDR in dB."""
    clean = np.asarray(clean, np.float64)
    predicted = np.asarray(predicted, np.float64)
    alpha = np.dot(predicted, clean) / (np.dot(clean, clean) + 1e-12)
    target = alpha * clean
    noise = predicted - target
    return float(10 * np.log10(
        (np.sum(target ** 2) + 1e-12) / (np.sum(noise ** 2) + 1e-12)))
