"""Synthetic VoiceBank-DEMAND-shaped fixtures, the port's copy of the JAX
package's ``data/synthetic.py``: a tree with the dataset's on-disk layout
(clean and noisy trainset and testset wavs, 48 kHz PCM16). Clean signals are
harmonic "vowels" with an AM envelope; noisy = clean + filtered noise at a
random SNR, the additive assumption behind noise = noisy - clean. The tree
is the 28-speaker set at 48 kHz, drawn from seed 0."""

from __future__ import annotations

import os

import numpy as np

from dcs_net_tpu_torch.core.config import DataConfig
from dcs_net_tpu_torch.data import partition as P
from dcs_net_tpu_torch.data.audio_io import write_wav

FILE_SR = 48000
DATASET_TYPE = 28
SEED = 0


def _voice_like(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    f0 = rng.uniform(90, 250)
    t = np.arange(n) / sr
    sig = np.zeros(n)
    for h in range(1, 6):
        sig += rng.uniform(0.2, 1.0) / h * np.sin(
            2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t))
    sig = sig * env
    return (0.3 * sig / (np.abs(sig).max() + 1e-9)).astype(np.float32)


def _noise_like(rng: np.random.Generator, n: int) -> np.ndarray:
    white = rng.standard_normal(n + 64)
    kernel = np.hanning(65)
    colored = np.convolve(white, kernel / kernel.sum(), mode="valid")[:n]
    return (colored / (np.abs(colored).max() + 1e-9)).astype(np.float32)


def generate(root: str, n_train: int = 12, n_test: int = 4,
             seconds: float = 1.2) -> DataConfig:
    """Write the fixture tree under ``root`` and return a DataConfig that
    points at it."""
    rng = np.random.default_rng(SEED)
    cfg = DataConfig(root=root, dataset_type=DATASET_TYPE, file_sr=FILE_SR)
    n = int(seconds * FILE_SR)

    def write_set(clean_dir: str, noisy_dir: str, prefix: str, count: int):
        os.makedirs(clean_dir, exist_ok=True)
        os.makedirs(noisy_dir, exist_ok=True)
        for i in range(count):
            clean = _voice_like(rng, n, FILE_SR)
            snr_db = rng.uniform(0, 15)
            noise = _noise_like(rng, n)
            noise = noise * np.sqrt(np.mean(clean ** 2) / (np.mean(noise ** 2) + 1e-12)
                                    / (10 ** (snr_db / 10)))
            name = f"{prefix}{i:03d}_{i:03d}.wav"
            write_wav(os.path.join(clean_dir, name), clean, FILE_SR)
            write_wav(os.path.join(noisy_dir, name), np.clip(clean + noise, -1, 1),
                      FILE_SR)

    write_set(P.trainset_dir(cfg), P.noisy_trainset_dir(cfg), "p", n_train)
    write_set(P.testset_dir(cfg, clean=True), P.testset_dir(cfg, clean=False),
              "t", n_test)
    return cfg
