"""Observability of training: the JSONL scalar writer (with audio samples as
WAV files), the throughput meter (audio-seconds per second per GPU) and the
per-epoch audio samples; the port's copy of the JAX package's
``obs/logging.py`` without TensorBoard and histograms. Audio takes the JAX
writer's own route where TensorBoard cannot take it: a PCM16 WAV under
``<log_dir>/audio/``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from dcs_net_tpu_torch.data.audio_io import write_wav

WINDOW = 50     # step ticks the throughput meter averages over


class Writer:
    """Scalars as JSON lines (``{"t", "tag", "value", "step"}``) appended to
    ``<log_dir>/events.jsonl``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag,
                                      "value": float(value), "step": step}) + "\n")

    def scalars(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in metrics.items():
            self.scalar(prefix + k, v, step)

    def audio(self, tag: str, wave: np.ndarray, step: int, sr: int) -> None:
        """One clip as ``<log_dir>/audio/<tag>_step<step>.wav`` (``/``, ``(``
        and ``)`` in the tag become ``_``), scaled into [-1, 1] if it peaks
        above 1."""
        w = np.asarray(wave, np.float32).reshape(-1)
        peak = np.abs(w).max()
        if peak > 1.0:
            w = w / peak
        safe = tag.replace("/", "_").replace("(", "_").replace(")", "_")
        out_dir = os.path.join(self.log_dir, "audio")
        os.makedirs(out_dir, exist_ok=True)
        write_wav(os.path.join(out_dir, f"{safe}_step{step}.wav"), w, sr)

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class ThroughputMeter:
    """Steps per second and audio-seconds per second (per GPU) over the
    last ``WINDOW`` step ticks on the host clock."""

    def __init__(self, audio_seconds_per_step: float):
        self.aps = audio_seconds_per_step
        self._times = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > WINDOW + 1:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else None

    @property
    def audio_seconds_per_sec(self) -> Optional[float]:
        sps = self.steps_per_sec
        return None if sps is None else sps * self.aps


def log_epoch_audio(writer: Writer, audio: Dict[str, np.ndarray], step: int,
                    sr: int, phase: str, rng: np.random.Generator,
                    sample_size: int = 1) -> None:
    """``sample_size`` utterances of one batch, drawn with ``rng``, each
    stream written as ``<stream>(<phase>)/<j>`` (the original code's
    per-epoch audio samples)."""
    streams = {k: np.asarray(v) for k, v in audio.items()}
    if not streams:
        return
    batch = next(iter(streams.values())).shape[0]
    for j, idx in enumerate(rng.choice(batch, size=min(sample_size, batch),
                                       replace=False)):
        for name, wav in streams.items():
            writer.audio(f"{name}({phase})/{j}", wav[idx], step, sr)
