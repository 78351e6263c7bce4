"""Observability of training: the JSONL scalar writer and the throughput
meter (audio-seconds per second per GPU), the port's copy of the JAX
package's ``obs/logging.py`` without TensorBoard, audio or histograms."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

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
