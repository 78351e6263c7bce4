"""Checkpoints as torch state dicts: model (parameters and BN running
statistics), optimizer (Adam moments and step counts), the plateau
scheduler's state and the loop's epoch, one file per step
(``<dir>/step_<N>.pt``), plus the run's ``config.json``; the port's
counterpart of the JAX package's ``train/checkpoint.py`` (orbax), with
everything an exact mid-training resume needs.

Files are read with ``torch.load(weights_only=True)``: tensors and plain
containers only, never arbitrary pickled objects.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from dcs_net_tpu_torch.core.config import Config

FORMAT_VERSION = 1
MAX_TO_KEEP = 3         # the newest steps kept on disk
_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore under ``directory``, keeping the newest
    ``MAX_TO_KEEP`` steps."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, opt: torch.optim.Optimizer,
             *, extra: Optional[Dict] = None, config: Optional[Config] = None) -> str:
        """Write step ``step`` (through a temporary file, then a rename, so
        a crash leaves no half-written checkpoint) and prune old ones."""
        payload = {"format_version": FORMAT_VERSION, "step": step,
                   "model": model.state_dict(), "optim": opt.state_dict(),
                   "extra": extra or {}}
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config.to_json())
        for old in self.steps()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))
        return path

    def restore(self, model: torch.nn.Module, opt: torch.optim.Optimizer) -> Dict:
        """Load the latest step into ``model`` and ``opt``; returns the
        ``extra`` dict saved with it."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        found = payload.get("format_version")
        if found != FORMAT_VERSION:
            raise RuntimeError(f"checkpoint format {found} under {self.directory}; "
                               f"this build reads format {FORMAT_VERSION}")
        model.load_state_dict(payload["model"])
        opt.load_state_dict(payload["optim"])
        return payload["extra"]
