"""Checkpoints as torch state dicts: model (parameters and BN running
statistics), optimizer (Adam moments and step counts), the plateau
scheduler's state and the loop's epoch, one file per step
(``<dir>/step_<N>.pt``), plus the run's ``config.json``; the port's
counterpart of the JAX package's ``train/checkpoint.py`` (orbax). A
checkpoint is written at the end of an epoch and holds what a resume there
needs to train on as the uninterrupted run does (the dropout masks are keyed
by the seed and the epoch, ``train/loop.py``). Like the JAX package's, it
does not hold the SWA average: a run resumed after the SWA start epoch
begins its average anew.

Files are read with ``torch.load(weights_only=True)``: tensors and plain
containers only, never arbitrary pickled objects.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.train.optim import load_optimizer_state

FORMAT_VERSION = 1
MAX_TO_KEEP = 3         # the newest steps kept on disk
_NAME = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_steps(directory: str) -> List[int]:
    """The steps saved under ``directory``, oldest first (none where it does
    not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _load(directory: str, map_location) -> Dict:
    """The payload of the latest step under ``directory``, its tensors on
    ``map_location``."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    payload = torch.load(os.path.join(directory, f"step_{steps[-1]}.pt"),
                         map_location=map_location, weights_only=True)
    found = payload.get("format_version")
    if found != FORMAT_VERSION:
        raise RuntimeError(f"checkpoint format {found} under {directory}; "
                           f"this build reads format {FORMAT_VERSION}")
    return payload


def load_model(directory: str, model: torch.nn.Module) -> int:
    """Load the latest step's weights and BN statistics under ``directory``
    straight onto the model's device; returns the step."""
    payload = _load(directory, next(model.parameters()).device)
    model.load_state_dict(payload["model"])
    return int(payload["step"])


class CheckpointManager:
    """Save and restore under ``directory``, keeping the newest
    ``MAX_TO_KEEP`` steps."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        return checkpoint_steps(self.directory)

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
        """Load the latest step into ``model`` and ``opt`` (the learning
        rate in place, ``load_optimizer_state``); returns the ``extra`` dict
        saved with it."""
        payload = _load(self.directory, "cpu")
        model.load_state_dict(payload["model"])
        load_optimizer_state(opt, payload["optim"])
        return payload["extra"]
