"""Numerical-debug tripwires, the port's copy of the JAX package's
``train/debug.py`` in PyTorch's idiom.

* ``sanitize_batch``: the host check for NaN and Inf over a nested batch
  before it goes to the device, naming the leaf;
* ``checked``: a step function run under ``torch.autograd.detect_anomaly()``,
  so a backward that makes a NaN raises and names the function that made it
  (the JAX package wraps its step with ``checkify``). Opt-in: it costs time;
* ``enable_debug_nans``: anomaly mode on or off for the whole process (the
  JAX package's ``jax_debug_nans``).

Nothing in the trainer calls them.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of nested dicts, lists and tuples; a path reads as
    ``['clean'][0]``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def sanitize_batch(batch: Any) -> None:
    """Raise ``FloatingPointError`` if a floating-point leaf (tensor or
    array) of ``batch`` holds NaN or Inf."""
    for name, leaf in _leaves(batch):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.all(np.isfinite(arr))
        if bad:
            raise FloatingPointError(f"Found inf/-inf/nan in batch leaf {name}")


def checked(step_fn: Callable) -> Callable:
    """``step_fn`` run under ``torch.autograd.detect_anomaly()``: a backward
    inside it that returns NaN raises ``RuntimeError`` naming the function."""

    @functools.wraps(step_fn)
    def run(*args, **kwargs):
        with torch.autograd.detect_anomaly():
            return step_fn(*args, **kwargs)

    return run


def enable_debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
