"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Without a GPU
they raise rather than carry on quietly on the CPU.

:func:`device_cache` is the cache of the constants the port makes once on a
device, which a captured CUDA graph (``models/graphed.py``) reads by address.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Hashable, Iterator, List, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. Returns a ``torch.device`` of type cuda or cpu;
    raises if CUDA is asked for (explicitly or by default) and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to run "
            "the plain PyTorch versions of the kernels on the CPU")
    return dev


# The dicts of the graph entries recording (at their warm-up) or reading (at
# their capture) the device constants they use: see :func:`holding`.
_holders: List[Dict[Hashable, Any]] = []


def device_cache(maxsize: int) -> Callable[[Callable], Callable]:
    """``functools.lru_cache(maxsize)`` for a function that makes constants
    on a device (bases, windows, folds, a zero bias), with one addition for
    CUDA graphs, which read such a constant by its address on every replay:
    while a dict is held by :func:`holding`, every value the function returns
    is put into that dict, and a key found there is answered from it. A
    graph entry holds its dict from its warm-up to its capture and keeps it
    for as long as the graph lives, so the constants the graph reads outlive
    it whatever the cache evicts meanwhile, and its capture makes no
    host-to-device copy. Positional arguments only."""
    def wrap(fn: Callable) -> Callable:
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            key = (get, args)
            for held in _holders:
                if key in held:
                    return held[key]
            value = cached(*args)
            for held in _holders:
                held[key] = value
            return value

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get
    return wrap


@contextlib.contextmanager
def holding(held: Dict[Hashable, Any]) -> Iterator[Dict[Hashable, Any]]:
    """Within the block, the :func:`device_cache` functions record their
    values into ``held`` and answer from it first."""
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)
