"""Shape-keyed CUDA graphs of eval-mode functions: the port's ``jax.jit``.

The JAX package compiles each eval-mode path once per shape
(``jax.jit(enhance_full)``, the streaming scan, the jitted eval step). The
port's :class:`GraphCache` captures it once per shape: ``cache(fn, *tensors,
**static)`` is ``fn(*tensors, **static)`` under ``torch.no_grad()``, and on
the card, for each key (``fn``, the static arguments, the tensors' shapes,
dtypes and devices):

* the first call runs ``fn`` eagerly: the warm-up, whose output is real. It
  builds the kernels, makes the device constants (``utils/device.py``'s
  ``device_cache``; the entry holds them from here on), the cuDNN handles,
  the LSTM's flat weights and kernel 3's plans, none of which may happen
  inside a capture;
* the second call copies the tensors into static buffers and captures
  ``fn`` on them into one ``torch.cuda.CUDAGraph`` (global capture mode),
  then replays it;
* every later call copies the tensors in, replays, and returns clones of the
  static outputs, so no caller holds memory the next replay overwrites.

Parameters and BN buffers are read in place: Adam, SWA's copy, the BN
refresh and ``load_state_dict`` all write in place, so a replay sees the
weights as they are now. Each entry keeps its capture seconds, the memory
the capture added to the cache's pool, the kernel launches a replay makes
(counted while the capture ran ``fn``: a replay runs no Python) and its
replays. A cache holds at most ``MAX_ENTRIES`` keys and drops the least
recently used. One
cache's graphs share one memory pool: their replays run in series on one
stream and their outputs are cloned before the next replay.

On the CPU ``fn`` is simply called: the plain path. On the card nothing
falls back to eager: a capture or replay that fails raises.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from dcs_net_tpu_torch.utils import cuda_lib
from dcs_net_tpu_torch.utils.device import holding

Tensor = torch.Tensor
# keys a cache holds, read at every call. Unmeasured: the callers hold far
# fewer (the enhance CLI 1, a Trainer 2: its full and its last ragged eval
# batch; the smoke's keep-alive check 21)
MAX_ENTRIES = 32


def _capturable(t: Tensor) -> bool:
    """Whether calls on ``t``'s device are captured (on the CPU they run)."""
    return t.is_cuda


def _capture(body: Callable[[], Any], pool, device: torch.device
             ) -> Tuple[torch.cuda.CUDAGraph, Any, Any, int]:
    """``body`` captured into a new CUDA graph in ``pool`` (a new pool where
    None): (the graph, body's outputs, the pool, the device memory the
    capture added to the pool). Capture executes nothing: the outputs hold
    their values after a replay."""
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    reserved = _pool_bytes(pool, device)
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    torch.cuda.synchronize(device)
    return graph, out, pool, _pool_bytes(pool, device) - reserved


def _pool_bytes(pool, device: torch.device) -> int:
    """The device memory the caching allocator holds in ``pool``."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool)
               and s["device"] == device.index)


def _launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in cuda_lib.KERNELS.values()}


class Entry:
    """One key's state: its constants, and after the capture its graph,
    static inputs and outputs."""

    def __init__(self):
        self.constants: Dict[Hashable, Any] = {}
        self.warm = False
        self.graph = None
        self.inputs: List[Tensor] = []
        self.outputs: List[Tensor] = []
        self.spec = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.launches: Dict[str, int] = {}
        self.replays = 0


class GraphCache:
    """``cache(fn, *tensors, **static)``: see the module's docstring.
    ``fn`` must take the tensors positionally and return a tensor or a
    (nested) tuple, list or dict of tensors; the static arguments must be
    hashable (a module counts by identity) and are held as long as their
    entry is."""

    def __init__(self):
        self.entries: "OrderedDict[Hashable, Entry]" = OrderedDict()
        self.pool = None

    def __len__(self) -> int:
        return len(self.entries)

    def clear(self) -> None:
        self.entries.clear()

    def entry(self, fn: Callable, *tensors: Tensor, **static) -> Optional[Entry]:
        """The entry of this call's key, if the cache holds one."""
        return self.entries.get(self._key(fn, tensors, static))

    @staticmethod
    def _key(fn, tensors, static) -> Hashable:
        return (fn, tuple(sorted(static.items())),
                tuple((tuple(t.shape), t.dtype, t.device) for t in tensors))

    def __call__(self, fn: Callable, *tensors: Tensor, **static):
        with torch.no_grad():
            if not tensors or not _capturable(tensors[0]):
                return fn(*tensors, **static)
            key = self._key(fn, tensors, static)
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = Entry()
                while len(self.entries) > MAX_ENTRIES:
                    self.entries.popitem(last=False)
            self.entries.move_to_end(key)
            if not entry.warm:
                with holding(entry.constants):
                    out = fn(*tensors, **static)
                entry.warm = True
                return out
            if entry.graph is None:
                self._capture(entry, fn, tensors, static)
            else:
                for dst, src in zip(entry.inputs, tensors):
                    dst.copy_(src)
            entry.graph.replay()
            entry.replays += 1
            return pytree.tree_unflatten([t.clone() for t in entry.outputs], entry.spec)

    def _capture(self, entry: Entry, fn, tensors, static) -> None:
        entry.inputs = [torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
                        for t in tensors]
        before = _launch_counts()
        t0 = time.perf_counter()
        with holding(entry.constants):
            graph, out, self.pool, entry.pool_bytes = _capture(
                lambda: fn(*entry.inputs, **static), self.pool, tensors[0].device)
        entry.capture_s = time.perf_counter() - t0
        entry.launches = {k: n - before.get(k, 0) for k, n in _launch_counts().items()
                          if n != before.get(k, 0)}
        entry.outputs, entry.spec = pytree.tree_flatten(out)
        entry.graph = graph


def call(graphs: Optional[GraphCache], fn: Callable, *tensors: Tensor, **static):
    """``fn(*tensors, **static)`` through ``graphs``, or eagerly where it is
    None (the plain path, still under ``no_grad``)."""
    if graphs is not None:
        return graphs(fn, *tensors, **static)
    with torch.no_grad():
        return fn(*tensors, **static)
