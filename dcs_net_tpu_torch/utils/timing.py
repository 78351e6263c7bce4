"""Device time of a function on the card: with the host's dispatch left out
(:func:`graph_ms`), and the busy time of one call under the profiler
(:func:`profiled`)."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def graph_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card: after two warm-up
    calls on a side stream, ``iters`` calls are captured in one CUDA graph,
    and one replay of it is timed with CUDA events, so the host's dispatch
    (Python, ctypes, PyTorch's op overhead) drops out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn: Callable[[], object]) -> Tuple[float, float, int, List]:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA activities),
    ended by a synchronize: (wall ms, device busy ms, kernel launches, the
    kernels' profiler events). Busy is the sum of the kernels' self device
    times; an annotated range (the optimizer's step) also reports device
    time and is left out, so that its kernels count once."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall_ms, busy_ms, sum(e.count for e in kernels), kernels
