"""Device time of a function on the card, with the host's dispatch left out."""

from __future__ import annotations

from typing import Callable

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
