"""Device time of a function on the card: with the host's dispatch left out
(:func:`graph_ms`), and the busy time of one call under the profiler
(:func:`profiled`; :func:`profiled_whole` where the window must hold every
kernel record)."""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

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
    ended by a synchronize, after a warm-up call in the same session whose
    records are dropped: (wall ms, device busy ms, kernel launches, the
    kernels' profiler events), all of the second call. Busy is the sum of
    the kernels' self device times; an annotated range (the optimizer's
    step) also reports device time and is left out, so that its kernels
    count once. The warm-up step: a window opened without one after a large
    window loses the records of its first kernels; with the step none did
    (``tools/profile_windows.py`` on the H100)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return wall_ms, busy_ms, sum(e.count for e in kernels), kernels


def profiled_whole(fn: Callable[[], object], tries: int = 6
                   ) -> Tuple[Optional[Tuple[float, float, int, List]], int]:
    """:func:`profiled` windows of ``fn`` until two agree on the largest
    kernel count seen: a window, warm-up step and all, still loses records
    now and then, and never gains any, so for a call that launches the same
    kernels every time that count is the call's. A window of a call with
    tens of thousands of eager launches loses records of its first launches,
    by how many varies (the eager carried stream on the H100: 86 to 205 of
    its first launches short of its fullest window of 28245,
    ``tools/profile_windows.py --carried``), so its largest count may show
    once and never again: after ``tries`` windows the largest count that two
    windows agree on is taken. Returns the first window with the count and
    the windows taken, or None and ``tries`` where no two agreed."""
    seen = []
    for _ in range(tries):
        seen.append(profiled(fn))
        top = max(w[2] for w in seen)
        whole = [w for w in seen if w[2] == top]
        if len(whole) >= 2:
            return whole[0], len(seen)
    counts = [w[2] for w in seen]
    agreed = [n for n in set(counts) if counts.count(n) >= 2]
    if not agreed:
        return None, len(seen)
    return next(w for w in seen if w[2] == max(agreed)), len(seen)
