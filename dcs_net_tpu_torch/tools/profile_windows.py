"""Which ``torch.profiler`` windows lose kernel records on the card.

``python -m dcs_net_tpu_torch.tools.profile_windows [--windows 6] [--big 60000]
[--carried N]``

Captures a full-width DCS ``enhance_full`` (4 requests of 4 s, random
weights, seed 0) through a ``models/graphed.py`` ``GraphCache``, then
profiles ``--windows`` graphed and as many eager calls, each in a window of
its own: opened plainly (one call), and with a warm-up step whose records
are dropped (``utils/timing.py:profiled``). It does so in a fresh process
and after each of two large windows (``--big`` small kernels in one
window). A call launches the same kernels every time, so every count below
the largest is a window that lost records. Prints, per set of windows, the
port's kernels (``PORT_KERNELS``), all device kernels and the busy ms of
each window.

``--carried N`` instead profiles ``chip_smoke.py`` phase "stream"'s
carried stream (the streaming preset, 10 s in chunks of 256 frames, the
LSTM state carried), N windows of its eager call and N of its graphed
call, each opened as ``utils/timing.py:profiled`` opens one, with CPU and
CUDA activities and with CUDA's alone: per window the kernels counted and
the seconds the window took, and for
every window below the largest count of its kind the kernel names it holds
fewer of, by how many, and at what share of the call's kernels (by start
time) the window's first and last missing launch would have fallen.
"""

from __future__ import annotations

import argparse
import re

# the port's kernel symbols, as the profiler names them
PORT_KERNELS = ("stft_fft_kernel", "stft_fft_mixed_kernel", "stft_dense_kernel",
                "conv_same_kernel", "conv7_kernel", "sa_pool_kernel", "sa_gate_kernel",
                "sa_gate_real_kernel", "tapconv_kernel", "pack_kernel")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--windows", type=int, default=6)
    p.add_argument("--big", type=int, default=60000)
    p.add_argument("--carried", type=int, default=0, metavar="N")
    args = p.parse_args(argv)
    if args.carried:
        return carried(args.carried)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.utils.timing import profiled

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    port = re.compile(r"\b(?:" + "|".join(PORT_KERNELS) + r")\b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_for_variant("dcs")
    model = DCSNet(cfg.model, cfg.quirks, device="cuda", seed=0).eval()
    g = torch.Generator().manual_seed(1)
    x = (0.1 * torch.randn(4, 4 * cfg.data.sr, generator=g)).cuda()
    graphs = GraphCache()
    calls = {"graphed": lambda: enhance_full(model, x, cfg, graphs=graphs),
             "eager": lambda: enhance_full(model, x, cfg)}
    for _ in range(3):
        calls["graphed"]()
    torch.cuda.synchronize()

    def kernels_of(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation]

    def plain(fn):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        return kernels_of(prof)

    def window(fn, warm):
        kernels = profiled(fn)[3] if warm else plain(fn)
        return (sum(e.count for e in kernels if port.search(e.key)),
                sum(e.count for e in kernels),
                round(sum(e.self_device_time_total for e in kernels) / 1e3, 3))

    t = torch.zeros(16, device="cuda")
    for when in ("a fresh process", "a large window", "a second large window"):
        if when != "a fresh process":
            kernels = plain(lambda: [t.add_(1) for _ in range(args.big)])
            print(f"large window: {sum(e.count for e in kernels)} kernels of {args.big}",
                  flush=True)
        for warm in (False, True):
            for what, fn in calls.items():
                res = [window(fn, warm) for _ in range(args.windows)]
                print(f"after {when}, {'with' if warm else 'without'} a warm-up step, "
                      f"{what}: (port kernels, kernels, busy ms) {res} "
                      f"[{torch.cuda.get_device_name(0)}]", flush=True)


def carried(n: int) -> None:
    """The ``--carried`` census (see the module docstring)."""
    import collections
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.enhance import enhance_streaming
    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.models.unet import DCSNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = config_for_variant("dcs", streaming=True)
    model = DCSNet(cfg.model, cfg.quirks, device="cuda", seed=0).eval()
    g = torch.Generator().manual_seed(1)
    x = (0.1 * torch.randn(1, 10 * cfg.data.sr, generator=g)).cuda()
    graphs = GraphCache()

    def run(gc):
        return enhance_streaming(model, x, cfg, chunk_frames=256, overlap=0,
                                 carry_lstm_state=True, graphs=gc)

    for _ in range(3):
        run(graphs)
    torch.cuda.synchronize()

    def window(fn, activities):
        """The second call's kernels (name, start) in start order, as
        ``utils/timing.py:profiled`` opens its window, and its seconds."""
        t0 = time.perf_counter()
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
        return (sorted(((e.name, e.time_range.start) for e in ev), key=lambda t: t[1]),
                time.perf_counter() - t0)

    both, device = [ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]
    for what, gc, acts in (("eager", None, both), ("eager, CUDA only", None, device),
                           ("graphed", graphs, both), ("graphed, CUDA only", graphs, device)):
        wins, secs = zip(*[window(lambda: run(gc), acts) for _ in range(n)])
        counts = [len(w) for w in wins]
        print(f"carried stream, {what}: kernels per window {counts}, seconds per window "
              f"{[round(t, 1) for t in secs]}", flush=True)
        full = wins[int(np.argmax(counts))]
        want = collections.Counter(name for name, _ in full)
        for w in wins:
            if len(w) == len(full):
                continue
            got = collections.Counter(name for name, _ in w)
            short = {k: v - got[k] for k, v in want.items() if got[k] < v}
            extra = {k: v - want[k] for k, v in got.items() if want[k] < v}
            # the first and the last launch of the fullest window's order
            # that the window's own order departs from
            names, have = [k for k, _ in full], [k for k, _ in w]
            head = next((i for i, (a, b) in enumerate(zip(names, have)) if a != b),
                        len(have))
            tail = next((i for i, (a, b) in enumerate(zip(names[::-1], have[::-1]))
                         if a != b), len(have))
            top = sorted(short.items(), key=lambda kv: -kv[1])[:6]
            print(f"  a window of {len(w)}: short of {sum(short.values())} in "
                  f"{len(short)} names ({', '.join(f'{k[:60]} -{v}' for k, v in top)}), "
                  f"extra {sum(extra.values())} in {len(extra)} names; it departs from the "
                  f"fullest window's order between {head / len(names):.3f} and "
                  f"{1 - tail / len(names):.3f} of it", flush=True)


if __name__ == "__main__":
    main()
