"""Where the time of one full-width enhance call goes on the card.

``python -m dcs_net_tpu_torch.tools.profile_enhance [--variant dcs] [--batch 4]
[--seconds 4] [--stream [--carry] [--chunk-frames 256] [--overlap 64]
[--chunk-batch 8]] [--eager]``

Runs ``enhance_full`` (or, with ``--stream``, ``enhance_streaming``;
``--carry`` takes the streaming preset and no overlap) of
``config_for_variant(--variant)`` (DCS by default) through a
``models/graphed.py`` ``GraphCache``, as the enhance CLI does: two calls
that warm up and capture the graph, ``--reps`` timed calls, then one call
under ``torch.profiler`` (CPU and CUDA activities), from a window that lost
no kernel records (``utils/timing.py:profiled_whole``). ``--eager`` runs the
eager path instead (one warm-up call). Prints the call's wall time, its
device kernels (and, graphed, the port's kernel launches a replay makes,
counted at the capture, and the replays a call), the device busy time (the
sum of kernel self times) and idle share, and the kernels with the most
device time, grouped by name. Weights are random (seed 0) and the input is
seeded noise: the work per call depends only on the shapes. TF32 is off, as
in the parity runs.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variant", choices=("dr", "dc", "drs", "dcs"), default="dcs")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--reps", type=int, default=10,
                   help="calls timed without the profiler before the profiled one")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--carry", action="store_true")
    p.add_argument("--chunk-frames", type=int, default=256)
    p.add_argument("--overlap", type=int, default=None)
    p.add_argument("--chunk-batch", type=int, default=8)
    p.add_argument("--eager", action="store_true",
                   help="the eager path, without CUDA graphs")
    args = p.parse_args(argv)
    if args.carry:
        args.stream = True
    if args.overlap is None:
        args.overlap = 0 if args.carry else min(64, args.chunk_frames // 4)

    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models import enhance
    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.utils.timing import profiled_whole

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_for_variant(args.variant, streaming=args.carry)
    model = DCSNet(cfg.model, cfg.quirks, device="cuda", seed=0).eval()
    n = int(args.seconds * cfg.data.sr)
    g = torch.Generator().manual_seed(1)
    x = (0.1 * torch.randn(args.batch, n, generator=g)).cuda()

    graphs = None if args.eager else GraphCache()

    def call():
        if args.stream:
            return enhance.enhance_streaming(
                model, x, cfg, chunk_frames=args.chunk_frames,
                overlap=args.overlap, carry_lstm_state=args.carry,
                chunk_batch=args.chunk_batch, graphs=graphs)
        return enhance.enhance_full(model, x, cfg, graphs=graphs)

    for _ in range(1 if args.eager else 2):
        call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if walls:
        walls.sort()
        print(f"{args.reps} calls without the profiler: wall min {walls[0]:.2f} ms, "
              f"median {walls[len(walls) // 2]:.2f} ms, max {walls[-1]:.2f} ms")

    def replays():
        return 0 if graphs is None else sum(e.replays for e in graphs.entries.values())

    before = replays()
    call()
    a_call = replays() - before
    window, taken = profiled_whole(call)
    what = "enhance_full"
    if args.stream:
        what = (f"enhance_streaming (chunks of {args.chunk_frames}, overlap "
                f"{args.overlap}, " + ("LSTM carry" if args.carry
                                       else f"groups of {args.chunk_batch}") + ")")
    if graphs is None:
        how = "eager"
    else:
        (entry,) = graphs.entries.values()
        how = (f"graphed: {a_call} replays a call, a replay's launches of the port's kernels "
               f"{entry.launches}, captured in {entry.capture_s:.3f} s, pool "
               f"{entry.pool_bytes} bytes")
    head = (f"{torch.cuda.get_device_name(0)}: {args.variant} {what} batch "
            f"{args.batch} x {args.seconds} s, {how}")
    if window is None:
        print(f"{head}: busy not measured, no two of {taken} profiler windows agreed "
              "on the call's kernel count")
        return
    wall_ms, busy_ms, launches, kernels = window
    print(f"{head}: wall {wall_ms:.2f} ms under the profiler, {launches} device "
          f"kernels (the first of {taken} windows with the call's count), device "
          f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
