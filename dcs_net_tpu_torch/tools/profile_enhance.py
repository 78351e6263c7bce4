"""Where the time of one full-width enhance call goes on the card.

``python -m dcs_net_tpu_torch.tools.profile_enhance [--variant dcs] [--batch 4]
[--seconds 4] [--stream [--carry] [--chunk-frames 256] [--overlap 64]
[--chunk-batch 8]]``

Runs one warm-up call and ``--reps`` timed calls of ``enhance_full`` (or,
with ``--stream``, of ``enhance_streaming``; ``--carry`` takes the streaming
preset and no overlap) of ``config_for_variant(--variant)`` (DCS by
default), then one call under ``torch.profiler`` (CPU and CUDA activities),
and prints: the call's wall time, the number of kernel launches, the device
busy time (the sum of kernel self times) and idle share, and the kernels with
the most device time, grouped by name. Weights are random (seed 0) and the
input is seeded noise: the work per call depends only on the shapes. TF32 is
off, as in the parity runs.
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
    args = p.parse_args(argv)
    if args.carry:
        args.stream = True
    if args.overlap is None:
        args.overlap = 0 if args.carry else min(64, args.chunk_frames // 4)

    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models import enhance
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.utils.timing import profiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_for_variant(args.variant, streaming=args.carry)
    model = DCSNet(cfg.model, cfg.quirks, device="cuda", seed=0).eval()
    n = int(args.seconds * cfg.data.sr)
    g = torch.Generator().manual_seed(1)
    x = (0.1 * torch.randn(args.batch, n, generator=g)).cuda()

    def call():
        if args.stream:
            return enhance.enhance_streaming(
                model, x, cfg, chunk_frames=args.chunk_frames,
                overlap=args.overlap, carry_lstm_state=args.carry,
                chunk_batch=args.chunk_batch)
        return enhance.enhance_full(model, x, cfg)

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
    wall_ms, busy_ms, launches, kernels = profiled(call)
    what = "enhance_full"
    if args.stream:
        what = (f"enhance_streaming (chunks of {args.chunk_frames}, overlap "
                f"{args.overlap}, " + ("LSTM carry" if args.carry
                                       else f"groups of {args.chunk_batch}") + ")")
    print(f"{torch.cuda.get_device_name(0)}: {args.variant} {what} batch "
          f"{args.batch} x {args.seconds} s: wall {wall_ms:.2f} ms under the "
          f"profiler, {launches} kernel launches, device "
          f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
