"""Where the time of one full-width train step goes on the card.

``python -m dcs_net_tpu_torch.tools.profile_train [--variant dcs] [--batch 32]
[--crop 8160] [--reps 20] [--top 20] [--steps-per-dispatch K]
[--dtype bfloat16]``

Runs three warm-up steps and ``--reps`` timed steps of ``train_step`` (each
ended by ``torch.cuda.synchronize()``) of ``config_for_variant(--variant)``
(DCS by default), then one step under ``torch.profiler`` (CPU and CUDA
activities), and prints: the median step time and audio-seconds per second,
the step's wall time under the profiler, its kernel launches, the device busy
time (the sum of kernel self times) and idle share (against the profiled
step's wall and against the median step without the profiler, which the
profiler's own host work does not lengthen), the launches of the port's own
kernels, peak device memory, and the kernels with the most device time,
grouped by name. With ``--steps-per-dispatch K`` > 1 the unit is one
dispatch of the scanned step (``train/steps.py``): an eager dispatch, the
capture (its time and private pool printed), then ``--reps`` timed replays
and one replay under the profiler, its figures also per step; the port's
launches are those the capture counted, one replay's. Weights are random
(seed 0), the waves seeded noise: the work per step depends only on the
shapes. TF32 is off, as in the trainer. ``--dtype bfloat16`` trains at the
JAX package's ``--dtype bfloat16`` (any variant): bf16 operands, float32 sums
(cuBLAS's reduced-precision bf16 reduction off, as in the trainer).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variant", choices=("dr", "dc", "drs", "dcs"), default="dcs")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--crop", type=int, default=8160)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = p.parse_args(argv)
    k = args.steps_per_dispatch
    if k < 1:
        p.error(f"--steps-per-dispatch must be at least 1, got {k}")

    import torch

    from dcs_net_tpu_torch.cli.common import with_dtype
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import make_optimizer
    from dcs_net_tpu_torch.utils import cuda_lib
    from dcs_net_tpu_torch.utils.timing import profiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = with_dtype(config_for_variant(args.variant), args.dtype)
    torch.manual_seed(0)
    model = DCSNet(cfg.model, cfg.quirks, device="cuda", seed=0)
    opt = make_optimizer(model.parameters(), cfg.optim)
    g = torch.Generator().manual_seed(1)
    clean = 0.1 * torch.randn(k, args.batch, args.crop, generator=g)
    noisy = clean + 0.05 * torch.randn(k, args.batch, args.crop, generator=g)
    if k == 1:
        clean, noisy = clean[0].cuda(), noisy[0].cuda()

        def step():
            return steps.train_step(model, opt, steps.batch_from_waves(noisy, clean, cfg),
                                    cfg)

        for _ in range(3):
            step()
    else:
        scanned = steps.make_scanned_train_step(model, opt, cfg, k)

        def step():
            return scanned(noisy, clean)

        step()                      # the eager dispatch
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        step()                      # the capture and a replay
        print(f"captured {k} train steps in {scanned.capture_s:.2f} s, private pool "
              f"{scanned.pool_bytes / 2**30:.2f} GiB")
    torch.cuda.synchronize()
    if k == 1:
        torch.cuda.reset_peak_memory_stats()
    # with k > 1 the peak stays the capture's: a replay allocates nothing
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    unit = "steps" if k == 1 else f"replays of {k} steps"
    audio_s = k * args.batch * args.crop / cfg.data.sr
    if walls:
        walls.sort()
        med = walls[len(walls) // 2]
        print(f"{args.reps} {unit} without the profiler: wall min {walls[0]:.2f} ms, "
              f"median {med:.2f} ms ({med / k:.2f} a step), max {walls[-1]:.2f} ms; "
              f"{audio_s / med * 1e3:.1f} audio-s/s per GPU; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if k == 1:
        cuda_lib.reset_launch_counts()
    wall_ms, busy_ms, launches, kernels = profiled(step)
    ours = {kn.name: kn.launches for kn in cuda_lib.KERNELS.values() if kn.launches}
    print(f"{torch.cuda.get_device_name(0)}: {args.variant} at {args.dtype} "
          f"{'train_step' if k == 1 else f'replay of {k} train steps'} batch "
          f"{args.batch} x {args.crop} samples: wall {wall_ms:.2f} ms under the "
          f"profiler, {launches} kernel launches, device busy "
          f"{busy_ms:.2f} ms ({busy_ms / k:.2f} a step), idle share "
          f"{1 - busy_ms / wall_ms:.3f}"
          + (f" ({1 - busy_ms / med:.3f} of the median without the "
             "profiler)" if walls else ""))
    print(f"  the port's kernels: {ours}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
