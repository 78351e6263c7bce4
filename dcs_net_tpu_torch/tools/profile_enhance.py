"""Where the time of one full-width DCS ``enhance_full`` call goes on the card.

``python -m dcs_net_tpu_torch.tools.profile_enhance [--batch 4] [--seconds 4]``

Runs one warm-up call, then one call under ``torch.profiler`` (CPU and CUDA
activities), and prints: the call's wall time, the device busy time (the sum
of kernel self times) and idle share, and the kernels with the most device
time, grouped by name. Weights are random (seed 0) and the input is seeded
noise: the work per call depends only on the shapes. TF32 is off, as in the
parity runs.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.models.unet import DCSNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_for_variant("dcs")
    model = DCSNet(cfg.model, cfg.quirks, device="cuda", seed=0).eval()
    n = int(args.seconds * cfg.data.sr)
    g = torch.Generator().manual_seed(1)
    x = (0.1 * torch.randn(args.batch, n, generator=g)).cuda()
    enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enhance_full(model, x, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{torch.cuda.get_device_name(0)}: enhance_full batch {args.batch} x "
          f"{args.seconds} s: wall {wall_ms:.2f} ms under the profiler, device "
          f"busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
