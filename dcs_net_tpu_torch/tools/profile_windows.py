"""Which ``torch.profiler`` windows lose kernel records on the card.

``python -m dcs_net_tpu_torch.tools.profile_windows [--windows 6] [--big 60000]``

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
    args = p.parse_args(argv)

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


if __name__ == "__main__":
    main()
