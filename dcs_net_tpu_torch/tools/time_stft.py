"""Kernel 1 at given shapes on the card, with whichever ``dcs_net_tpu_torch``
is first on the path, so two trees compare in one process each:

    PYTHONPATH=<tree> python3 dcs_net_tpu_torch/tools/time_stft.py \\
        [--n-fft 512] [--hop 32] [--shapes 4x64000,32x8160] [--repeats 5]

(from the repository root; ``PYTHONPATH=.`` for this tree, or the root of
an unpacked ``git archive`` of another commit). For each (B, n) it prints
one JSON line: the package's path, the device time a call (a CUDA graph of
50 calls, one replay timed with CUDA events, ``--repeats`` times), the
error against the plain version relative to its largest value, and a
float64 sum of the output (equal sums: equal outputs, for the same seeded
input). Seeded inputs: ``torch.randn`` on the card, seed 0, times 0.3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.dsp import stft as dsp
from dcs_net_tpu_torch.dsp import stft_cuda
from dcs_net_tpu_torch.utils.timing import graph_ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-fft", type=int, default=512)
    ap.add_argument("--hop", type=int, default=32)
    ap.add_argument("--shapes", default="4x64000,32x8160")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(config_for_variant("dcs").stft, n_fft=args.n_fft,
                              hop=args.hop, win_length=args.n_fft)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in args.shapes.split(","):
        B, n = (int(v) for v in shape.split("x"))
        x = torch.randn((B, n), generator=g, device=dev) * 0.3
        plan = dsp._analysis_plan(cfg, dev)
        cos_b, sin_b = dsp._on_device(dsp._dft_basis_eff, cfg, dev)
        got = stft_cuda.stft_analysis(x, plan)
        want = stft_cuda.stft_dft_plain(x, cos_b, sin_b, cfg.hop, plan.pad)
        err = (max(float((a - b).abs().max()) for a, b in zip(got, want))
               / max(float(b.abs().max()) for b in want))
        ms = [graph_ms(lambda: stft_cuda.stft_analysis(x, plan), 50)
              for _ in range(args.repeats)]
        print(json.dumps({"package": stft_cuda.__file__, "n_fft": cfg.n_fft,
                          "hop": cfg.hop, "shape": [B, n], "ms": ms, "rel_err": err,
                          "sum": float(sum(t.double().sum() for t in got))}), flush=True)


if __name__ == "__main__":
    main()
