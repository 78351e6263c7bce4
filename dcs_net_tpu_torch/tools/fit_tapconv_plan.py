"""Fit kernel 3's forward cost model to the sweep of ``chip_smoke.py``.

``python -m dcs_net_tpu_torch.tools.fit_tapconv_plan smoke.log [--bf16]``

Reads the ``kernel tapconv_valid sweep:`` lines of a ``chip_smoke.py`` log
(each a shape's times under every (bn, flat, wgs, S)), fits ``ms = waves *
steps * STEP_MS[wgs] + c`` by least squares on the relative error, where a
block runs ``steps`` taps and channel chunks (``_live_taps``) and the grid's
clusters of S take ``waves`` at ``H100_CLUSTERS`` at a time, and prints the
fitted ``STEP_MS``, the model's error, and for each shape the sweep's fastest
tiling beside the one ``forward_plan`` picks and the one the fit would pick.
``--bf16`` does the same for the bf16 class's staged body on the ``kernel
tapconv_valid_bf16 sweep:`` lines (``STEP_MS_BF16``: every tap of its
16-channel chunks runs, ``staged_tiling``'s tiles). Runs on the CPU; the
log comes from the card.
"""

from __future__ import annotations

import argparse
import re

import numpy as np

from dcs_net_tpu_torch.ops import cuda_tapconv as ct

SHAPE = re.compile(r"x \((\d+), (\d+), (\d+), (\d+)\) -> N (\d+), (\d+)x(\d+), "
                   r"pad \((\d+), (\d+), (\d+), (\d+)\)")
TIMED = re.compile(r"\((\d+), (\d), (\d), (\d)\)=([0-9.]+)")


def read_sweep(path, kernel="tapconv_valid"):
    """{(B, H, W, Cin, N, Dh, Dw, pad): {(bn, flat, wgs, S): ms}} of the
    sweep lines of ``kernel``."""
    sweep = {}
    with open(path) as f:
        for line in f:
            if not line.startswith(f"kernel {kernel} sweep:"):
                continue
            m = SHAPE.search(line)
            B, H, W, cin, n, dh, dw, *pad = map(int, m.groups())
            times = line.split(" ms: ", 1)[1].split("; the plan", 1)[0]
            sweep[(B, H, W, cin, n, dh, dw, tuple(pad))] = {
                tuple(map(int, t.groups()[:4])): float(t[5])
                for t in TIMED.finditer(times)}
    return sweep


def features(shape, plan, bf16=False):
    """(waves * steps at one warpgroup, the same at two, 1) of a plan (of
    the staged body at ``bf16``)."""
    B, H, W, cin, n, dh, dw, pad = shape
    bn, flat, wgs, split = plan
    ho, wo = H + pad[0] + pad[1] - dh + 1, W + pad[2] + pad[3] - dw + 1
    if bf16:
        tiles = B * ct.staged_tiling(flat, wgs, ho, wo, dh, dw)[0] * (1 if flat else ho)
        waves = -(-tiles * -(-n // bn) // ct.H100_CLUSTERS[split])
        steps = waves * -(-(-(-cin // ct.STAGED_KB)) // split) * dh * dw
    else:
        taps = ct._live_taps(flat, wgs, H, ho, wo, pad[0], dh, dw)
        waves = -(-B * len(taps) * -(-n // bn) // ct.H100_CLUSTERS[split])
        steps = waves * -(-cin // ct.BK // split) * max(taps)
    return (steps if wgs == 1 else 0, steps if wgs == 2 else 0, 1.0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("log", help="a chip_smoke.py log with its sweep lines")
    p.add_argument("--bf16", action="store_true",
                   help="fit the bf16 class's staged body (STEP_MS_BF16)")
    args = p.parse_args(argv)
    bf16 = args.bf16
    sweep = read_sweep(args.log, "tapconv_valid_bf16" if bf16 else "tapconv_valid")
    rows = [(shape, plan, ms) for shape, times in sweep.items()
            for plan, ms in times.items()]
    X = np.array([features(s, pl, bf16) for s, pl, _ in rows])
    y = np.array([ms for _, _, ms in rows])
    coef = np.linalg.lstsq(X / y[:, None], np.ones(len(y)), rcond=None)[0]
    rel = np.abs(X @ coef - y) / y
    name, in_use = ("STEP_MS_BF16", ct.STEP_MS_BF16) if bf16 else ("STEP_MS", ct.STEP_MS)
    print(f"{name} = {{1: {coef[0]:.5f}, 2: {coef[1]:.5f}}} (constant {coef[2]:.4f} ms); "
          f"relative error median {np.median(rel):.3f}, max {rel.max():.3f}, "
          f"over {len(rows)} timings; in use: {in_use}")
    for shape, times in sweep.items():
        B, H, W, cin, n, dh, dw, pad = shape
        fastest = min(times, key=times.get)
        fitted = min(times, key=lambda pl: (np.dot(features(shape, pl, bf16)[:2], coef[:2])))
        plan = ct.forward_plan(B, H, W, cin, n, dh, dw, pad, bf16=bf16)
        print(f"x ({B}, {H}, {W}, {cin}) -> N {n}: the sweep's fastest {fastest} "
              f"{times[fastest]:.4f} ms; forward_plan {plan} "
              f"{times.get(plan, float('nan')):.4f}; the fit's pick {fitted} "
              f"{times[fitted]:.4f}")


if __name__ == "__main__":
    main()
