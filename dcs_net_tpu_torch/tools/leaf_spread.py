"""How far a train step's gradient leaves move when nothing but rounding
changes, and where in the net that rounding moves them.

``python -m dcs_net_tpu_torch.tools.leaf_spread [--variant drs] [--dtype
bfloat16] [--device cpu] [--batch 4] [--orders 7] [--realizations 24]
[--width-divisor 1] [--float32-islands SPEC ...]``

On the first ``--batch`` waves of the batch ``chip_smoke.py``'s phase
"train" loads (480 synthetic pairs of 0.6 s, the numpy path), from seeded
weights with dropout off, it runs one train step of ``--variant`` at
``--dtype`` on ``--device`` (the base), ``--orders`` steps on the batch in
other orders (which reorder only the sums over the batch: the sum-order
witnesses of ``chip_smoke.py``) and ``--realizations`` steps on the waves
each moved by about one float32 unit (times 1 + 2^-23 n, n standard
normal: the same function on the same input to float32's resolution), and
a float32 step. For every gradient leaf above the residue floor (1e-5 of
the float32 step's largest) it takes the L2 distance from the base leaf
over the largest of the batch orders' distances (floored at 2.5e-3 of the
leaf), and prints the largest three and the median of these ratios for the
realizations and for the float32 step. ``--width-divisor D`` divides every
layer's channels (and the channel attention's reduction) by D.

``--float32-islands SPEC [SPEC ...]`` then repeats the batch orders, the
realizations and the float32 step with the children of the model that a
SPEC names (comma-separated ``fnmatch`` patterns, e.g. ``lstm`` or
``*_ca,*_sa``) run at float32 inside the bf16 net, their inputs widened and
their outputs rounded back to bf16: where the realizations' spread falls
there, the rounding that moves the leaves is inside those children.
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import itertools
import tempfile
import time


def first_batch(root: str, batch: int):
    """``chip_smoke.py`` phase "train"'s batch (32 x 8160 from 480 synthetic
    pairs of 0.6 s, the numpy path), its first ``batch`` waves: (noisy,
    clean) on the CPU."""
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data import synthetic
    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition

    dcfg = synthetic.generate(root, n_train=480, n_test=8, seconds=0.6)
    cfg = config_for_variant("dcs")
    cfg = cfg.replace(data=dataclasses.replace(dcfg, batch_size=32))
    loader = Loader(VoiceBankDataset(make_partition(cfg.data, seed=cfg.run.seed)["train"],
                                     cfg.data, "train"), 32, drop_last=True,
                    seed=cfg.run.seed, use_native=False)
    host = next(iter(loader.epoch(0)))
    loader.close()
    return (torch.from_numpy(host["noisy"][:batch]), torch.from_numpy(host["clean"][:batch]))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", choices=("dr", "dc", "drs", "dcs"), default="drs")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="bfloat16")
    p.add_argument("--device", default="cpu")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=16, help="the weights' seed")
    p.add_argument("--orders", type=int, default=7)
    p.add_argument("--realizations", type=int, default=24)
    p.add_argument("--width-divisor", type=int, default=1)
    p.add_argument("--float32-islands", nargs="*", default=[], metavar="SPEC")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dcs_net_tpu_torch.cli.common import with_dtype
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="leaf_spread_") as tmp:
        noisy, clean = first_batch(tmp, args.batch)
    cfg = config_for_variant(args.variant)
    d = args.width_divisor
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dropout_conv=0.0, dropout_fc=0.0,
        channels=(1,) + tuple(max(1, c // d) for c in cfg.model.channels[1:]),
        ca_reduction=max(1, cfg.model.ca_reduction // d)))
    c = with_dtype(cfg, args.dtype)
    weights = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=args.seed).state_dict()
    dev = torch.device(args.device)

    def islands(m, spec):
        """``m`` (bf16) with the children ``spec`` names swapped for their
        float32 twins, inputs widened and outputs rounded back."""
        if not spec:
            return m
        twin = DCSNet(cfg.model, cfg.quirks, device=dev)
        twin.load_state_dict(weights)

        def cast(v, dt):
            if isinstance(v, (tuple, list)):
                return type(v)(cast(t, dt) for t in v)
            return v.to(dt) if torch.is_tensor(v) and v.is_floating_point() else v

        def wrap(fn, lstm):
            def run(*a):
                out = fn(*cast(a, torch.float32))
                if lstm:                    # the state stays float32
                    return out[0].to(torch.bfloat16), out[1]
                return cast(out, torch.bfloat16)
            return run

        names = [n for n, _ in m.named_children()
                 if any(fnmatch.fnmatch(n, pat) for pat in spec.split(","))]
        for n in names:
            mod = getattr(twin, n)
            mod.forward = wrap(mod.forward, n == "lstm")
            if hasattr(mod, "gate"):
                mod.gate = wrap(mod.gate, False)
            setattr(m, n, mod)
        return m

    def grads(config, waves, perm, spec=""):
        m = DCSNet(config.model, config.quirks, device=dev)
        m.load_state_dict(weights)
        if config is c:
            m = islands(m, spec)
        torch.backends.cudnn.deterministic = True
        steps.train_step(m, make_optimizer(m.parameters(), config.optim), steps.batch_from_waves(
            waves[list(perm)].to(dev), clean[list(perm)].to(dev), config), config)
        return {n: q.grad.detach().cpu().double() for n, q in m.named_parameters()}

    order = tuple(range(args.batch))
    others = [q for q in itertools.permutations(order) if q != order]
    picks = np.random.default_rng(args.seed).choice(len(others), args.orders, replace=False)
    base = grads(c, noisy, order)
    orders = [grads(c, noisy, others[j]) for j in picks]
    reals = []
    for i in range(args.realizations):
        g = torch.Generator().manual_seed(args.seed + 1000 + i)
        reals.append(grads(c, noisy * (1 + 2.0 ** -23 * torch.randn(noisy.shape, generator=g)),
                           order))
    f32 = grads(cfg, noisy, order)
    floor = 1e-5 * max(float(v.abs().max()) for v in f32.values())
    leaves = [n for n in base if float(f32[n].abs().max()) >= floor]
    noise = np.array([max([float((o[n] - base[n]).norm()) for o in orders]
                          + [2.5e-3 * float(base[n].norm())]) for n in leaves])

    def describe(ratios):
        top = np.argsort(ratios)[::-1][:3]
        return (", ".join(f"{leaves[i]} {ratios[i]:.2f}" for i in top)
                + f"; median {np.median(ratios):.2f} over {len(leaves)} leaves")

    def dist(a, b):
        return np.array([float((a[n] - b[n]).norm()) for n in leaves])

    real_r = np.max([dist(r, base) / noise for r in reals], axis=0)
    print(f"{args.variant} at {args.dtype} on {args.device}, batch {args.batch}, channels "
          f"{cfg.model.channels}: against the "
          f"{args.orders} batch orders, the largest of {args.realizations} realizations "
          f"(waves moved by one float32 unit): {describe(real_r)}; the float32 step: "
          f"{describe(dist(f32, base) / noise)}", flush=True)
    for spec in args.float32_islands:
        base_s = grads(c, noisy, order, spec)
        noise_s = np.array([max([float((o[n] - base_s[n]).norm()) for o in
                                 [grads(c, noisy, others[j], spec) for j in picks[:3]]]
                                + [2.5e-3 * float(base_s[n].norm())]) for n in leaves])
        reals_s = []
        for i in range(min(8, args.realizations)):
            g = torch.Generator().manual_seed(args.seed + 1000 + i)
            reals_s.append(grads(c, noisy * (1 + 2.0 ** -23 * torch.randn(
                noisy.shape, generator=g)), order, spec))
        r = np.max([dist(x, base_s) / noise_s for x in reals_s], axis=0)
        print(f"float32 islands {spec}: against 3 batch orders, the largest of "
              f"{len(reals_s)} realizations: {describe(r)}; the float32 step "
              f"{describe(dist(f32, base_s) / noise_s)}; the realizations against the "
              f"plain bf16 step's orders: {describe(np.max([dist(x, base_s) for x in reals_s], axis=0) / noise)}",
              flush=True)
    print(f"leaf_spread took {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
