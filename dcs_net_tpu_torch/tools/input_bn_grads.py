"""How well float32 resolves the gradient of the input BN's leaves: one
DCS train step's gradient of ``initial_bn``'s parameters on the card, on the
CPU in float32 and on the CPU in float64, from the same weights, on the
first train batch of a synthetic tree as each front end loads it.

``python -m dcs_net_tpu_torch.tools.input_bn_grads [--variant dcs]
[--pairs 480] [--seconds 0.6] [--batch 4] [--weights-seed 13] [--device cuda]``

The defaults are ``chip_smoke.py`` phase "train" (c)'s: 480 pairs of 0.6 s,
the first batch of 32 cut to 4, dropout off, weights from seed 13. For each
front end (native, numpy) it prints the three losses and, for each leaf,
its float64 value and the largest difference of the card's and of the CPU's
float32 gradient from it and from each other, relative to the leaf's
largest float64 magnitude. Each leaf sums over every pixel of the batch
terms that cancel to a small part of their magnitude, so inputs that differ
by a float32 rounding can move both float32 results by far more than that.
Runs on the card (``--device cpu`` puts the CPU in its place, a rehearsal
whose "card" figures are the CPU's).
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variant", choices=("dc", "dcs"), default="dcs")
    p.add_argument("--pairs", type=int, default=480)
    p.add_argument("--seconds", type=float, default=0.6)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--weights-seed", type=int, default=13)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data import synthetic
    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train import steps
    from dcs_net_tpu_torch.utils.device import resolve_device

    card = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_for_variant(args.variant)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_conv=0.0, dropout_fc=0.0))
    with tempfile.TemporaryDirectory(prefix="dcs_bn_") as root:
        dcfg = synthetic.generate(root, n_train=args.pairs, n_test=2, seconds=args.seconds)
        cfg = cfg.replace(data=dataclasses.replace(dcfg, batch_size=32))
        ds = VoiceBankDataset(make_partition(cfg.data, seed=cfg.run.seed)["train"], cfg.data,
                              "train")
        batches = {}
        for front_end, native in (("native", True), ("numpy", False)):
            loader = Loader(ds, 32, drop_last=True, seed=cfg.run.seed, use_native=native)
            batches[front_end] = next(iter(loader.epoch(0)))
            loader.close()
    diff = max(float(np.abs(batches["native"][k] - batches["numpy"][k]).max())
               for k in ("noisy", "clean"))
    print(f"bn: the two front ends' first batches differ by {diff:.3e} at most")
    weights = {k: v.cpu() for k, v in DCSNet(cfg.model, cfg.quirks, device=card,
                                             seed=args.weights_seed).state_dict().items()}
    for front_end, host in batches.items():
        waves = [torch.from_numpy(host[k][:args.batch]) for k in ("noisy", "clean")]
        grads, losses = {}, {}
        for where, dev, dtype in (("card", card, torch.float32),
                                  ("cpu32", "cpu", torch.float32),
                                  ("cpu64", "cpu", torch.float64)):
            model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=args.weights_seed).to(dtype)
            model.load_state_dict(weights)
            batch = steps.batch_from_waves(*(w.to(dev, dtype) for w in waves), cfg)
            loss, g = steps.loss_and_grads(model, batch, cfg)
            names = [n for n, q in model.named_parameters() if q.requires_grad]
            grads[where] = {n: t.double().cpu() for n, t in zip(names, g)
                            if n.startswith("initial_bn.")}
            losses[where] = float(loss)
        print(f"bn: {front_end} batch: loss card {losses['card']:.9f}, CPU float32 "
              f"{losses['cpu32']:.9f}, CPU float64 {losses['cpu64']:.9f}")
        for name, ref in grads["cpu64"].items():
            scale = max(float(ref.abs().max()), 1e-30)

            def rel(a, b):
                return float((a - b).abs().max()) / scale

            on_card, on_cpu = grads["card"][name], grads["cpu32"][name]
            print(f"bn: {front_end} batch: {name} float64 {float(ref.flatten()[0]):.9e}: "
                  f"|card - float64| {rel(on_card, ref):.3e}, |CPU float32 - float64| "
                  f"{rel(on_cpu, ref):.3e}, |card - CPU float32| {rel(on_card, on_cpu):.3e} "
                  f"(of max |float64|)")


if __name__ == "__main__":
    main()
