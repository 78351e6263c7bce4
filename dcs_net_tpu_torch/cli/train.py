"""Train on the GPU: ``python -m dcs_net_tpu_torch.cli.train {dr,dc,drs,dcs}
[--synthetic] [--epochs N] [--batch-size B] [--limit-train-batches N]
[--steps-per-dispatch K] [--resume]``.

The flags are the JAX CLI's plus ``--device`` (default cuda; ``cpu`` runs the
kernels' plain versions). ``--resume`` restores the model, the optimizer,
the plateau scheduler and the epoch from the latest checkpoint under the
checkpoint directory. ``--steps-per-dispatch K`` runs K train steps a
dispatch, on the card as one CUDA graph replay (default 8 there, 1 with
``--device cpu``, as the JAX CLI's default is 8 on an accelerator); it
overrides ``--config-json``'s value, as in the JAX CLI. ``--no-tensorboard``
reaches the ``Trainer`` as ``use_tensorboard=False``; the port writes no
TensorBoard yet, only its JSON lines and WAVs. ``--dtype bfloat16`` trains
any variant with bf16 operands and float32 sums, the parameters, BN and Adam
in float32, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools

from dcs_net_tpu_torch.cli.common import add_common_args, build_config, make_loaders


class _Capped:
    """A loader whose epochs stop after ``cap`` batches."""

    def __init__(self, loader, cap: int):
        self.loader, self.cap = loader, cap

    def epoch(self, e):
        return itertools.islice(self.loader.epoch(e), self.cap)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--limit-train-batches", type=int, default=None,
                   help="cap train batches per epoch (smoke runs)")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="train steps per device dispatch, on the card one CUDA "
                        "graph replay; default 8 on the card, 1 on the CPU")
    args = p.parse_args(argv)
    k = args.steps_per_dispatch
    if k is None:
        k = 1 if args.device == "cpu" else 8
    if k < 1:
        p.error(f"--steps-per-dispatch must be at least 1, got {k}")

    from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
    from dcs_net_tpu_torch.train.loop import Trainer

    cfg = build_config(args)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, steps_per_dispatch=k))
    print(f"variant={cfg.variant} complex={cfg.model.complex_valued} "
          f"subtractive={cfg.model.subtractive} faithful_quirks="
          f"{cfg.quirks == cfg.quirks.__class__()} device={args.device} "
          f"steps_per_dispatch={k}")
    loaders = make_loaders(cfg)
    train_loader, val_loader = loaders
    print(f"loader={train_loader.front_end}", flush=True)
    trainer = Trainer(cfg, device=args.device,
                      use_tensorboard=not args.no_tensorboard)
    trainer.init_state()
    ckpt = CheckpointManager(cfg.run.ckpt_dir)
    if args.resume and ckpt.latest_step() is not None:
        step = trainer.restore(ckpt)
        print(f"resumed from step {step} (epoch {trainer.epoch})")
    if args.limit_train_batches:
        train_loader = _Capped(train_loader, args.limit_train_batches)
    try:
        metrics = trainer.fit(train_loader, val_loader, ckpt=ckpt)
    finally:
        for loader in loaders:
            loader.close()
        trainer.writer.close()
    print("final:", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
