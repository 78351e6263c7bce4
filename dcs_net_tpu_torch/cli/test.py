"""Evaluate a checkpoint on the test set on the GPU:
``python -m dcs_net_tpu_torch.cli.test {dr,dc,drs,dcs} --ckpt-dir DIR
[--limit-batches N] [--composite] [--no-tensorboard] [--device cuda|cpu]``.

The JAX CLI's test pass: the latest checkpoint under ``--ckpt-dir``
restored whole (the configuration is built from the flags, as the JAX CLI
builds it), the test
set at batch size 1, STOI, PESQ and SI-SDR per utterance into
``<log_dir>-test/per_utterance.csv`` (``--composite`` adds SegSNR, LLR, WSS
and CSIG/CBAK/COVL), and the means printed. ``--device`` defaults to cuda
(``cpu`` runs the kernels' plain versions); without a card the default
raises. ``--no-tensorboard`` is accepted for the JAX CLI's sake: the port
writes JSON lines and WAVs only. ``--dtype bfloat16`` evaluates the float32
checkpoint with bf16 operands and float32 sums, as the JAX CLI does (every
variant).
"""

from __future__ import annotations

import argparse
import os

from dcs_net_tpu_torch.cli.common import add_common_args, build_config, make_test_loader


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--limit-batches", type=int, default=None)
    p.add_argument("--composite", action="store_true",
                   help="also report SegSNR/LLR/WSS and CSIG/CBAK/COVL")
    args = p.parse_args(argv)

    from dcs_net_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_steps
    from dcs_net_tpu_torch.train.loop import Trainer
    from dcs_net_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(args)
    if not checkpoint_steps(cfg.run.ckpt_dir):
        raise SystemExit(f"no checkpoint found under {cfg.run.ckpt_dir}")
    out_dir = cfg.run.log_dir + "-test"
    trainer = Trainer(cfg, device=device, log_dir=out_dir,
                      use_tensorboard=not args.no_tensorboard)
    trainer.init_state()
    step = trainer.restore(CheckpointManager(cfg.run.ckpt_dir))
    print(f"restored step {step} from {cfg.run.ckpt_dir}")
    csv_path = os.path.join(out_dir, "per_utterance.csv")
    test_loader = make_test_loader(cfg, batch_size=1)
    print(f"loader={test_loader.front_end}", flush=True)
    try:
        metrics = trainer.eval_epoch(test_loader.epoch(0), 0, phase="test",
                                     max_batches=args.limit_batches,
                                     per_utterance_csv=csv_path,
                                     composite=args.composite)
    finally:
        test_loader.close()
        trainer.writer.close()
    print("test:", {k: round(v, 4) for k, v in metrics.items()})
    print(f"per-utterance metrics: {csv_path}")
    return metrics


if __name__ == "__main__":
    main()
