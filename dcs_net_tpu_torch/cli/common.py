"""Shared CLI plumbing of the port: the JAX CLI's flags, the config built
from them, and the data loaders: ``make_loaders`` the train and validation
ones, ``make_test_loader`` the test set's (the JAX ``make_loaders`` returns
all three)."""

from __future__ import annotations

import argparse
import dataclasses
import os

from dcs_net_tpu_torch.core.config import VARIANTS, Config, config_for_variant


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("variant", choices=VARIANTS,
                   help="model variant: {dr, dc, drs, dcs}")
    p.add_argument("--data-root", default=os.environ.get("VOICEBANK_ROOT", ""),
                   help="VoiceBank-DEMAND root (clean/noisy_trainset_*, testset)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate and use synthetic fixture audio (no dataset needed)")
    p.add_argument("--synthetic-n", type=int, default=24)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--idiomatic", action="store_true",
                   help="fix the original code's quirks instead of reproducing them")
    p.add_argument("--streaming", action="store_true",
                   help="streaming preset: unidirectional LSTM + time-major latent")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="matmul/conv operand dtype (bfloat16: bf16 operands, "
                        "float32 accumulation; every variant)")
    p.add_argument("--config-json", default=None,
                   help="load a serialized Config (overrides other flags)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def with_dtype(cfg: Config, dtype: str) -> Config:
    """``cfg`` with its operand type set, as the JAX ``build_config`` sets
    ``--dtype``: ``ModelConfig.compute_dtype`` and ``STFTConfig.dft_dtype``."""
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype),
                       stft=dataclasses.replace(cfg.stft, dft_dtype=dtype))


def build_config(args) -> Config:
    if args.config_json:
        with open(args.config_json) as f:
            return Config.from_json(f.read())
    cfg = config_for_variant(args.variant, faithful=not args.idiomatic,
                             streaming=args.streaming)
    if args.dtype:
        cfg = with_dtype(cfg, args.dtype)
    data_kw = {}
    if args.synthetic:
        root = os.path.join(args.log_dir or "runs", "synthetic_data")
        if not os.path.exists(os.path.join(root, "clean_trainset_28spk_wav")):
            from dcs_net_tpu_torch.data import synthetic

            print(f"generating synthetic fixtures under {root}")
            synthetic.generate(root, n_train=args.synthetic_n,
                               n_test=max(args.synthetic_n // 4, 2))
        data_kw["root"] = root
    elif args.data_root:
        data_kw["root"] = args.data_root
    if args.batch_size:
        data_kw["batch_size"] = args.batch_size
    if data_kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    run_kw = {}
    if args.epochs is not None:
        run_kw["max_epochs"] = args.epochs
    if args.seed is not None:
        run_kw["seed"] = args.seed
    if args.log_dir:
        run_kw["log_dir"] = os.path.join(args.log_dir, args.variant)
    run_kw["ckpt_dir"] = args.ckpt_dir or os.path.join(
        args.log_dir or "runs", args.variant, "checkpoints")
    return cfg.replace(run=dataclasses.replace(cfg.run, **run_kw))


def make_loaders(cfg: Config):
    """(train, val) loaders over the seeded partition; train drops its
    ragged last batch."""
    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition

    part = make_partition(cfg.data, seed=cfg.run.seed)
    out = []
    for name in ("train", "val"):
        out.append(Loader(VoiceBankDataset(part[name], cfg.data, mode=name),
                          batch_size=cfg.data.batch_size,
                          drop_last=(name == "train"),
                          num_workers=cfg.data.num_workers,
                          prefetch=cfg.data.prefetch, seed=cfg.run.seed))
    return tuple(out)


def make_test_loader(cfg: Config, batch_size: int = 1):
    """The test set's loader at ``batch_size`` (1, as the JAX
    ``make_loaders(cfg, test_batch_size=1)`` builds it): seeded shuffle,
    crops as the dataset's, the ragged last batch kept."""
    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition

    part = make_partition(cfg.data, seed=cfg.run.seed)
    return Loader(VoiceBankDataset(part["test"], cfg.data, mode="test"),
                  batch_size=batch_size, num_workers=cfg.data.num_workers,
                  prefetch=cfg.data.prefetch, seed=cfg.run.seed)
