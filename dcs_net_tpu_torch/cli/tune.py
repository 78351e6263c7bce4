"""Hyperparameter search on the GPU:
``python -m dcs_net_tpu_torch.cli.tune {dr,dc,drs,dcs} [--trials N]
[--trial-epochs E] [--device cuda|cpu]`` and the common flags.

The JAX CLI's search: learning rate, initialiser, speech_alpha, LSTM depth,
conv and fc dropout and weight decay (the original code's objective), each
trial a short ``Trainer.fit`` whose value to maximise is the best
validation ``val_pesq``, else ``val_pesq_est``, else ``val_stoi``. With
``optuna`` importable it drives the trials (``MedianPruner``); otherwise a
built-in random search prunes a trial whose value at an epoch falls below
the median of at least four earlier trials' values there. ``--device``
defaults to cuda; without a card the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from dcs_net_tpu_torch.cli.common import add_common_args, build_config, make_loaders
from dcs_net_tpu_torch.core.config import Config

MIN_PEERS = 4   # earlier trials that must have reached an epoch before it prunes


def sample_space(rng: np.random.Generator) -> Dict:
    return {
        "lr": float(rng.uniform(1e-5, 1e-3)),
        "init": str(rng.choice(["kaiming_uniform", "xavier_uniform"])),
        "speech_alpha": float(rng.uniform(0.0, 1.0)),
        "lstm_layers": int(rng.integers(1, 13)),
        "dropout_conv": float(rng.uniform(0.01, 0.99)),
        "dropout_fc": float(rng.uniform(0.01, 0.99)),
        "weight_decay": float(rng.uniform(1e-5, 1e-3)),
    }


def apply_sample(cfg: Config, s: Dict) -> Config:
    return cfg.replace(
        model=dataclasses.replace(cfg.model, init=s["init"], lstm_layers=s["lstm_layers"],
                                  dropout_conv=s["dropout_conv"],
                                  dropout_fc=s["dropout_fc"]),
        loss=dataclasses.replace(cfg.loss, speech_alpha=s["speech_alpha"]),
        optim=dataclasses.replace(cfg.optim, lr=s["lr"], weight_decay=s["weight_decay"]),
    )


def below_median(history: List[List[float]], epoch: int, v: float) -> bool:
    """The built-in pruning rule: ``v`` at ``epoch`` is below the median of
    the earlier trials' values at that epoch, of which there are at least
    ``MIN_PEERS``."""
    peers = [h[epoch] for h in history if len(h) > epoch]
    return len(peers) >= MIN_PEERS and v < float(np.median(peers))


def run_trial(cfg: Config, epochs: int, report: Optional[Callable[[int, float], bool]] = None,
              device=None) -> float:
    """Train for ``epochs`` and return the best validation value to
    maximise. ``report(epoch, value)`` returning True stops the trial."""
    from dcs_net_tpu_torch.train.loop import Trainer, TrainerCallbacks

    loaders = make_loaders(cfg)
    trainer = Trainer(cfg, device=device, log_dir=os.path.join(cfg.run.log_dir, "tune"))
    trainer.init_state()
    best = {"v": float("-inf")}

    def on_val(epoch: int, metrics: Dict[str, float]) -> bool:
        v = metrics.get("val_pesq", metrics.get(
            "val_pesq_est", metrics.get("val_stoi", float("-inf"))))
        best["v"] = max(best["v"], v)
        return report(epoch, v) if report is not None else False

    try:
        trainer.fit(*loaders, callbacks=TrainerCallbacks(on_validation_end=on_val),
                    max_epochs=epochs)
    finally:
        for loader in loaders:
            loader.close()
        trainer.writer.close()
    return best["v"]


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--trials", type=int, default=100)
    p.add_argument("--trial-epochs", type=int, default=5)
    args = p.parse_args(argv)

    from dcs_net_tpu_torch.data.dataset import choose_front_end
    from dcs_net_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    base_cfg = build_config(args)
    print(f"loader={choose_front_end(base_cfg.data)[1]}", flush=True)

    try:
        import optuna
    except ImportError:
        optuna = None
        print("optuna not available; using built-in random search + median pruning")
    if optuna is not None:
        def objective(trial: "optuna.trial.Trial") -> float:
            s = {
                "lr": trial.suggest_float("lr", 1e-5, 1e-3),
                "init": trial.suggest_categorical(
                    "init", ["kaiming_uniform", "xavier_uniform"]),
                "speech_alpha": trial.suggest_float("speech_alpha", 0.0, 1.0),
                "lstm_layers": trial.suggest_int("lstm_layers", 1, 12),
                "dropout_conv": trial.suggest_float("dropout_conv", 0.01, 0.99),
                "dropout_fc": trial.suggest_float("dropout_fc", 0.01, 0.99),
                "weight_decay": trial.suggest_float("weight_decay", 1e-5, 1e-3),
            }

            def report(epoch, v):
                trial.report(v, epoch)
                return trial.should_prune()

            return run_trial(apply_sample(base_cfg, s), args.trial_epochs, report, device)

        study = optuna.create_study(
            direction="maximize", pruner=optuna.pruners.MedianPruner(),
            study_name=f"{args.variant}-net_study")
        study.optimize(objective, n_trials=args.trials)
        print("best:", study.best_trial.value, study.best_trial.params)
        return {"value": study.best_trial.value, "params": study.best_trial.params}

    rng = np.random.default_rng(base_cfg.run.seed)
    history: List[List[float]] = []        # each trial's values by epoch
    results = []
    for t in range(args.trials):
        s = sample_space(rng)
        epoch_vals: List[float] = []

        def report(epoch: int, v: float) -> bool:
            epoch_vals.append(v)
            return below_median(history, epoch, v)

        value = run_trial(apply_sample(base_cfg, s), args.trial_epochs, report, device)
        history.append(epoch_vals)
        results.append({"trial": t, "value": value, "params": s,
                        "pruned": len(epoch_vals) < args.trial_epochs})
        print(f"trial {t}: value={value:.4f} params={s}", flush=True)
    best = max(results, key=lambda r: r["value"])
    print("best:", json.dumps(best))
    return best


if __name__ == "__main__":
    main()
