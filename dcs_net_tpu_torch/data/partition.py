"""The VoiceBank-DEMAND partition, the port's copy of the JAX package's
``data/partition.py``: walk the clean trainset, seeded shuffle, 80/20
train/val split, disjointness checks, cached as JSON and reloaded when
present."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from dcs_net_tpu_torch.core.config import DataConfig


def trainset_dir(cfg: DataConfig) -> str:
    return os.path.join(cfg.root, f"clean_trainset_{cfg.dataset_type}spk_wav")


def noisy_trainset_dir(cfg: DataConfig) -> str:
    return os.path.join(cfg.root, f"noisy_trainset_{cfg.dataset_type}spk_wav")


def testset_dir(cfg: DataConfig, clean: bool = True) -> str:
    return os.path.join(cfg.root, f"{'clean' if clean else 'noisy'}_testset_wav")


def _walk_ids(dir_path: str) -> List[str]:
    try:
        names = sorted(os.listdir(dir_path))
    except FileNotFoundError:
        return []
    return [os.path.splitext(n)[0] for n in names if n.endswith(".wav")]


def make_partition(cfg: DataConfig, seed: int = 0) -> Dict[str, List[str]]:
    """Build (or reload) the {train, val, test} utterance-id partition."""
    cache = (cfg.partition_json if os.path.isabs(cfg.partition_json)
             else os.path.join(cfg.root, cfg.partition_json))
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    train_val = np.array(_walk_ids(trainset_dir(cfg)))
    if train_val.size == 0:
        raise FileNotFoundError(
            f"no training wavs under {trainset_dir(cfg)}; set DataConfig.root "
            "to a VoiceBank-DEMAND tree or generate fixtures with "
            "dcs_net_tpu_torch.data.synthetic")
    np.random.default_rng(seed).shuffle(train_val)
    split = round(train_val.shape[0] * cfg.train_val_split)
    train, val = train_val[:split].tolist(), train_val[split:].tolist()
    test = _walk_ids(testset_dir(cfg))
    for name, ids in (("train", train), ("val", val), ("test", test)):
        if len(ids) != len(set(ids)):
            raise ValueError(f"duplicate utterance in the {name} set")
    if not (set(train).isdisjoint(val) and set(train).isdisjoint(test)
            and set(val).isdisjoint(test)):
        raise ValueError("train, val and test sets are not disjoint")
    partition = {"train": train, "val": val, "test": test}
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    with open(cache, "w") as f:
        json.dump(partition, f)
    return partition
