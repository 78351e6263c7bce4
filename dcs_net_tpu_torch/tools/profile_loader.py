"""The training loader alone: batches per second of each front end, and where
an item's time goes.

``python -m dcs_net_tpu_torch.tools.profile_loader [--data-root DIR |
--synthetic-n 320 --seconds 3] [--batch 32] [--crop 8160] [--workers 2,8]
[--batches N] [--items 32]``

On the train split of a VoiceBank-shaped tree (``--data-root``, or a
synthetic one of ``--synthetic-n`` pairs of ``--seconds`` at 48 kHz written
to a temporary directory), prints:

- ``loader: rate`` lines: one epoch of the ``Loader`` (its first
  ``--batches``, if given) at ``--batch`` x
  ``--crop`` on its numpy front end, on the native one with the faithful
  fill (``fill_batch_full``: whole utterances decoded and resampled) and on
  the native one as the loader runs it (``fill_batch``: each crop's window
  only), each at every ``--workers`` count (default 2, the ``DataConfig``
  default, and ``os.cpu_count()``): batches/s and audio-s/s, timed from the
  epoch's start to its last batch, the consumer taking each batch and doing
  nothing else (the native loader's scan of the utterances' lengths, once a
  loader, done before and timed on its own);
- ``loader: item`` lines: milliseconds per item (a clean and noisy pair) on
  one thread over ``--items`` items (the median of three passes), split into the decode (the wav read
  without the resample), the resample (with it, minus without) and the crop
  and stack (the whole path's time per item minus those two), for the numpy
  path and the faithful native one; and the windowed fill's whole time per
  item.

Host work only: no device is used. Figures depend on the host's CPUs
(printed) and its file system: the tree is read once before timing, and
that pass's rate and time a file are printed.
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np

FRONT_ENDS = ("numpy", "native-full", "native-windowed")


def loader_rate(ds, batch: int, workers: int, front_end: str,
                batches: Optional[int]) -> Tuple[float, int]:
    """(seconds, batches) of one epoch of the ``Loader`` on ``front_end``, or
    of its first ``batches``; its scan of the utterances' lengths (once a
    loader) done before."""
    from dcs_net_tpu_torch.data import native_loader
    from dcs_net_tpu_torch.data.dataset import Loader

    loader = Loader(ds, batch, drop_last=True, num_workers=workers,
                    use_native=front_end != "numpy")
    fill = (native_loader.fill_batch_full if front_end == "native-full"
            else native_loader.fill_batch)
    try:
        loader._utt_lengths()
        with mock.patch.object(native_loader, "fill_batch", fill):
            t0 = time.perf_counter()
            n = sum(1 for _ in itertools.islice(loader.epoch(0), batches))
            return time.perf_counter() - t0, n
    finally:
        loader.close()


def item_split(ds, items: int, file_sr: int, sr: int, crop: int) -> Dict[str, Dict[str, float]]:
    """ms per item on one thread: decode, resample, crop and stack."""
    from dcs_net_tpu_torch.data import native_loader
    from dcs_net_tpu_torch.data.audio_io import read_wav, resample

    ids = ds.ids[:items]
    paths = [os.path.join(d, u + ".wav") for u in ids for d in (ds.clean_dir, ds.noisy_dir)]
    starts = [0] * len(ids)

    def per_item(fn) -> float:
        """The median of three passes."""
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return sorted(walls)[1] * 1e3 / len(ids)

    def numpy_path():
        rng = np.random.default_rng(0)
        got = [ds.get(i, rng) for i in range(len(ids))]
        np.stack([it["clean"] for it in got]), np.stack([it["noisy"] for it in got])

    def full_path():
        native_loader.fill_batch_full(paths[0::2], paths[1::2], starts, crop,
                                      orig_freq=file_sr, new_freq=sr, n_threads=1)

    out = {
        "numpy": {"decode": per_item(lambda: [read_wav(p) for p in paths]),
                  "decode+resample": per_item(
                      lambda: [resample(read_wav(p)[0], file_sr, sr) for p in paths]),
                  "whole": per_item(numpy_path)},
        "native-full": {"decode": per_item(
                            lambda: [native_loader.load_wav(p) for p in paths]),
                        "decode+resample": per_item(
                            lambda: [native_loader.load_wav(p, orig_freq=file_sr, new_freq=sr)
                                     for p in paths]),
                        "whole": per_item(full_path)},
    }
    for parts in out.values():
        parts["resample"] = parts["decode+resample"] - parts["decode"]
        parts["crop+stack"] = parts["whole"] - parts["decode+resample"]
    out["native-windowed"] = {"whole": per_item(
        lambda: native_loader.fill_batch(paths[0::2], paths[1::2], starts, crop,
                                         orig_freq=file_sr, new_freq=sr, n_threads=1))}
    return out


def profile(root: str, batch: int, crop: int, workers: Sequence[int], items: int,
            batches: Optional[int] = None) -> Dict:
    """Print the rate and item lines for the tree at ``root``; returns
    ``{"rate": {front_end: {workers: batches/s}}, "item": {...}, "cpus": n}``."""
    from dcs_net_tpu_torch.core.config import DataConfig
    from dcs_net_tpu_torch.data import native_loader
    from dcs_net_tpu_torch.data.dataset import Loader, VoiceBankDataset
    from dcs_net_tpu_torch.data.partition import make_partition

    if not native_loader.native_available():
        raise RuntimeError(f"the native front end did not build: {native_loader.load_error()}")
    cfg = DataConfig(root=root, crop_samples=crop, batch_size=batch)
    ds = VoiceBankDataset(make_partition(cfg)["train"], cfg, "train")
    if len(ds) < batch:
        raise ValueError(f"{len(ds)} train pairs under {root}: fewer than a batch of {batch}")
    cpus = os.cpu_count()
    audio_s = batch * crop / cfg.sr
    print(f"loader: {len(ds)} train pairs under {root}, batch {batch} x {crop} samples "
          f"({audio_s:.2f} audio-s), host CPUs {cpus}", flush=True)
    t0 = time.perf_counter()
    n_bytes = 0
    for d in (ds.clean_dir, ds.noisy_dir):       # into the page cache
        for u in ds.ids:
            with open(os.path.join(d, u + ".wav"), "rb") as f:
                n_bytes += len(f.read())
    secs = time.perf_counter() - t0
    print(f"loader: read {2 * len(ds)} files, {n_bytes / 1e6:.1f} MB, in {secs:.2f} s "
          f"({n_bytes / 1e6 / secs:.0f} MB/s, {secs * 1e3 / (2 * len(ds)):.3f} ms a file)",
          flush=True)
    probe = Loader(ds, batch, use_native=True)
    t0 = time.perf_counter()
    probe._utt_lengths()
    print(f"loader: the length scan (each clean wav's header, once a native loader): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms for {len(ds)} utterances", flush=True)
    probe.close()
    rate: Dict[str, Dict[int, float]] = {}
    for fe in FRONT_ENDS:
        for w in workers:
            secs, n = loader_rate(ds, batch, w, fe, batches)
            rate.setdefault(fe, {})[w] = n / secs
            print(f"loader: rate {fe} workers={w}: {n} batches in {secs * 1e3:.1f} ms, "
                  f"{n / secs:.2f} batches/s, {n * audio_s / secs:.1f} audio-s/s, "
                  f"{secs * 1e3 / n:.2f} ms a batch (host CPUs {cpus})", flush=True)
    item = item_split(ds, min(items, len(ds)), cfg.file_sr, cfg.sr, crop)
    for fe, parts in item.items():
        print(f"loader: item {fe} (1 thread, ms per item): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()) + f" (host CPUs {cpus})", flush=True)
    return {"rate": rate, "item": item, "cpus": cpus}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic-n", type=int, default=320)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--crop", type=int, default=8160)
    p.add_argument("--workers", default=f"2,{os.cpu_count()}")
    p.add_argument("--batches", type=int, default=None)
    p.add_argument("--items", type=int, default=32)
    args = p.parse_args(argv)
    workers: List[int] = sorted({int(w) for w in args.workers.split(",")})
    if args.data_root:
        return profile(args.data_root, args.batch, args.crop, workers, args.items,
                       args.batches)
    from dcs_net_tpu_torch.data import synthetic

    with tempfile.TemporaryDirectory(prefix="dcs_loader_") as root:
        synthetic.generate(root, n_train=args.synthetic_n, n_test=2, seconds=args.seconds)
        return profile(root, args.batch, args.crop, workers, args.items, args.batches)


if __name__ == "__main__":
    main()
