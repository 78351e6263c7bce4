"""VoiceBank-DEMAND waveform loader, the port's copy of the JAX package's
``data/dataset.py`` without its native C++ front end.

The host ships raw 16 kHz waveform crops; the STFT runs on the device inside
the step (``train/steps.py:batch_from_waves``). Host work per item is the wav
decode, the 48 kHz -> 16 kHz polyphase resample and the pad-or-random crop,
overlapped with the device's work by a background thread that keeps
``prefetch`` batches ready. The semantics are the JAX package's: normalise on
load, equal clean and noisy lengths, a crop of ``crop_samples`` (8160), zero
right-pad for short utterances and a uniform random start otherwise, the same
seeded crop starts and shuffles (so both packages yield the same batches),
and a check for non-finite samples per item. The loader runs numpy only: its
threads make no CUDA call, so they may prefetch while the trainer captures a
CUDA graph (a capture forbids such calls from any thread).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from dcs_net_tpu_torch.core.config import DataConfig
from dcs_net_tpu_torch.data import partition as P
from dcs_net_tpu_torch.data.audio_io import read_wav, resample


class VoiceBankDataset:
    """Map-style dataset of (noisy, clean) 16 kHz crops."""

    def __init__(self, ids: List[str], cfg: DataConfig, mode: str):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode {mode!r}: expected train, val or test")
        self.ids = list(ids)
        self.cfg = cfg
        self.mode = mode
        test = mode == "test"
        self.clean_dir = P.testset_dir(cfg, True) if test else P.trainset_dir(cfg)
        self.noisy_dir = (P.testset_dir(cfg, False) if test
                          else P.noisy_trainset_dir(cfg))
        self._ram: Optional[Dict[str, tuple]] = {} if cfg.load_into_ram else None

    def __len__(self) -> int:
        return len(self.ids)

    def _load(self, utt_id: str) -> tuple:
        if self._ram is not None and utt_id in self._ram:
            return self._ram[utt_id]
        norm = self.cfg.normalize_audio
        clean, sr_c = read_wav(os.path.join(self.clean_dir, utt_id + ".wav"), norm)
        noisy, sr_n = read_wav(os.path.join(self.noisy_dir, utt_id + ".wav"), norm)
        clean = resample(clean, sr_c, self.cfg.sr)
        noisy = resample(noisy, sr_n, self.cfg.sr)
        if clean.shape[0] != noisy.shape[0]:
            raise ValueError(f"clean/noisy length mismatch for {utt_id}")
        if self._ram is not None:
            self._ram[utt_id] = (clean, noisy)
        return clean, noisy

    def get(self, index: int, rng: np.random.Generator) -> Dict[str, object]:
        utt_id = self.ids[index]
        clean, noisy = self._load(utt_id)
        win = self.cfg.crop_samples
        n = clean.shape[0]
        if win > n:
            clean = np.pad(clean, (0, win - n))
            noisy = np.pad(noisy, (0, win - n))
            start = 0
        else:
            start = int(rng.integers(0, n - win)) if n > win else 0
        clean = clean[start:start + win]
        noisy = noisy[start:start + win]
        for name, x in (("clean", clean), ("noisy", noisy)):
            if not np.all(np.isfinite(x)):
                raise FloatingPointError(
                    f"Found inf/-inf/nan in {name} audio for {utt_id}")
        return {"clean": clean, "noisy": noisy, "id": utt_id, "start": start}


class Loader:
    """Batch iterator with a seeded shuffle each epoch and background
    prefetch.
    Items of a batch are read by a pool of ``num_workers`` threads (the wav
    decode and the resample run in numpy, which releases the interpreter
    lock); :meth:`close` ends the pool."""

    def __init__(self, dataset: VoiceBankDataset, batch_size: int,
                 drop_last: bool = False,
                 num_workers: int = 2, prefetch: int = 2, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self._pool = ThreadPoolExecutor(max(num_workers, 1))

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def _batches(self, epoch: int) -> List[List[int]]:
        order = np.arange(len(self.ds))
        np.random.default_rng((self.seed, epoch)).shuffle(order)
        out = [order[i:i + self.batch_size].tolist()
               for i in range(0, len(order), self.batch_size)]
        if self.drop_last and out and len(out[-1]) < self.batch_size:
            out.pop()
        return out

    def epoch(self, epoch: int) -> Iterator[Dict[str, object]]:
        batches = self._batches(epoch)
        crop_seeds = np.random.default_rng((self.seed, epoch, 1)).integers(
            0, 2 ** 31, size=len(self.ds))

        def fetch(idxs: List[int]) -> Dict[str, object]:
            items = list(self._pool.map(
                lambda i: self.ds.get(
                    i, np.random.default_rng(int(crop_seeds[i]) + epoch)), idxs))
            return {"clean": np.stack([it["clean"] for it in items]),
                    "noisy": np.stack([it["noisy"] for it in items]),
                    "id": [it["id"] for it in items],
                    "start": np.asarray([it["start"] for it in items])}

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    q.put(fetch(idxs))
            except Exception as e:  # handed to the consumer, raised there
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():       # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
