"""VoiceBank-DEMAND waveform loader, the port's copy of the JAX package's
``data/dataset.py``.

The host ships raw 16 kHz waveform crops; the STFT runs on the device inside
the step (``train/steps.py:batch_from_waves``). Host work per item is the wav
decode, the 48 kHz -> 16 kHz polyphase resample and the pad-or-random crop,
overlapped with the device's work by a background thread that keeps
``prefetch`` batches ready. Two front ends do it, with the JAX package's rule
between them: the native one (``data/native_loader.py``, a whole batch in one
C call that reads only each crop's window) when its library builds and
``load_into_ram`` is off, else numpy on ``num_workers`` threads. The
semantics are the JAX package's: normalise on load, equal clean and noisy
lengths, a crop of ``crop_samples`` (8160), zero right-pad for short
utterances and a uniform random start otherwise, the same seeded crop starts
and shuffles (so both packages, and both front ends, yield the same batches),
and a check for non-finite samples per item. The loader makes no CUDA call
and imports no torch, so its threads may prefetch while the trainer captures
a CUDA graph (a capture forbids such calls from any thread).
"""

from __future__ import annotations

import math
import os
import queue
import threading
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dcs_net_tpu_torch.core.config import DataConfig
from dcs_net_tpu_torch.data import native_loader
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

    def full_utterance(self, index: int) -> Dict[str, object]:
        """The uncropped item (the streaming-enhance path's)."""
        utt_id = self.ids[index]
        clean, noisy = self._load(utt_id)
        return {"clean": clean, "noisy": noisy, "id": utt_id, "start": 0}


def choose_front_end(cfg: DataConfig, use_native: Optional[bool] = None
                     ) -> Tuple[bool, str]:
    """(whether the native front end serves, ``"native"`` or ``"python
    (<why>)"``). ``use_native`` None takes the JAX rule: native when its
    library builds and ``load_into_ram`` is off."""
    if use_native is None:
        if cfg.load_into_ram:
            return False, "python (load_into_ram)"
        if not native_loader.native_available():
            return False, f"python (native front end unavailable: {native_loader.load_error()})"
        return True, "native"
    return use_native, "native" if use_native else "python (use_native=False)"


class Loader:
    """Batch iterator with a seeded shuffle each epoch and background
    prefetch.
    On the native front end (:func:`choose_front_end`; ``front_end`` names
    the one taken) a batch is one C call on ``num_workers`` threads; on the
    numpy one its items are read by a pool of ``num_workers`` threads (the
    wav decode and the resample run in numpy, which releases the interpreter
    lock). Both draw each item's crop start from the same per-item
    generator. :meth:`close` ends the pool."""

    def __init__(self, dataset: VoiceBankDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = False,
                 num_workers: int = 2, prefetch: int = 2, seed: int = 0,
                 use_native: Optional[bool] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.use_native, self.front_end = choose_front_end(dataset.cfg, use_native)
        self._lengths: Optional[List[int]] = None
        self._pool = ThreadPoolExecutor(self.num_workers)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _utt_lengths(self) -> List[int]:
        """Each utterance's length at ``cfg.sr``, from its clean wav's
        header: ``ceil(sr * n / file_sr)``, the resampler's output length."""
        if self._lengths is None:
            out = []
            for utt_id in self.ds.ids:
                with wave.open(os.path.join(self.ds.clean_dir, utt_id + ".wav"),
                               "rb") as w:
                    n, sr = w.getnframes(), w.getframerate()
                out.append(int(math.ceil(self.ds.cfg.sr * n / sr)))
            self._lengths = out
        return self._lengths

    def _batches(self, epoch: int) -> List[List[int]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
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

        def fetch_python(idxs: List[int]) -> Dict[str, object]:
            items = list(self._pool.map(
                lambda i: self.ds.get(
                    i, np.random.default_rng(int(crop_seeds[i]) + epoch)), idxs))
            return {"clean": np.stack([it["clean"] for it in items]),
                    "noisy": np.stack([it["noisy"] for it in items]),
                    "id": [it["id"] for it in items],
                    "start": np.asarray([it["start"] for it in items])}

        def fetch_native(idxs: List[int]) -> Dict[str, object]:
            lengths = self._utt_lengths()
            win = self.ds.cfg.crop_samples
            starts = []
            for i in idxs:
                n = lengths[i]
                rng_i = np.random.default_rng(int(crop_seeds[i]) + epoch)
                starts.append(int(rng_i.integers(0, n - win)) if n > win else 0)
            ids = [self.ds.ids[i] for i in idxs]
            clean, noisy = native_loader.fill_batch(
                [os.path.join(self.ds.clean_dir, u + ".wav") for u in ids],
                [os.path.join(self.ds.noisy_dir, u + ".wav") for u in ids],
                starts, win, normalize=self.ds.cfg.normalize_audio,
                orig_freq=self.ds.cfg.file_sr, new_freq=self.ds.cfg.sr,
                n_threads=self.num_workers)
            return {"clean": clean, "noisy": noisy, "id": ids,
                    "start": np.asarray(starts)}

        fetch = fetch_native if self.use_native else fetch_python

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
