"""The port's native audio front end: a ``ctypes`` binding of
``csrc/audioio.cc``, its copy of the JAX package's ``native/audio/audioio.cc``.

``fill_batch`` decodes, resamples and crops a whole training batch in one C
call on ``n_threads`` threads, writing straight into numpy buffers, and reads
only each item's crop window; ``fill_batch_full`` decodes and resamples whole
utterances first, as the JAX package's front end does, and is the windowed
fill's reference (equal bit for bit). The data ``Loader`` takes the native
path when the library builds (:func:`native_available`); its numpy path stays
the fallback and the semantics oracle.

The library is host C++, built with ``g++ -O2 -shared -fPIC -pthread`` at the
first call (never at import) into ``build/dcs_net_tpu_torch/libaudioio.so``,
atomically (``utils/host_lib.py``); ``DCSNET_TORCH_AUDIOIO_SO`` names a
prebuilt library instead. A ``ctypes`` call releases the interpreter lock for
its duration, so the fill's threads run beside the trainer's; they make no
CUDA call.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from dcs_net_tpu_torch.data.audio_io import sinc_resample_kernel
from dcs_net_tpu_torch.utils.host_lib import BUILD_DIR, HostLibrary

ENV_SO = "DCSNET_TORCH_AUDIOIO_SO"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_c_float_p = ctypes.POINTER(ctypes.c_float)
_FILL_ARGTYPES = [
    ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    _c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, _c_float_p, _c_float_p]


def _bind(lib: ctypes.CDLL) -> None:
    lib.audioio_load.restype = ctypes.c_int64
    lib.audioio_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int, _c_float_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _c_float_p, ctypes.c_int64]
    for fill in (lib.audioio_fill_batch, lib.audioio_fill_batch_full):
        fill.restype = ctypes.c_int
        fill.argtypes = _FILL_ARGTYPES
    lib.audioio_version.restype = ctypes.c_int
    lib.audioio_version.argtypes = []


_LIBRARY = HostLibrary("audioio", "audioio.cc", ENV_SO, GXX_FLAGS, _bind)
SOURCE = _LIBRARY.source


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Build ``libaudioio.so`` from ``csrc/audioio.cc`` under ``build_dir``
    unless a library newer than the source is there; returns its path.
    Raises with the compiler's output if ``g++`` fails."""
    return _LIBRARY.build(build_dir)


def native_available() -> bool:
    """Whether the library builds (or ``DCSNET_TORCH_AUDIOIO_SO`` names one
    that loads). After a failure :func:`load_error` says why."""
    return _LIBRARY.try_load() is not None


def load_error() -> Optional[str]:
    """The failed build's or load's message (the compiler's output for a
    build), or None."""
    return _LIBRARY.error


def _lib() -> ctypes.CDLL:
    lib = _LIBRARY.try_load()
    if lib is None:
        raise RuntimeError(f"the native audio front end is unavailable: {_LIBRARY.error}")
    return lib


def _kernel_args(orig_freq: int, new_freq: int):
    """(kernel bank or None, n_phases, klen, width, orig) for the C calls."""
    if orig_freq == new_freq:
        return None, 0, 0, 0, 1
    kernels, width, orig, new = sinc_resample_kernel(orig_freq, new_freq)
    k = np.ascontiguousarray(kernels, np.float32)
    return k, new, k.shape[1], width, orig


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(_c_float_p)


def load_wav(path: str, normalize: bool = True,
             orig_freq: int = 0, new_freq: int = 0) -> np.ndarray:
    """Decode one wav natively, and resample it from ``orig_freq`` to
    ``new_freq`` when ``orig_freq`` is given."""
    lib = _lib()
    k, n_phases, klen, width, orig = (
        _kernel_args(orig_freq, new_freq) if orig_freq else (None, 0, 0, 0, 1))
    args = (path.encode(), int(normalize), _ptr(k), n_phases, klen, width, orig)
    # one decode where the output fits: 16-bit or wider PCM holds at most
    # size / 2 frames, and resampling by new / orig scales that
    cap = (os.path.getsize(path) // 2 + 1) * max(n_phases, 1) // orig + 2
    out = np.empty(cap, np.float32)
    n = lib.audioio_load(*args, _ptr(out), cap)
    if n < 0:
        raise IOError(f"native wav decode failed: {path}")
    if n > cap:
        out = np.empty(n, np.float32)
        lib.audioio_load(*args, _ptr(out), n)
    return out[:n].copy()


def _fill(entry: str, clean_paths: Sequence[str], noisy_paths: Sequence[str],
          starts: Sequence[int], crop: int, normalize: bool, orig_freq: int,
          new_freq: int, n_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    fn = getattr(_lib(), entry)
    b = len(clean_paths)
    if len(noisy_paths) != b or len(starts) != b:
        raise ValueError(f"{b} clean paths, {len(noisy_paths)} noisy paths and "
                         f"{len(starts)} starts: expected one of each per item")
    k, n_phases, klen, width, orig = _kernel_args(orig_freq, new_freq)
    clean = np.empty((b, crop), np.float32)
    noisy = np.empty((b, crop), np.float32)
    c_paths = (ctypes.c_char_p * b)(*[p.encode() for p in clean_paths])
    n_paths = (ctypes.c_char_p * b)(*[p.encode() for p in noisy_paths])
    st = np.ascontiguousarray(starts, np.int64)
    rc = fn(c_paths, n_paths, st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b, crop, int(normalize), _ptr(k), n_phases, klen, width, orig,
            n_threads, _ptr(clean), _ptr(noisy))
    if rc != 0:
        i = -rc - 1
        raise IOError(f"native batch fill failed on item {i}: "
                      f"{clean_paths[i]} / {noisy_paths[i]}")
    return clean, noisy


def fill_batch(clean_paths: Sequence[str], noisy_paths: Sequence[str],
               starts: Sequence[int], crop: int, *, normalize: bool = True,
               orig_freq: int = 48000, new_freq: int = 16000,
               n_threads: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """(clean, noisy), each (batch, crop) float32: item i is samples
    ``[starts[i], starts[i] + crop)`` of its utterance at ``new_freq``,
    zero past its end, decoding and resampling only that window. Raises
    ``IOError`` naming the item whose files cannot be read, whose clean and
    noisy lengths differ, or which holds a non-finite sample."""
    return _fill("audioio_fill_batch", clean_paths, noisy_paths, starts, crop,
                 normalize, orig_freq, new_freq, n_threads)


def fill_batch_full(clean_paths: Sequence[str], noisy_paths: Sequence[str],
                    starts: Sequence[int], crop: int, *, normalize: bool = True,
                    orig_freq: int = 48000, new_freq: int = 16000,
                    n_threads: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`fill_batch`'s result from whole utterances, decoded and
    resampled before the crop (the JAX package's front end): the windowed
    fill's reference."""
    return _fill("audioio_fill_batch_full", clean_paths, noisy_paths, starts,
                 crop, normalize, orig_freq, new_freq, n_threads)
