"""The port's binding of its native PESQ estimator (``csrc/pesq.cc``, the JAX
package's ``native/pesq/pesq.cc``), through ``ctypes``.

The library is host C++, built with ``g++`` at the first call (never at
import) into ``build/dcs_net_tpu_torch/libpesq.so`` at the repository root,
atomically (``utils/host_lib.py``); ``DCSNET_TORCH_PESQ_SO`` names a prebuilt
library instead. Where a ``pypesq`` or ``pesq`` wheel is importable it is used, for
bit-exactness with the original code's scores.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from dcs_net_tpu_torch.utils.host_lib import BUILD_DIR, HostLibrary

ENV_SO = "DCSNET_TORCH_PESQ_SO"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def _bind(lib: ctypes.CDLL) -> None:
    lib.pesq_mos.restype = ctypes.c_double
    lib.pesq_mos.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]


_LIBRARY = HostLibrary("pesq", "pesq.cc", ENV_SO, GXX_FLAGS, _bind)
SOURCE = _LIBRARY.source


def _find_external() -> Tuple[str, Optional[Callable]]:
    """("pypesq" or "pesq", its function) for an importable wheel, else
    ("", None)."""
    try:
        from pypesq import pesq as fn  # type: ignore

        return "pypesq", fn
    except ImportError:
        pass
    try:
        from pesq import pesq as fn  # type: ignore

        return "pesq", fn
    except ImportError:
        return "", None


def is_estimate() -> bool:
    """True when scores come from the native estimator, which follows
    P.862's structure but is not conformance-tested against the ITU
    reference, rather than from a ``pypesq``/``pesq`` wheel: metric keys then
    say ``pesq_est``, not ``pesq``."""
    return _find_external()[1] is None


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Build ``libpesq.so`` from ``csrc/pesq.cc`` under ``build_dir`` unless a
    library newer than the source is there; returns its path. Raises with
    the compiler's output if ``g++`` fails."""
    return _LIBRARY.build(build_dir)


def _load() -> ctypes.CDLL:
    """The library, built or named by ``DCSNET_TORCH_PESQ_SO`` at the first
    call; raises if it neither builds nor loads."""
    return _LIBRARY.load()


def pesq(clean: np.ndarray, degraded: np.ndarray, sr: int = 16000) -> float:
    """Raw P.862-style MOS, called as ``pypesq.pesq(ref, deg, fs)``; NaN for
    a rate other than 8 or 16 kHz or a signal under a quarter second."""
    name, ext = _find_external()
    if ext is not None:
        if name == "pypesq":
            return float(ext(clean, degraded, sr))
        return float(ext(sr, np.asarray(clean), np.asarray(degraded), "wb"))
    lib = _load()
    c = np.ascontiguousarray(np.asarray(clean).ravel(), dtype=np.float32)
    d = np.ascontiguousarray(np.asarray(degraded).ravel(), dtype=np.float32)
    return float(lib.pesq_mos(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(c),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(d), int(sr)))
