"""Host C++ libraries of the port (``csrc/*.cc``), built with ``g++`` and
bound through ``ctypes``: the PESQ estimator and the native audio front end.

A library builds at its first use, never at import, into
``build/dcs_net_tpu_torch/`` at the repository root (a directory git
ignores). The build is atomic: ``g++`` writes a name of its own in that
directory, then ``os.replace`` puts it in place, all under an exclusive
``fcntl.flock`` on ``lib<name>.lock`` there, so processes that build at once
(parallel test workers, a trainer and its subprocesses) never load a
half-written library: the first builds, the others wait and load its file. A
library older than its source is rebuilt. An environment variable of each
library's own names a prebuilt one instead.

This module imports no torch: the data loader's threads use it.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "dcs_net_tpu_torch"


class HostLibrary:
    """``lib<name>.so`` from ``csrc/<source>`` with ``g++ <flags>``.

    ``bind`` declares the loaded library's ``argtypes`` and ``restype``.
    ``env_so`` names the environment variable that points at a prebuilt
    library, read at the first load."""

    def __init__(self, name: str, source: str, env_so: str, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / source
        self.env_so = env_so
        self.flags = tuple(flags)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None

    def build(self, build_dir: Path = BUILD_DIR) -> Path:
        """Build ``lib<name>.so`` under ``build_dir`` unless a library newer
        than the source is there; returns its path. Raises with the
        compiler's output if ``g++`` fails."""
        build_dir = Path(build_dir)
        build_dir.mkdir(parents=True, exist_ok=True)
        so = build_dir / f"lib{self.name}.so"
        with open(build_dir / f"lib{self.name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if so.exists() and so.stat().st_mtime >= self.source.stat().st_mtime:
                return so
            tmp = build_dir / f"lib{self.name}.{os.getpid()}.tmp.so"
            r = subprocess.run(["g++", *self.flags, "-o", str(tmp), str(self.source)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed to build {self.source}:\n{r.stdout}{r.stderr}")
            os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        """The library, built or named by ``env_so`` and bound at the first
        call. Raises ``RuntimeError`` if the build fails, ``OSError`` if the
        file does not load."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(os.environ.get(self.env_so) or self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def try_load(self) -> Optional[ctypes.CDLL]:
        """:meth:`load`, or None once a build or load has failed: its
        message (the compiler's output for a failed build) is kept in
        ``error`` and nothing is tried again."""
        if self.error is not None:
            return None
        try:
            return self.load()
        except (RuntimeError, OSError) as e:
            self.error = str(e)
            return None
