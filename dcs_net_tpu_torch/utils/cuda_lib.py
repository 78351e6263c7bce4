"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C entry point and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/dcs_net_tpu_torch/`` at the repository root (a directory git ignores),
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so a changed source or header rebuilds. The
library is loaded with ``ctypes``; pointers and the stream go in as
``c_void_p``. Nothing builds at import time: the first launch builds its own
library, and :func:`build_all` builds every kernel at once (one ``nvcc`` per
source, all started together).

A :class:`CudaKernel` counts its launches in ``launches``; only a successful
launch of its kernel adds one. A launch goes on the current stream, so under
CUDA graph capture (``train/steps.py``'s scanned step) it joins the graph:
it counts once there, at the capture, and a replay counts nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from dcs_net_tpu_torch.utils.host_lib import BUILD_DIR, CSRC_DIR

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# every CudaKernel ever constructed, by name
KERNELS: Dict[str, "CudaKernel"] = {}
# source file name -> seconds its nvcc took in the last build_all that built it
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, then the default toolkit prefix."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One kernel: its source file, its C entry point, its launch count.

    ``argtypes`` are the ctypes types of the C function's arguments, the
    trailing stream included. Calling the object launches on the current
    stream of ``device`` and raises if the C function returns a CUDA error.
    ``counted_with`` names the kernel whose body this entry point runs with
    another epilogue: a launch here counts there as well.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence[type],
                 counted_with: Optional["CudaKernel"] = None):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.counted_with = counted_with
        self._fn = None
        self._lib = None
        KERNELS[name] = self

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _compile_command(self, out: Path) -> List[str]:
        return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _load(self):
        if self._fn is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library_path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.dcs_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def library_function(self, symbol: str, argtypes: Sequence[type]):
        """Another C function of this kernel's library (a query, not a
        launch: nothing is counted), built and loaded on first use; it
        returns an int."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            msg = self._lib.dcs_cuda_error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"error {rc} ({msg})")
        self.launches += 1
        if self.counted_with is not None:
            self.counted_with.launches += 1


def build_all(kernels: Optional[Iterable[CudaKernel]] = None) -> float:
    """Compile the libraries not yet built, one nvcc process per source, all
    started together; each source's own seconds go to :data:`BUILD_SECONDS`.
    Returns the wall seconds spent; raises with nvcc's output if any build
    fails."""
    kernels = list(KERNELS.values() if kernels is None else kernels)
    todo = {k.library_path: k for k in kernels if not k.library_path.exists()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    def compile_one(out, k):
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        t = time.perf_counter()
        p = subprocess.run(k._compile_command(tmp), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        BUILD_SECONDS[k.source.name] = time.perf_counter() - t
        return k, out, tmp, p

    with ThreadPoolExecutor(len(todo)) as pool:
        done = list(pool.map(lambda item: compile_one(*item), todo.items()))
    failures = []
    for k, out, tmp, p in done:
        if p.returncode != 0:
            failures.append(f"{k.source.name}:\n{p.stdout}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_operand(name: str, t: torch.Tensor, device: torch.device,
                       ndim: int, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (float32 unless
    an entry's bf16 class says otherwise) and rank ``ndim`` on ``device``. A
    bf16 tensor at an entry without a bf16 class raises here."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).replace('torch.', '')}, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
