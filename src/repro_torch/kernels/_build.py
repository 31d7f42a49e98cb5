"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (pointers and the stream as ``void*``, a
``cudaError_t`` returned as ``int``) under ``build/repro_torch_kernels/`` at
the repository root.  A library's file name carries a hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so a changed source
builds anew and an unchanged one is reused.  `build` starts one ``nvcc`` per
missing library, all together, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the default
    toolkit location, or ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build on a machine with the CUDA toolkit")
    return found


class CudaKernel:
    """One kernel: its source, its C entry point, and a launch count.

    ``launches`` grows by one each time `launch` starts the kernel on the
    card, and nowhere else.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = tuple(NVCC_FLAGS) + tuple(extra_flags)
        self.launches = 0
        self._fn = None
        self._lib = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256()
        headers = [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
        for part in (self.source.read_bytes(), *headers,
                     " ".join(self.flags).encode()):
            h.update(part)
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _load(self):
        if self._fn is None:
            build([self])
            self._lib = ctypes.CDLL(str(self.library))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]   # + stream
            fn.restype = ctypes.c_int
            self._lib.repro_error_string.argtypes = [ctypes.c_int]
            self._lib.repro_error_string.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def call(self, symbol: str, argtypes: Sequence, *args) -> int:
        """Call another C function of the kernel's library, one that
        returns an int: a query, not a launch, so it counts nothing."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, *args) -> None:
        """Launch on PyTorch's current stream; raise on a CUDA error."""
        fn = self._load()
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = self._lib.repro_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


def build(kernels: Iterable[CudaKernel]) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` each, all started
    together; kernels that share a source and flags share one library.
    Returns ``{source file name: ptxas report}`` for the libraries built by
    this call; raises if any build fails."""
    with _LOCK:
        todo = {k.library: k for k in kernels if not k.library.exists()}
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for lib, k in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *k.flags, "-o", str(tmp), str(k.source)]
            procs.append((k, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports, failed = {}, []
        for k, lib, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{k.source.name}:\n{out}")
                continue
            os.replace(tmp, lib)
            reports[k.source.name] = out
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def require(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of this dtype
    and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
