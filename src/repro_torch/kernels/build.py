"""Build the port's CUDA kernels and bind them with ctypes.

Each source in ``csrc/`` compiles with one ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries are named by a hash of their source and flags and
kept in ``_build/`` beside this file, so a second use in the same
checkout loads without compiling.  The first use builds; ``build_all``
starts every ``nvcc`` at once.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("decode_attention.cu", "monitor_combine.cu", "flash_attention.cu",
           "ssd_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source whose library is missing, all ``nvcc``
    processes at once.  Returns ``{source: {"seconds", "log", "cached"}}``
    (``log``: nvcc's output, the ``-Xptxas -v`` register and shared
    memory report).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            out[src] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[src] = {"seconds": time.perf_counter() - t0, "log": log,
                    "cached": False}
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


class CudaKernel:
    """One C entry point of a built library, and its launch count.

    ``__call__`` passes ctypes arguments through, raises if the entry point
    returns a non-zero ``cudaError_t`` (a launch the card refused never
    runs, and a later synchronise would not report it), and counts the
    launch.  ``launches`` is read and reset by callers that need to show
    which path ran (``chip_smoke.py``).  The count is taken under a lock:
    an async session's worker thread launches beside the edge loop, and
    ``+= 1`` on an attribute is not atomic across threads.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source, self.symbol = source, symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()
        self._lib = None
        self._fn = None
        self._err = None

    def _bind(self):
        lib_path = library_path(self.source)
        if not lib_path.exists():
            build_all([self.source])
        lib = self._lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def __call__(self, *args) -> None:
        fn = self._fn if self._fn is not None else self._bind()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc} ({self._err(rc).decode()})")
        with self._count_lock:
            self.launches += 1

    def call(self, symbol: str, argtypes, *args) -> None:
        """Call another entry point of the same library (a query, not a
        launch: not counted); raises if it returns a non-zero
        ``cudaError_t``."""
        if self._lib is None:
            self._bind()
        fn = getattr(self._lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol} failed: CUDA error {rc} "
                               f"({self._err(rc).decode()})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
