"""At-first-use build of the port's CUDA kernels.

The sources under `csrc/` have a plain C interface and include no PyTorch
header, so `nvcc` builds them in seconds into a shared library that
`ctypes` loads; a source that included `torch/extension.h` would take
minutes per build on the card's machine, and every fresh machine builds
anew. The library lands in `build/` beside this file (git-ignored), named
by a hash of the sources and flags so an edited kernel never loads a stale
build. Nothing here runs at import: `load_library()` builds on its first
call, which the kernel wrappers make from their launch path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention.cu",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build printed (nvcc's -Xptxas=-v register and shared
# memory report) and how long it took; None until a build ran here.
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built"
        " from source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # Pointers and the stream go as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut them.
    fn = lib.dstack_ragged_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dstack_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dstack_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library. With
    `rebuild`, nvcc runs even when a library for these sources exists
    (a smoke run times the build that a fresh machine pays)."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libdstack_kernels_{_digest()}.so"
        if rebuild or not so.exists():
            t0 = time.monotonic()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(str(CSRC / s) for s in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            # Atomic publish: a concurrent process never loads a half file.
            os.replace(tmp, so)
            build_log = proc.stdout + proc.stderr
            build_seconds = time.monotonic() - t0
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
