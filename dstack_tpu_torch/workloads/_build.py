"""At-first-use build of the port's CUDA kernels.

The sources under `csrc/` have a plain C interface and include no PyTorch
header, so `nvcc` builds them in seconds into a shared library that
`ctypes` loads; a source that included `torch/extension.h` would take
minutes per build on the card's machine, and every fresh machine builds
anew. Each source compiles in its own `nvcc -c`, all started together,
so the build takes as long as the slowest source rather than their sum,
and one `nvcc -shared` links the objects. The library lands in the
kernel cache that `compile_cache` enabled (`DSTACK_TPU_COMPILE_CACHE`,
keyed by nvcc release and architecture), else in `build/` beside this
file (git-ignored), named by a hash of the sources and flags so an edited
kernel never loads a stale build. A directory that cannot be written
raises; nothing falls back to another place. The bf16 Hopper kernels
(the flash forward and backward, the paged prefill kernel) copy tiles
with TMA, whose descriptors the driver's `cuTensorMapEncodeTiled`
encodes; `csrc/sm90.cuh`, which both sources include, fetches that
function through the CUDA runtime (`cudaGetDriverEntryPoint`), so the link
needs no `-lcuda`, and no CUTLASS header is included. Nothing here runs at
import: `load_library()` builds on its first call, which the kernel
wrappers make from their launch path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention.cu", "flash_attention.cu")
HEADERS = ("sm90.cuh",)  # included by the sources: part of the digest
ARCH = "sm_90a"
NVCC_FLAGS = (
    f"-gencode=arch=compute_{ARCH[3:]},code={ARCH}", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build printed (nvcc's -Xptxas=-v register and shared
# memory report) and how long it took; None until a build ran here. And
# how long the last load of a built library took (dlopen and binding).
build_log: Optional[str] = None
build_seconds: Optional[float] = None
load_seconds: Optional[float] = None


def nvcc() -> str:
    """Path of the nvcc that builds the library."""
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
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # Pointers and the stream go as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut them.
    fn = lib.dstack_ragged_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dstack_ragged_paged_prefill
    fn.argtypes = [ptr] * 6 + [i32] * 9 + [f32, ptr]
    fn.restype = ctypes.c_int
    tail = [i32, i32, i32, f32, i32, i32, ptr]  # BH, S, HD, scale, causal, dtype, stream
    for name, n_ptr in (("dstack_flash_fwd", 5), ("dstack_flash_block_fwd", 6),
                        ("dstack_flash_bwd_dq", 7), ("dstack_flash_bwd_dkv", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + tail
        fn.restype = ctypes.c_int
    lib.dstack_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dstack_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile_and_link(so: Path, tmp: str) -> str:
    """One `nvcc -c` per source, all at once, then one link, in the
    scratch directory `tmp`; the library is published atomically, so a
    concurrent process never loads a half file. Returns what nvcc printed
    (ptxas register reports)."""
    cc = nvcc()
    objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
    cmds = [[cc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        logs = list(pool.map(_run, cmds))
    out = str(Path(tmp) / "lib.so")
    logs.append(_run([cc, "-shared", "-o", out, *objs]))
    os.replace(out, so)
    return "".join(logs)


def _open(so: Path) -> ctypes.CDLL:
    return _bind(ctypes.CDLL(str(so)))


def build_dir() -> Path:
    """Where the library is built and looked up: the enabled kernel cache
    leaf (`compile_cache.enable_from_env()`), else BUILD_DIR."""
    from dstack_tpu_torch.workloads import compile_cache

    leaf = compile_cache.enable_from_env()
    return Path(leaf) if leaf else BUILD_DIR


def _scratch_dir(d: Path) -> str:
    """A fresh scratch directory inside `d` for one build; raises, naming
    the env var that moves the build, when `d` cannot be written."""
    from dstack_tpu_torch.workloads import compile_cache

    try:
        d.mkdir(parents=True, exist_ok=True)
        return tempfile.mkdtemp(dir=d)
    except OSError as e:
        raise RuntimeError(
            f"cannot build the kernel library in {d}: {e}; point"
            f" {compile_cache.ENV_VAR} (or native_server --compile-cache-dir)"
            " at a writable directory"
        ) from e


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """Build (once per source hash and cache leaf) and load the kernel
    library. A build counts as a cache miss with its seconds, a library
    found on disk as a hit (`compile_cache.snapshot()`); a second call in
    the process returns the loaded library and counts nothing. With
    `rebuild`, nvcc runs even when a library for these sources exists (a
    smoke run times the build that a fresh machine pays)."""
    from dstack_tpu_torch.workloads import compile_cache

    global _lib, build_log, build_seconds, load_seconds
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        d = build_dir()
        so = d / f"libdstack_kernels_{_digest()}.so"
        if rebuild or not so.exists():
            tmp = _scratch_dir(d)
            t0 = time.monotonic()
            try:
                build_log = _compile_and_link(so, tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            build_seconds = time.monotonic() - t0
            compile_cache.record_build(build_seconds)
        else:
            compile_cache.record_hit()
        t0 = time.monotonic()
        _lib = _open(so)
        load_seconds = time.monotonic() - t0
        return _lib
