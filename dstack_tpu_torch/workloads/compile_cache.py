"""Persistent cache of the port's kernel library, and build counters (the
counterpart of `dstack_tpu.workloads.compile_cache`).

What the JAX package compiles at a cold start is XLA programs; what the
port builds is one thing, the nvcc kernel library (`workloads/_build.py`),
which takes seconds to tens of seconds on a fresh machine. A repeat boot
skips that build when the library survives on a volume:
`DSTACK_TPU_COMPILE_CACHE` (or the native server's `--compile-cache-dir`)
names a base directory, and `_build.load_library` builds into, and loads
from, a leaf under it. Without one, the library goes to
`workloads/build/` beside the package, as before.

Keying: a library built by another nvcc or for another architecture is
not safe to load, so the leaf is ``nvcc<release>-<arch>`` (for example
``base/nvcc12.9-sm90a``) and one shared volume serves machines with
different toolkits. Inside the leaf the library's own name carries a hash
of its sources and flags (`_build._digest`), so an edited kernel never
loads a stale build. The library has a plain C interface and links no
PyTorch, so torch's version is not part of the key. The port builds
nothing through Triton or Inductor today, so there is no other cache to
key.

Counters keep the reference's names: `compiles` (nvcc builds),
`cache_hits` (a library found on disk), `cache_misses` (a build because
none was) and `compile_seconds` (the builds' wall seconds). They are
process-wide and move once per `load_library` that reaches the disk; a
second call in the same process returns the loaded library and moves
nothing.
"""

import os
import re
import subprocess
import threading
from typing import Dict, Optional

from dstack_tpu_torch.workloads import _build

ENV_VAR = "DSTACK_TPU_COMPILE_CACHE"

_lock = threading.Lock()
_counts = {"compiles": 0, "cache_hits": 0, "cache_misses": 0,
           "compile_seconds": 0.0}
_enabled_dir: Optional[str] = None


def nvcc_version() -> str:
    """The release of the nvcc that builds the library, as `nvcc
    --version` prints it ("12.9")."""
    out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    m = re.search(r"release (\d+\.\d+)", out)
    if m is None:
        raise RuntimeError(f"no release in `nvcc --version`: {out!r}")
    return m.group(1)


def cache_dir_for(base: str, nvcc: Optional[str] = None) -> str:
    """`base`/nvcc<release>-<arch>: the leaf a process may load a library
    from, for the nvcc on this machine (or the release `nvcc` names) and
    the architecture the library is built for (`_build.ARCH`, "sm_90a" ->
    "sm90a")."""
    arch = _build.ARCH.replace("_", "")
    return os.path.join(base, f"nvcc{nvcc or nvcc_version()}-{arch}")


def enable(base: str) -> str:
    """Build and load the kernel library under the keyed leaf of `base`
    (created if absent); returns the leaf. Raises, naming the env var,
    when the leaf cannot be created."""
    global _enabled_dir
    leaf = cache_dir_for(base)
    try:
        os.makedirs(leaf, exist_ok=True)
    except OSError as e:
        raise RuntimeError(
            f"cannot create the kernel cache {leaf}: {e}; point {ENV_VAR}"
            " (or native_server --compile-cache-dir) at a writable directory"
        ) from e
    with _lock:
        _enabled_dir = leaf
    return leaf


def enable_from_env() -> Optional[str]:
    """The enabled leaf: the one an earlier `enable()` chose (an explicit
    directory wins over the env), else `enable()` of DSTACK_TPU_COMPILE_CACHE
    when it is set, else None."""
    with _lock:
        if _enabled_dir is not None:
            return _enabled_dir
    base = os.environ.get(ENV_VAR)
    if not base:
        return None
    return enable(base)


def prebuild(device) -> None:
    """On a CUDA device, build (or find) the kernel library once before
    spawning worker processes on it, so workers that start together load
    it instead of each building it. A no-op elsewhere."""
    import torch

    if torch.device(device).type != "cuda":
        return
    enable_from_env()
    _build.load_library()


def enabled_dir() -> Optional[str]:
    """The active keyed leaf, or None when none was enabled."""
    with _lock:
        return _enabled_dir


def record_build(seconds: float) -> None:
    """One nvcc build of the library: a miss, and its seconds."""
    with _lock:
        _counts["compiles"] += 1
        _counts["cache_misses"] += 1
        _counts["compile_seconds"] += seconds


def record_hit() -> None:
    """A library for these sources found on disk and loaded, no build."""
    with _lock:
        _counts["cache_hits"] += 1


def compile_count() -> int:
    """nvcc builds so far in this process."""
    with _lock:
        return _counts["compiles"]


def snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_counts)
