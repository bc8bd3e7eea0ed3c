"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's traffic kind picks its loop
(`drivers/<kind>.py`); each metric the cell reports is read by
`metrics/<name>.py` (the end-to-end metrics with --trace 0, the per-layer
metrics with --trace 1). The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device, with --trace 1 a
breakdown of the profiled slice, and last the numbers compared with their
limits, which are also the last lines of standard error.

The run needs as many CUDA cards as the cell asks for and exits non-zero
without a result otherwise, and also when JAX or the JAX package was
loaded into this process by the time the window has closed. Every cache
the program builds into stays inside the checkout (portbench/.cache/).
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

CACHE = spec.PKG / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dstack_tpu")
# Notes kept for `series` (per-request readings), left out of the result line.
BULKY_NOTES = ("per_request",)


def set_environment() -> None:
    """Fixed cache directories inside the checkout, and no Flax."""
    os.environ["DSTACK_TPU_COMPILE_CACHE"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: dstack_tpu_torch is not dstack_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, rate=None, quant=None):
    """One run of `cell`: the record the metric readers read, and the
    output check's readings (with `quant`, the control's as well)."""
    driver = spec.load_module("drivers", cell["traffic"]["kind"])
    return driver.measure(cell, seed, seconds, trace, device, t_start, rate=rate, quant=quant)


def result(cell, rec, checks, trace: bool, kind: str) -> dict:
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = spec.load_module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": bool(checks["correct"]), "attempted": len(rec.attempted),
           "failed": len(rec.failed), "metrics": metrics, "device": device}
    if trace and rec.device_time:
        device.update(rec.device_time)
    if trace and rec.slice:
        out["breakdown"] = {"device_ops": [[n, v] for n, v in rec.slice["device_ops"]],
                            "idle_gaps": rec.slice["idle_gaps"]}
    out["setup_parts"] = rec.setup
    out["notes"] = {k: v for k, v in rec.notes.items() if k not in BULKY_NOTES}
    out["checks"] = {k: v for k, v in checks.items() if isinstance(v, dict)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_environment()
    cell = spec.cell(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {a.workload} needs {cell['chips']} CUDA card(s);"
              f" cuda available: {torch.cuda.is_available()},"
              f" cards: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, checks = measure(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    out = result(cell, rec, checks, bool(a.trace), torch.cuda.get_device_name())
    for k, v in rec.setup.items():
        print(f"setup {k} {v:.3f}", file=sys.stderr)
    for k, v in out["notes"].items():
        print(f"note {k} {v}", file=sys.stderr)
    for k, v in checks.items():
        if not isinstance(v, dict):
            print(f"check {k} {v}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
