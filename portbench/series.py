"""Several runs of one cell in one process, one JSON line each: the
readings the limits and the rate were set from (not part of a check).

    python3 -m portbench.series --workload <cell> --seeds 1,2,3 --seconds 10 \
        [--quant fp8] [--rates 1.0,1.5] [--trace 1] [--out file.jsonl]

With `--quant fp8` every run also reads the control (the reference in
fp8 at the same positions, check.py). With `--rates` each rate runs on
each seed (the knee sweep of an open loop). Every line holds the run's
end-to-end and per-layer metrics, its checks, and the waiting queue at
the window's first quarter and at its end.
"""

import argparse
import json
import sys
import time

from portbench import run, spec


def one(cell, seed, seconds, trace, rate, quant):
    import torch

    torch.cuda.reset_peak_memory_stats()
    rec, checks = run.measure(cell, seed, seconds, trace, "cuda", time.monotonic(),
                              rate=rate, quant=quant)
    line = {"seed": seed, "rate": rate, "trace": trace}
    for m in cell["end_to_end"] + (cell["per_layer"] if trace else []):
        try:
            line[m["name"]] = spec.load_module("metrics", m["name"]).read(rec)
        except (ValueError, KeyError, ZeroDivisionError) as e:
            line[m["name"]] = repr(e)
    line.update(attempted=len(rec.attempted), failed=len(rec.failed),
                queue_quarter=rec.stats_quarter["pending"], queue_end=rec.stats1["pending"],
                memory_peak_bytes=rec.memory_peak_bytes, setup=rec.setup, notes=rec.notes,
                checks=checks)
    if trace and rec.slice:
        line["busy_s"], line["window_s"] = rec.slice["busy_s"], rec.slice["window_s"]
        line["device_ops"] = rec.slice["device_ops"]
        line["idle_gaps"] = rec.slice["idle_gaps"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--rates", default="")
    p.add_argument("--quant", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    run.set_environment()
    cell = spec.cell(a.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench.series needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rates = [float(r) for r in a.rates.split(",") if r] or [None]
    sink = open(a.out, "a") if a.out else None
    try:
        for rate in rates:
            for seed in (int(s) for s in a.seeds.split(",")):
                line = json.dumps(one(cell, seed, a.seconds, bool(a.trace), rate, a.quant))
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
