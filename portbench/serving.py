"""One run of a serving cell: set-up, the window, the output check.

Set-up builds what `native_server` builds for the cell's flags: the
program's `ServingEngine` over weights the benchmark made on the card
from the seed (the configuration's family makes them, and gives the
program's config and the reference), then `warmup()` (every chunk bucket
of the cell's chunk budget and the decode step), then the mix's warm
traffic, which is the start of the same traffic. The window drives
`ServingEngine.submit` through the mix's loop (`drivers/<kind>.py`) for
exactly `seconds`; a traced run profiles a fixed slice at its start.
Then the engine is closed and freed, the weights are made again from the
seed, and the reference judges a sample of the served requests
(check.py).
"""

import gc
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from portbench import check, weights
from portbench.client import Client
from portbench.profile import Slice, kernels_kept, reduce
from portbench.traffic import Request, make_requests

PROFILE_SECONDS = 6.0
# The engine's load gauges (live slots, KV blocks in use) are read this many
# times, evenly over the window.
LOAD_SAMPLES = 8
# Fewer kernels than this in a slice of a loaded engine means the profiler
# lost them (a serving step launches hundreds). Memcpys and memsets are not
# counted: a slice that lost its kernels has kept those.
MIN_DEVICE_OPS = 100
# Nor is a slice whole whose kernels fall short of this share of the
# launches it recorded: one that lost part of them reads too little busy
# time (whole slices on an H100 read 0.988 to 1.000).
MIN_KERNEL_SHARE = 0.98
# Engine counters whose change over the window a run's notes keep.
COUNTERS = ("prefill_tokens_computed_total", "prefill_chunks_total",
            "prefix_tokens_reused_total", "decode_seconds_total",
            "prefill_seconds_total", "idle_seconds_total", "kv_block_evictions_total")
LOAD_GAUGES = ("active", "slots", "kv_blocks_in_use", "kv_blocks_total", "pending")


def sleep_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


class ServingRun:
    """The state of one run, which the mix's loop drives and the metric
    readers read (`rec` in metrics/*.py)."""

    def __init__(self, cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, rate: Optional[float] = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.family = cell["family"]
        self.shapes = self.family.shapes(cell["config"])
        self.traffic = dict(cell["traffic"])
        if rate is not None:
            self.traffic["rate"] = rate
        self.setup: Dict[str, float] = {}
        self.requests: List[Request] = []
        self.attempted: List[Request] = []
        self.failed: List[Request] = []
        self.t0 = self.t1 = None
        self.stats0 = self.stats1 = self.stats_quarter = None
        self.load: List[Dict[str, float]] = []
        self.slice: Optional[Dict[str, Any]] = None
        self.prof: Optional[Slice] = None
        self.device_time: Optional[Dict[str, float]] = None
        self.memory_peak_bytes = 0
        self.drain_limit_s: Optional[float] = None
        self.notes: Dict[str, Any] = {}

    # -- set-up ---------------------------------------------------------------

    def build(self) -> None:
        from dstack_tpu_torch.workloads.serving import ServingEngine

        t = time.monotonic()
        self.setup["import_s"] = t - self.t_start
        w = self.family.make_weights(self.shapes, self.seed, self.device)
        self._sync()
        self.notes["weight_bytes"] = weights.weight_bytes(w)
        t2 = time.monotonic()
        self.setup["weights_s"] = t2 - t
        flags = dict(self.traffic["engine"])
        self.engine = ServingEngine(self.family.port_config(self.shapes), w,
                                    device=self.device, seed=self.seed % (1 << 63),
                                    temperature=0.0, **flags)
        del w  # the engine holds its own copy
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t3 = time.monotonic()
        self.setup["engine_s"] = t3 - t2
        self.notes["warmup"] = self.engine.warmup()
        t4 = time.monotonic()
        self.setup["warmup_s"] = t4 - t3
        if self.trace and self.device.type == "cuda":
            self.prof = Slice()
            self.prof.prepare()
            self.setup["profiler_s"] = time.monotonic() - t4
        self.client = Client(self.engine)

    def make_requests(self, n: int) -> None:
        t = time.monotonic()
        self.requests = make_requests(self.traffic, self.seed, self.shapes.vocab, n)
        self.setup["traffic_s"] = time.monotonic() - t

    # -- the window -------------------------------------------------------------

    def window(self, t0: float) -> None:
        """Warm traffic runs until t0, then the window for `seconds`, with
        the waiting queue read at its first quarter, the engine's load
        gauges LOAD_SAMPLES times, and the profiled slice at its start on
        a traced run: the load is steady by then (a standing queue, warm
        traffic before), and the device's tracing, on since set-up, is
        switched off at the slice's end for the rest of the window."""
        t_warm = time.monotonic()
        sleep_until(t0)
        self.t0 = time.monotonic()
        self.setup["warm_traffic_s"] = self.t0 - t_warm
        self.setup_s = self.t0 - self.t_start
        self.stats0 = self.engine.stats()
        W = self.seconds
        span = min(PROFILE_SECONDS, W)
        events = [(self.t0 + W / 4, "quarter")]
        events += [(self.t0 + W * (i + 0.5) / LOAD_SAMPLES, "load")
                   for i in range(LOAD_SAMPLES)]
        if self.trace:
            events.append((self.t0, "slice_start"))
        kept, whole, retry = None, False, True
        while events:
            t, what = min(events)
            events.remove((t, what))
            sleep_until(t)
            if what == "quarter":
                self.stats_quarter = self.engine.stats()
            elif what == "load":
                st = self.engine.stats()
                self.load.append({"t": time.monotonic(), **{k: st[k] for k in LOAD_GAUGES}})
            elif what == "slice_start":
                # The slice prepared in set-up, else (a retake) a new one.
                prof, self.prof = self.prof or Slice(), None
                prof.start()
                events.append((min(prof.t0 + span, self.t0 + W), "slice_stop"))
            else:
                prof.stop()
                kept = (prof.events(), prof.t1 - prof.t0)
                # A slice that lost its kernels, memcpys and memsets kept, is
                # taken again where the window has room.
                whole, kernels, launches = kernels_kept(kept[0], MIN_DEVICE_OPS,
                                                        MIN_KERNEL_SHARE)
                self.notes["slice_kernels_launches"] = [kernels, launches]
                if (not whole and retry
                        and time.monotonic() + span <= self.t0 + W):
                    self.notes["slice_retaken_after_kernels"] = kernels
                    retry = False
                    events.append((time.monotonic(), "slice_start"))
        sleep_until(self.t0 + W)
        self.t1 = time.monotonic()
        self.stats1 = self.engine.stats()
        self.notes["window_deltas"] = {k: self.stats1[k] - self.stats0[k] for k in COUNTERS}
        self.notes["active_at_close"] = self.stats1["active"]
        self.notes["load"] = [[x["active"], x["kv_blocks_in_use"], x["pending"]]
                              for x in self.load]
        if kept is None:
            return
        reading = reduce(*kept)
        self.device_time = {"busy_s": reading["busy_s"], "window_s": reading["window_s"]}
        if whole:
            self.slice = reading
            self.slice["paged_s"] = sum(v for k, v in self.slice["by_name"].items()
                                        if "ragged_paged_attention" in k)
        else:
            # Lost again, or no room left to retake: the trace's own busy
            # time stays in the line, marked, and nothing is read from it.
            self.notes["slice_lost_kernels"] = self.notes["slice_kernels_launches"]
            print("portbench: the profiled slice lost its kernels; its device"
                  " metrics and breakdown withheld", file=sys.stderr)

    # -- after the window -------------------------------------------------------

    def teardown(self) -> None:
        """Read the peak, then close and free the engine."""
        self._sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(self.device)
        self.engine.close()
        self.client.join()
        self.engine = None
        self.client.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            self.notes["allocated_after_close"] = torch.cuda.memory_allocated(self.device)

    def submitted(self) -> List[Request]:
        """Every request the loop submitted (window tokens may come from
        requests due before the window)."""
        return [r for r in self.requests if r.t_submit is not None]

    def finished(self) -> List[Request]:
        return [r for r in self.attempted if r.done]

    def check(self, spec: Dict[str, Any], quant: Optional[str] = None) -> Dict[str, Any]:
        """The cell's number (its checks file: which statistic of the
        served tokens' gaps, and its limit) over the sample, and the
        requests due that never completed (limit 0). With `quant` the
        control's reading of the same number as well."""
        t = time.monotonic()
        c = self.traffic["check"]
        picked = check.sample(self.finished(), self.seed, c["served_tokens"], c["max_requests"])
        w = self.family.make_weights(self.shapes, self.seed, self.device)
        readings = [check.gaps(self.family.logits, self.shapes, w, r, quant) for r in picked]
        del w
        served = [g for x in readings for g in x["served"]]
        value, limit = check.statistic(served, spec), spec.get("limit")
        out = {
            spec["name"]: {"value": value, "limit": limit},
            "missing": {"value": len(self.failed), "limit": 0},
            "widest_gap": max(served, default=None),
            "checked_tokens": len(served),
            "checked_requests": len(readings),
            "check_s": time.monotonic() - t,
        }
        if quant is not None:
            control = [g for x in readings for g in x["control"]]
            out["control"] = check.statistic(control, spec)
            out["control_widest_gap"] = max(control, default=None)
        out["correct"] = (bool(served) and limit is not None and value <= limit
                          and not self.failed)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def measure(loop, pool_size, cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, rate: Optional[float] = None, quant: Optional[str] = None):
    """Set-up, the mix's `loop` over the window, teardown and the check:
    (the run's record, the check's readings; with `quant` the control's
    reading too)."""
    h = ServingRun(cell, seed, seconds, trace, device, t_start, rate)
    h.build()
    h.make_requests(pool_size(h.traffic, seconds))
    loop(h)
    h.teardown()
    return h, h.check(cell["check"], quant)
