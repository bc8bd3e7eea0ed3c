"""The profiled slice of a traced run, reduced to intervals and sums.

The slice is a fixed stretch at the start of the window under
`torch.profiler` (CPU and CUDA activities), so the trace's event count
stays bounded. Events are read off the profiler's raw kineto results,
without building its Python event tree (a copy of the method of
`chip_smoke.device_kernels`). Device busy time is the union of the
device's operation intervals, so kernels that overlap on two streams are
counted once; an idle gap is a stretch of the slice in which no device
operation ran, labelled by the host operations that span it: a CUDA
runtime call of any thread, or none (the engine's Python between calls).
"""

import time
from typing import Any, Dict, List, Optional, Tuple

Interval = Tuple[int, int]


class Slice:
    """Start and stop the profiler on the window's clock.

    `prepare()` switches the device's tracing on (CUPTI's activity records)
    and `start()` opens the slice: the profiler keeps only what happens
    after it. On an H100 under a serving cell's load, sessions switched on
    and off while the engine's threads launched have lost all or part of
    their kernel records, the launches and copies kept, for seconds at a
    time and often for the rest of the process; one session kept on for
    40 s kept every kernel. So a traced run switches tracing on once, in
    set-up while the engine is idle, and keeps it on until its slice ends."""

    def __init__(self):
        self.prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None

    def prepare(self) -> None:
        """Profile the device, and the host's CUDA runtime calls from every
        thread (CUPTI records those). Host operators are recorded on the
        starting thread only: with every operator of the engine's loop
        thread recorded as well, a 6 s slice of the Mistral docs cell on an H100 read
        0.76 s of device time where a run without them read 2.05 s, an idle
        share that the profiler itself made. The first preparation in a
        process initialises CUPTI, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.prepare_trace()

    def start(self) -> None:
        if self.prof is None:
            self.prepare()
        self.prof.start_trace()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop_trace()

    def events(self) -> Dict[str, List[Tuple[int, int, str]]]:
        """{"device": [(start_ns, end_ns, name)], "host": [...]}."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            item = (e.start_ns(), e.end_ns(), e.name())
            (dev if e.device_type() == cuda else host).append(item)
        return {"device": dev, "host": host}


def kernel_count(device: List[Tuple[int, int, str]]) -> int:
    """The device events that are kernels: neither a memcpy nor a memset
    (the profiler names those "Memcpy HtoD (...)", "Memset (Device)")."""
    return sum(1 for _, _, n in device if not n.lower().startswith(("memcpy", "memset")))


def launch_count(host: List[Tuple[int, int, str]]) -> int:
    """The host's kernel launches that the slice recorded (CUDA runtime and
    driver calls: cudaLaunchKernel, cuLaunchKernelEx, ...)."""
    return sum(1 for _, _, n in host if n.startswith(("cudaLaunch", "cuLaunch")))


def kernels_kept(ev: Dict[str, List], least: int, share: float) -> Tuple[bool, int, int]:
    """Whether a slice kept its kernels: at least `least`, and at least
    `share` of the launches it recorded (a launch just before the start
    can run inside, one just before the stop has ended by it). Also the
    two counts."""
    k, n = kernel_count(ev["device"]), launch_count(ev["host"])
    return k >= least and k >= share * n, k, n


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(intervals: List[Interval]) -> int:
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for a, b in union(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def label(gap: Interval, host: List[Tuple[int, int, str]]) -> str:
    """The outermost and innermost host operations that span the gap's
    middle ("outer > inner"), or "host work outside any recorded op"."""
    mid = (gap[0] + gap[1]) // 2
    spanning = [(b - a, n) for a, b, n in host if a <= mid < b]
    if not spanning:
        return "host work outside any recorded op"
    spanning.sort()
    inner, outer = spanning[0][1], spanning[-1][1]
    return inner if inner == outer else f"{outer} > {inner}"


def reduce(ev: Dict[str, List], wall_s: float, top: int = 10) -> Dict[str, Any]:
    """busy_s, the idle share, device time by name and the longest idle
    gaps of the slice (the wall is the host clock's slice length)."""
    dev = ev["device"]
    ivs = [(a, b) for a, b, _ in dev if b > a]
    busy = busy_ns(ivs) / 1e9
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    out: Dict[str, Any] = {"busy_s": busy, "window_s": wall_s, "by_name": by_name,
                           "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
                           "idle_gaps": []}
    if ivs:
        lo = min(a for a, _ in ivs)
        hi = max(b for _, b in ivs)
        host_lo = min((a for a, _, _ in ev["host"]), default=lo)
        host_hi = max((b for _, b, _ in ev["host"]), default=hi)
        g = sorted(gaps(ivs, min(lo, host_lo), max(hi, host_hi)), key=lambda x: x[0] - x[1])
        out["idle_gaps"] = [[label(x, ev["host"]), (x[1] - x[0]) / 1e9] for x in g[:top]]
    return out
