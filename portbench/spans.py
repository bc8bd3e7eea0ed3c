"""The engine loop's spans over the device-idle time of a profiled slice.

`ServingEngine.loop_trace` (the program's `LoopTrace`) stamps its spans
with `time.time_ns()`, the clock of the profiler's events, so a span and
a device interval compare with no offset. `reduce_with_spans` takes the
slice's events, its wall time, the spans `loop_trace.stop()` returned and
the host clock's ns at the profiler's start and stop, and returns what
`profile.reduce` returns, every number as it computes it, with:

- `idle_by_span`: the slice's device-idle seconds by the innermost loop
  span around them (a phase, else the iteration's own time, named
  `loop.iteration`), and `outside_spans` for idle time in no iteration;
- `idle_launch_s` / `idle_sched_s`: the idle seconds inside the launch
  phases, and inside the scheduling phases with the iterations' own time;
- `spans_dropped`: spans the ring overwrote before it was read;
- the longest idle gaps relabelled `<span> | <label>` where a loop span
  covers a gap's middle.

Spans are clipped to the profiler's start and stop. A phase lies inside
its iteration, and the spans of one depth do not overlap (the ring's
phases telescope), which the sweep below relies on.
"""

from typing import Any, Dict, List, Sequence, Tuple

from portbench.profile import gaps, label, reduce

LAUNCH = ("loop.prefill_launch", "loop.decode_launch")
SCHED = ("loop.admit", "loop.blocks", "loop.first_token_wait", "loop.fan_out",
         "loop.iteration")
Clipped = Tuple[int, int, str]


def clip(spans: Sequence[Any], lo: int, hi: int) -> Tuple[List[Clipped], List[Clipped]]:
    """(iterations, phases): each as (start_ns, end_ns, name) inside
    [lo, hi], sorted by start."""
    iters, phases = [], []
    for s in spans:
        a, b = max(s.start_ns, lo), min(s.end_ns, hi)
        if b > a:
            (phases if s.parent >= 0 else iters).append((a, b, s.name))
    return sorted(iters), sorted(phases)


def overlap(intervals: List[Tuple[int, int]], spans: List[Clipped]) -> Dict[str, int]:
    """ns of `intervals` (sorted, disjoint) inside spans of each name
    (`spans` sorted and disjoint)."""
    out: Dict[str, int] = {}
    j = 0
    for a, b in intervals:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            ov = min(b, spans[k][1]) - max(a, spans[k][0])
            if ov > 0:
                out[spans[k][2]] = out.get(spans[k][2], 0) + ov
            k += 1
    return out


def innermost(t: int, iters: List[Clipped], phases: List[Clipped]):
    """The name of the innermost span around t, or None."""
    for level in (phases, iters):
        for a, b, name in level:
            if a <= t < b:
                return name
    return None


def reduce_with_spans(ev: Dict[str, List], wall_s: float, spans: Sequence[Any],
                      dropped: int, t0_ns: int, t1_ns: int, top: int = 10) -> Dict[str, Any]:
    out = reduce(ev, wall_s, top)
    iters, phases = clip(spans, t0_ns, t1_ns)
    ivs = [(a, b) for a, b, _ in ev["device"] if b > a]
    idle: List[Tuple[int, int]] = []
    ranked: List[Tuple[int, int]] = []
    if ivs:
        # The stretches `reduce` labels, found the same way.
        lo = min(a for a, _ in ivs)
        hi = max(b for _, b in ivs)
        host_lo = min((a for a, _, _ in ev["host"]), default=lo)
        host_hi = max((b for _, b, _ in ev["host"]), default=hi)
        idle = gaps(ivs, min(lo, host_lo), max(hi, host_hi))
        ranked = sorted(idle, key=lambda x: x[0] - x[1])[:top]
    by_phase = overlap(idle, phases)
    in_iters = sum(overlap(idle, iters).values())
    total = sum(b - a for a, b in idle)
    by_span = {k: v / 1e9 for k, v in by_phase.items()}
    by_span["loop.iteration"] = (in_iters - sum(by_phase.values())) / 1e9
    by_span["outside_spans"] = (total - in_iters) / 1e9
    out["idle_by_span"] = by_span
    out["idle_launch_s"] = sum(by_span.get(k, 0.0) for k in LAUNCH)
    out["idle_sched_s"] = sum(by_span.get(k, 0.0) for k in SCHED)
    out["spans_dropped"] = dropped
    for g, row in zip(ranked, out["idle_gaps"]):
        name = innermost((g[0] + g[1]) // 2, iters, phases)
        if name is not None:
            row[0] = f"{name} | {label(g, ev['host'])}"
    return out
