"""The benchmark's overlay of the engine loop's spans on a profiled
slice's device-idle time (`portbench.spans`), on synthetic intervals: an
idle gap goes to the innermost span around it, and the slice's numbers
stay those of `profile.reduce`."""

import pytest

from dstack_tpu_torch.utils.flight_recorder import Span
from portbench import profile, spans as pspans


def _span(name, a, b, parent):
    return Span(name, a, b, parent)


def test_overlay_puts_idle_gaps_to_spans_and_leaves_the_slice_unchanged():
    ms = 1_000_000
    ev = {"device": [(0, 10 * ms, "k0"), (20 * ms, 30 * ms, "k1"), (31 * ms, 40 * ms, "k2"),
                     (55 * ms, 60 * ms, "k0")],
          "host": [(0, 62 * ms, "host_op")]}
    spans = [
        _span("loop.iteration", -5 * ms, 33 * ms, -1),
        _span("loop.readback", -5 * ms, 12 * ms, 0),
        _span("loop.admit", 12 * ms, 18 * ms, 0),           # idle 12-18
        _span("loop.prefill_launch", 18 * ms, 30.5 * ms, 0),  # idle 18-20, 30-30.5
        _span("loop.iteration", 33 * ms, 70 * ms, -1),      # its own time: idle 30.5-31
        _span("loop.decode_launch", 42 * ms, 50 * ms, 4),   # idle 42-50
    ]
    wall = 0.062
    base = profile.reduce(ev, wall)
    out = pspans.reduce_with_spans(ev, wall, spans, 0, 0, 50 * ms)
    for k in ("busy_s", "window_s", "device_ops", "by_name"):
        assert out[k] == base[k], k
    assert [g[1] for g in out["idle_gaps"]] == [g[1] for g in base["idle_gaps"]]
    by = out["idle_by_span"]
    assert by["loop.readback"] == pytest.approx(0.002)       # 10-12 ms
    assert by["loop.admit"] == pytest.approx(0.006)          # 12-18
    assert by["loop.prefill_launch"] == pytest.approx(0.0025)  # 18-20, 30-30.5
    assert by["loop.decode_launch"] == pytest.approx(0.008)  # 42-50
    # The iterations' own time: 30.5-31 and 40-42 ms. The spans end at the
    # profiler's stop (50 ms), so 50-55 and 60-62 ms are outside them.
    assert by["loop.iteration"] == pytest.approx(0.0025)
    assert by["outside_spans"] == pytest.approx(0.007)
    assert sum(by.values()) == pytest.approx(wall - base["busy_s"])
    assert out["idle_launch_s"] == pytest.approx(0.0105)
    assert out["idle_sched_s"] == pytest.approx(0.006 + 0.0025)
    assert out["spans_dropped"] == 0
    # Longest first: 40-55, 10-20, 60-62, 30-31 ms, each by its middle.
    assert [g[0] for g in out["idle_gaps"]] == [
        "loop.decode_launch | host_op", "loop.admit | host_op", "host_op",
        "loop.iteration | host_op"]
