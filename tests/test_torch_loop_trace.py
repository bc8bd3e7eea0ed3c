"""The serving engine's loop spans and stream counters on the CPU:
`LoopTrace`'s ring (capacity, overwriting, `dropped`, nothing kept while
off, open spans ending at `stop()`), its clock against the profiler's,
the spans of a running engine tiling each loop iteration, the counters
`prefill_stream_seconds_total`, `decode_stream_seconds_total` and
`decode_steps_total`, and the time-per-token histogram against the
client's own inter-token times."""

import threading
import time

import pytest
import torch

from dstack_tpu_torch.utils.flight_recorder import LoopTrace
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.transformer import init_params

CFG = PRESETS["tiny"].with_(dtype="float32")
ENGINE_KW = dict(slots=4, max_len=96, prefill_chunk_tokens=16, kv_block_size=8)
PHASES = {"loop.idle_wait", "loop.admit", "loop.blocks", "loop.prefill_launch",
          "loop.decode_launch", "loop.readback", "loop.first_token_wait", "loop.fan_out"}


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, device="cpu")


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


def _drain(q, times=None):
    out = []
    while True:
        tok = q.get(timeout=120)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return out
        if times is not None:
            times.append(time.monotonic())
        out.append(tok)


def _iterations(lt, n):
    """n iterations of two phases each: 3n spans."""
    for _ in range(n):
        lt.iteration()
        lt.phase("loop.admit")
        lt.phase("loop.fan_out")


@pytest.mark.parametrize("capacity,n,kept,dropped", [
    (8, 2, 6, 0),    # fits
    (6, 2, 5, 1),    # fills the ring: the newest capacity - 1 spans come back
    (4, 2, 3, 3),    # wraps: the same, the rest dropped
    (5, 7, 4, 17),
])
def test_ring_capacity_overwrite_and_dropped(capacity, n, kept, dropped):
    lt = LoopTrace(capacity)
    lt.start()
    _iterations(lt, n)
    got, lost = lt.stop()
    assert (len(got), lost) == (kept, dropped)
    assert len(got) + lost == 3 * n and len(got) <= capacity
    assert [s.name for s in got] == (["loop.iteration", "loop.admit", "loop.fan_out"] * n)[-kept:]
    for i, s in enumerate(got):
        assert s.start_ns <= s.end_ns
        if s.name == "loop.iteration":
            assert s.parent == -1
        else:  # its iteration, or -1 where the ring overwrote it
            assert s.parent == -1 or got[s.parent].name == "loop.iteration"
            assert s.parent < i
    # Phases telescope: each ends where the next span starts.
    assert all(a.end_ns == b.start_ns for a, b in zip(got, got[1:]) if b.name != "loop.admit")


def test_ring_keeps_nothing_while_off_and_joins_an_iteration_under_way(params):
    lt = LoopTrace(16)
    _iterations(lt, 2)      # spans written before start() are not this capture's
    lt.start()
    assert lt.stop() == ([], 0)
    lt.start()              # inside an iteration: it opens at its next phase
    lt.phase("loop.readback")
    lt.phase("loop.fan_out")
    lt.iteration()
    got, lost = lt.stop()
    assert lost == 0
    assert [(s.name, s.parent) for s in got] == [
        ("loop.iteration", -1), ("loop.readback", 0), ("loop.fan_out", 0),
        ("loop.iteration", -1)]
    assert got[0].start_ns == got[1].start_ns and got[2].end_ns == got[3].start_ns
    eng = tsrv.ServingEngine(CFG, params, device="cpu", **ENGINE_KW)
    try:
        _drain(eng.submit(_prompt(1, 20), max_new_tokens=6))
        assert eng.loop_trace.stop() == ([], 0)
    finally:
        eng.close()


def test_open_spans_end_at_stop():
    """The iteration and the phase still open at stop() end there, after
    their start and no later than stop()'s return."""
    lt = LoopTrace(16)
    lt.start()
    lt.iteration()
    lt.phase("loop.readback")
    time.sleep(0.002)
    got, lost = lt.stop()
    t_after = time.time_ns()
    assert lost == 0
    assert [(s.name, s.parent) for s in got] == [("loop.iteration", -1),
                                                 ("loop.readback", 0)]
    it, ph = got
    assert it.start_ns <= ph.start_ns < ph.end_ns == it.end_ns <= t_after
    assert ph.end_ns - ph.start_ns >= 2_000_000
    assert not lt.on
    lt.start()  # the next capture holds none of the last one's spans
    assert lt.stop() == ([], 0)


def test_captures_stay_whole_while_the_loop_thread_writes():
    """start()/stop() on one thread while another opens spans, with a
    short switch interval: every capture holds whole spans whose parents
    are earlier iterations, and never more than the ring."""
    import sys

    lt = LoopTrace(64)
    done = threading.Event()

    def loop():
        while not done.is_set():
            if lt.on:
                lt.iteration()
                lt.phase("loop.admit")
                lt.phase("loop.decode_launch")
                lt.phase("loop.readback")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        for _ in range(200):
            lt.start()
            time.sleep(0.0005)
            got, lost = lt.stop()
            assert lost >= 0 and len(got) <= lt.capacity
            for i, s in enumerate(got):
                assert s.name and 0 < s.start_ns <= s.end_ns
                assert s.parent == -1 or (s.parent < i and got[s.parent].name == "loop.iteration")
    finally:
        done.set()
        sys.setswitchinterval(old)
        th.join(timeout=10)
    assert not th.is_alive()


def test_spans_share_the_profilers_clock():
    """A record_function inside a span, on the same thread, nests within
    it on the span's clock."""
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    lt = LoopTrace()
    lt.start()
    lt.iteration()
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        lt.phase("loop.admit")
        with record_function("inside_the_span"):
            x = torch.randn(64, 64)
            for _ in range(20):
                x = x @ x / 64
            time.sleep(0.005)
        lt.phase("loop.fan_out")
    got, _ = lt.stop()
    span = next(s for s in got if s.name == "loop.admit")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside_the_span"]
    assert len(events) == 1
    e = events[0]
    tol = 1_000_000  # 1 ms
    assert span.start_ns - tol <= e.start_ns() <= e.end_ns() <= span.end_ns + tol
    assert e.end_ns() - e.start_ns() >= 4_000_000


def test_engine_spans_tile_iterations_and_device_counters_rise(params):
    eng = tsrv.ServingEngine(CFG, params, device="cpu", **ENGINE_KW)
    try:
        eng.warmup()
        s0 = eng.stats()
        t0 = time.monotonic()
        eng.loop_trace.start()
        qs = [eng.submit(_prompt(i, 10 + 9 * i), max_new_tokens=5 + i) for i in range(6)]
        for q in qs:
            _drain(q)
        time.sleep(0.05)  # an idle wait or two
        got, dropped = eng.loop_trace.stop()
        wall = time.monotonic() - t0
        s1 = eng.stats()
    finally:
        eng.close()
    assert dropped == 0
    names = {s.name for s in got}
    assert {"loop.iteration", "loop.admit", "loop.prefill_launch", "loop.decode_launch",
            "loop.readback", "loop.first_token_wait", "loop.fan_out"} <= names
    assert names <= PHASES | {"loop.iteration"}
    kids = {}
    for s in got:
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append(s)
    iters = [i for i, s in enumerate(got) if s.name == "loop.iteration"]
    assert len(iters) >= 6 and all(s.parent in iters for s in got if s.parent >= 0)
    for i in iters:
        it = got[i]
        phases = kids.get(i, [])
        assert phases, "an iteration with no phase"
        for p in phases:
            assert it.start_ns <= p.start_ns <= p.end_ns <= it.end_ns
        assert sum(p.end_ns - p.start_ns for p in phases) >= 0.9 * (it.end_ns - it.start_ns)
    d = {k: s1[k] - s0[k] for k in ("prefill_stream_seconds_total",
                                    "decode_stream_seconds_total", "decode_steps_total",
                                    "prefill_tokens_computed_total")}
    assert d["prefill_stream_seconds_total"] > 0 and d["decode_stream_seconds_total"] > 0
    assert d["prefill_stream_seconds_total"] + d["decode_stream_seconds_total"] <= wall
    assert d["decode_steps_total"] > 0 and d["decode_steps_total"] % 4 == 0
    assert d["prefill_tokens_computed_total"] == sum(10 + 9 * i for i in range(6))


def test_device_counters_render_on_metrics(params):
    eng = tsrv.ServingEngine(CFG, params, device="cpu", **ENGINE_KW)
    try:
        _drain(eng.submit(_prompt(2, 12), max_new_tokens=9))
        st = eng.stats()
        text = tsrv.prometheus_metrics(st)
    finally:
        eng.close()
    assert st["decode_steps_total"] >= 8
    for key, mtype in tsrv.PORT_SERIES.items():
        assert f"# TYPE {key} {mtype}" in text
    assert f"dstack_tpu_serving_decode_steps_total {st['decode_steps_total']}" in text
    assert (f"dstack_tpu_serving_prefill_stream_seconds_total"
            f" {st['prefill_stream_seconds_total']}") in text


def test_tpt_hist_reads_the_clients_time_per_token(params):
    """Every slot's wait since its last delivery over its tokens: with
    several slots live, the histogram's mean is the clients' mean gap
    between tokens (a chunk's seconds over every slot's tokens read
    that many times lower)."""
    eng = tsrv.ServingEngine(CFG, params, device="cpu", **ENGINE_KW)
    n_new = 1 + 4 * 6  # the first token, then full chunks of steps_per_sync
    try:
        eng.warmup()
        h0 = eng.stats()["tpt_hist"]
        times = [[] for _ in range(4)]
        qs = [eng.submit(_prompt(i, 8), max_new_tokens=n_new) for i in range(4)]
        threads = [threading.Thread(target=_drain, args=(q, t)) for q, t in zip(qs, times)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        h1 = eng.stats()["tpt_hist"]
    finally:
        eng.close()
    assert all(len(t) == n_new for t in times)
    client = sum(t[-1] - t[0] for t in times) / sum(len(t) - 1 for t in times)
    count = h1["count"] - h0["count"]
    engine = (h1["sum"] - h0["sum"]) / count
    assert count == 4 * 6
    assert abs(engine - client) <= 0.25 * client, (engine, client)
