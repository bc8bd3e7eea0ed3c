"""Kind "open_rate": independent users at a fixed rate (an open loop).

Each request is submitted at its due time, whether or not earlier ones
have finished; arrivals start the mix's warm seconds before the window
and stop when it closes. Then the loop waits until every request due in
the window has completed, or the drain limit has passed. A request is
timed from its due time, so a late generator or a stalled engine shows in
every request behind it; how late the generator ran is kept. Attempted
are the requests due in the window; failed, those that did not complete
by the drain limit.
"""

import threading
import time

from portbench import serving, stats
from portbench.serving import ServingRun, sleep_until


def pool_size(mix, seconds: float) -> int:
    span = mix["warm_seconds"] + seconds + mix["drain_seconds"]
    return int(mix["rate"] * span * 1.25) + mix["block"]


def loop(h: ServingRun) -> None:
    mix = h.traffic
    origin = time.monotonic() + 0.05
    for r in h.requests:
        r.t_due = origin + r.due
    stop = threading.Event()
    late = []
    t_close = origin + mix["warm_seconds"] + h.seconds

    def schedule():
        for r in h.requests:
            d = r.t_due - time.monotonic()
            if d > 0 and stop.wait(d):
                return
            if stop.is_set():
                return
            if r.t_due >= t_close:
                return
            h.client.submit(r)
            late.append(r.t_submit - r.t_due)
        h.notes["pool_exhausted"] = True

    th = threading.Thread(target=schedule, daemon=True)
    th.start()
    h.window(origin + mix["warm_seconds"])
    stop.set()
    th.join()
    due = [r for r in h.requests if h.t0 <= r.t_due < t_close]
    deadline = h.t1 + mix["drain_seconds"]
    while time.monotonic() < deadline and any(r.t_done is None for r in due):
        sleep_until(min(deadline, time.monotonic() + 0.05))
    h.t_drained = time.monotonic()
    h.notes["generator_late_max_s"] = max(late, default=0.0)
    h.attempted = due
    h.failed = [r for r in due if not r.done]
    h.drain_limit_s = mix["drain_seconds"] + h.seconds
    h.notes["per_request"] = [[round(stats.ttft(r, h.drain_limit_s), 4),
                               round(1e3 * stats.tpot(r, h.drain_limit_s), 3),
                               len(r.prompt), r.system_len, r.max_new] for r in due]


def measure(cell, seed, seconds, trace, device, t_start, rate=None, quant=None):
    return serving.measure(loop, pool_size, cell, seed, seconds, trace, device, t_start,
                           rate, quant)
