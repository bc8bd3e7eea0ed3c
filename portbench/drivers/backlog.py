"""Kind "backlog": a batch job's standing queue.

`backlog` requests are submitted at once and each one that finishes is
replaced by the next, so the engine never runs dry; the mix's warm
seconds of the same traffic run before the window. Attempted are the
requests live at some point of the window; failed, those that ended in an
error before its close.
"""

import threading
import time

from portbench import serving
from portbench.serving import ServingRun


def pool_size(mix, seconds: float) -> int:
    return mix["requests"]


def loop(h: ServingRun) -> None:
    mix = h.traffic
    pending = iter(h.requests)
    lock = threading.Lock()
    stop = threading.Event()

    def refill(_done=None):
        if stop.is_set():
            return
        with lock:
            r = next(pending, None)
        if r is None:
            h.notes["pool_exhausted"] = True
            return
        h.client.submit(r, refill)

    for _ in range(mix["backlog"]):
        refill()
    h.window(time.monotonic() + mix["warm_seconds"])
    stop.set()
    t0, t1 = h.t0, h.t1
    live = [r for r in h.requests if r.t_submit is not None and r.t_submit < t1
            and (r.t_done is None or r.t_done >= t0)]
    h.attempted = live
    h.failed = [r for r in live if r.error is not None and r.t_done < t1]


def measure(cell, seed, seconds, trace, device, t_start, rate=None, quant=None):
    return serving.measure(loop, pool_size, cell, seed, seconds, trace, device, t_start,
                           rate, quant)
