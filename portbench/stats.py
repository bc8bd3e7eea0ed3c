"""Rates, tails and time per output token from the client's timestamps.

All times are `time.monotonic()` seconds taken by the benchmark's client
threads as each token leaves the engine's output queue. A request that
failed, or had no first token by the drain limit, counts as missing and
takes the drain limit as its latency, so missing requests push a tail up
rather than out.
"""

import math
from typing import Sequence

from portbench.traffic import Request


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile (the smallest value with at least
    p% of the values at or below it)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    k = max(0, math.ceil(p / 100.0 * len(xs)) - 1)
    return xs[k]


def window_tokens(reqs: Sequence[Request], t0: float, t1: float) -> int:
    """Prompt tokens of the requests whose first token reached the client
    in [t0, t1), plus every generated token that reached it in [t0, t1)."""
    total = 0
    for r in reqs:
        if r.times and t0 <= r.times[0] < t1:
            total += len(r.prompt)
        total += sum(1 for t in r.times if t0 <= t < t1)
    return total


def ttft(r: Request, limit: float) -> float:
    """Seconds from the request's due time to its first token at the
    client; `limit` when it failed or never had one."""
    if r.error is not None or not r.times:
        return limit
    return min(r.times[0] - r.t_due, limit)


def tpot(r: Request, limit: float) -> float:
    """(last token - first token) / (n - 1) in seconds, for a request that
    completed with n >= 2 tokens; `limit` when it failed or is missing."""
    if not r.done:
        return limit
    if len(r.times) < 2:
        return 0.0
    return (r.times[-1] - r.times[0]) / (len(r.times) - 1)
