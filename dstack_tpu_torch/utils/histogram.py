"""Log-bucket duration histogram (the port's copy of
`dstack_tpu.server.tracing.HistogramData`, same buckets and snapshot form,
so `/metrics` renders the same series from either engine)."""

import bisect
from typing import Any, Dict

# 1 ms .. ~69 min doubling: 23 finite buckets + implicit +Inf.
LOG_BUCKETS: tuple = tuple(0.001 * (2 ** i) for i in range(23))


class HistogramData:
    """One labelled histogram series: per-bucket counts + sum + count.

    `counts[i]` is the NON-cumulative count of observations in bucket i
    (<= LOG_BUCKETS[i]); the last slot is the +Inf overflow. Snapshots
    compute the cumulative `le` form Prometheus expects."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple = LOG_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        self.counts[idx] += 1
        self.sum += value
        self.count += 1

    def to_dict(self) -> Dict[str, Any]:
        cumulative = []
        running = 0
        for le, n in zip(self.buckets, self.counts):
            running += n
            cumulative.append((le, running))
        return {
            "buckets": cumulative,  # [(le_seconds, cumulative_count), ...]
            "sum": self.sum,
            "count": self.count,
        }
