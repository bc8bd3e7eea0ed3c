"""Per-request flight recorder: a bounded ring of phase timelines.

Each serving *request* gets one trace —
Dapper-style request-scoped tracing over the dataplane hot path. The
design constraints come from where it sits:

- **Fixed memory.** `capacity` trace slots are preallocated up front and
  recycled overwrite-oldest; a recorder never grows with traffic. The
  id index is evicted with the slot, so a recycled request's trace is
  simply gone (size the ring above max concurrent requests + the recent
  history you want to keep).
- **Zero allocation on the decode hot path.** A `RequestTrace` is a
  `__slots__` object whose per-chunk bookkeeping is plain attribute
  increments (`decode_steps += 1`); marks — the only appends — happen at
  phase *transitions*, of which a request has a handful over its whole
  life, never per token.
- **Telescoping phases.** A trace is an ordered list of transition marks;
  phase i spans mark[i] → mark[i+1] (the last phase ends at `t_end`), so
  per-phase durations sum *exactly* to the request's total latency, the
  same construction as the stage timeline's lane spans
  (docs/guides/observability.md).
- **Tail-based capture.** Full trace snapshots persist only for requests
  that were slow (`slow_ms`, inclusive) or ended in error/shed — the
  Dapper insight that the interesting traces live in the tail. The tail
  store is itself a bounded overwrite-oldest ring.

The PyTorch port keeps its own copy (stdlib plus the port's histogram
primitive) because it imports nothing of the JAX package.
"""

import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from dstack_tpu_torch.utils.histogram import HistogramData

# W3C traceparent: version-traceid-spanid-flags (https://www.w3.org/TR/trace-context/).
_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})"
    r"-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


def _trace_id(traceparent: str) -> Optional[str]:
    """The trace id of a valid traceparent header, else None (all-zero
    ids and version ff are invalid per the spec)."""
    m = _TRACEPARENT_RE.match(traceparent.strip().lower())
    if m is None or m["version"] == "ff":
        return None
    if m["trace_id"] == "0" * 32 or m["span_id"] == "0" * 16:
        return None
    return m["trace_id"]

# Canonical phase vocabulary (docs + dashboards key on these literals).
# Not every request visits every phase: a unified request never ships KV,
# a decode-role request starts at adoption, qos_admission only exists
# when the server gated the request before submit.
PHASES = (
    "qos_admission",    # native-server arrival -> engine submit
    "adapter_acquire",  # LoRA acquire inside submit (adapter requests)
    "queue_wait",       # submit -> admission pop (decode role: receipt)
    "prefill",          # admission -> first token finalized
    "kv_ship",          # prefill role: gather + wire + decode-side ack
    "kv_adopt",         # decode role: pop -> payload scattered into pool
    "kv_swap_out",      # preemption: chain gathered + parked host-side
    "kv_swap_in",       # readmission: chain scattered back into the pool
    "decode",           # first token delivered -> last token
    "proxy",            # dataplane worker: ingress -> upstream headers
)

_TERMINAL = ("ok", "error", "shed", "cancelled")


class RequestTrace:
    """One request's phase timeline + hot-path counters. Mutated by the
    engine threads without a lock: each field has a single writer at any
    point in the request's life, and readers (`to_dict`) tolerate a torn
    in-progress view — this is a flight recorder, not a ledger."""

    __slots__ = (
        "request_id", "x_request_id", "trace_id", "traceparent", "role",
        "status", "t_end", "marks",
        # hot-path counters (attribute increments only)
        "prefill_chunks", "prefill_tokens", "decode_steps", "decode_tokens",
        "spec_rounds", "spec_drafted", "spec_accepted", "spec_rejected",
        "kv_payload_bytes",
        "_clock",
    )

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.reset(None)

    def reset(self, request_id: Any, *, x_request_id: Optional[str] = None,
              trace_id: Optional[str] = None,
              traceparent: Optional[str] = None,
              role: str = "unified") -> None:
        self.request_id = request_id
        self.x_request_id = x_request_id
        self.trace_id = trace_id
        self.traceparent = traceparent
        self.role = role
        self.status: Optional[str] = None
        self.t_end: Optional[float] = None
        self.marks: List[Tuple[str, float]] = []
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.kv_payload_bytes = 0

    def mark(self, phase: str, t: Optional[float] = None) -> None:
        """Open `phase` (closing the previous one) at `t`."""
        self.marks.append((phase, self._clock() if t is None else t))

    @property
    def t_start(self) -> Optional[float]:
        return self.marks[0][1] if self.marks else None

    def total_seconds(self) -> float:
        if not self.marks:
            return 0.0
        end = self.t_end if self.t_end is not None else self._clock()
        return end - self.marks[0][1]

    def phase_durations(self) -> List[Tuple[str, float, float]]:
        """[(phase, start_offset_s, duration_s)] — telescoping: the sum
        of durations equals `total_seconds()` by construction."""
        if not self.marks:
            return []
        t0 = self.marks[0][1]
        end = self.t_end if self.t_end is not None else self._clock()
        out = []
        for i, (phase, t) in enumerate(self.marks):
            nxt = self.marks[i + 1][1] if i + 1 < len(self.marks) else end
            out.append((phase, t - t0, max(0.0, nxt - t)))
        return out

    def to_dict(self) -> Dict[str, Any]:
        counters = {
            k: getattr(self, k)
            for k in ("prefill_chunks", "prefill_tokens", "decode_steps",
                      "decode_tokens", "spec_rounds", "spec_drafted",
                      "spec_accepted", "spec_rejected", "kv_payload_bytes")
            if getattr(self, k)
        }
        return {
            "request_id": self.request_id,
            "x_request_id": self.x_request_id,
            "trace_id": self.trace_id,
            "traceparent": self.traceparent,
            "role": self.role,
            "status": self.status if self.status is not None else "in_flight",
            "total_seconds": self.total_seconds(),
            "phases": [
                {"phase": p, "start_s": s, "duration_s": d}
                for p, s, d in self.phase_durations()
            ],
            "counters": counters,
        }


class TailStore:
    """Bounded store of full trace snapshots for tail-latency debugging.
    Captures when the total crossed `slow_ms` (inclusive — a request *at*
    the threshold is a slow request) or the request ended badly; disabled
    entirely when `slow_ms` is None."""

    def __init__(self, slow_ms: Optional[float], capacity: int = 64):
        self.slow_ms = slow_ms
        self.capacity = max(1, capacity)
        self._snaps: List[Dict[str, Any]] = []
        self._next = 0
        self.captured_total = 0

    @property
    def enabled(self) -> bool:
        return self.slow_ms is not None

    def should_capture(self, total_seconds: float, status: str) -> bool:
        if self.slow_ms is None:
            return False
        if status in ("error", "shed"):
            return True
        return total_seconds * 1000.0 >= self.slow_ms

    def capture(self, snapshot: Dict[str, Any]) -> None:
        self.captured_total += 1
        if len(self._snaps) < self.capacity:
            self._snaps.append(snapshot)
        else:
            self._snaps[self._next] = snapshot
            self._next = (self._next + 1) % self.capacity

    def snapshots(self) -> List[Dict[str, Any]]:
        return list(self._snaps)


class FlightRecorder:
    """Preallocated ring of `RequestTrace` slots with an id index.

    `capacity == 0` disables recording entirely: `begin()` returns None
    and every engine-side mark site is a no-op `if rec is not None`
    guard — recorder off means zero retained traces, not empty ones.
    """

    def __init__(self, capacity: int = 256, *,
                 slow_ms: Optional[float] = None,
                 tail_capacity: int = 64,
                 role: str = "unified",
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = max(0, int(capacity))
        self.role = role
        self._clock = clock
        self._ring = [RequestTrace(clock) for _ in range(self.capacity)]
        self._next = 0
        self._index: Dict[Any, RequestTrace] = {}
        self._lock = threading.Lock()
        self.tail = TailStore(slow_ms, tail_capacity)
        self.phase_hist: Dict[str, HistogramData] = {}
        self.started_total = 0
        self.finished_total = 0
        self.recycled_total = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def begin(self, request_id: Any, *, x_request_id: Optional[str] = None,
              traceparent: Optional[str] = None,
              first_phase: str = "queue_wait",
              t0: Optional[float] = None) -> Optional[RequestTrace]:
        """Claim a slot (overwrite-oldest) and open `first_phase`.
        Returns None when the recorder is disabled."""
        if not self.capacity:
            return None
        trace_id = None
        if traceparent:
            trace_id = _trace_id(traceparent)
        with self._lock:
            rec = self._ring[self._next]
            self._next = (self._next + 1) % self.capacity
            if rec.marks:  # slot held a previous request: evict its keys
                self.recycled_total += 1
                for key in (rec.request_id, rec.x_request_id):
                    if key is not None and self._index.get(key) is rec:
                        del self._index[key]
            self.started_total += 1
            if request_id is None:
                request_id = f"req-{self.started_total}"
            rec.reset(request_id, x_request_id=x_request_id,
                      trace_id=trace_id, traceparent=traceparent,
                      role=self.role)
            self._index[request_id] = rec
            if x_request_id is not None:
                self._index[x_request_id] = rec
        rec.mark(first_phase, self._clock() if t0 is None else t0)
        return rec

    def finish(self, rec: Optional[RequestTrace], status: str = "ok",
               t_end: Optional[float] = None) -> None:
        """Close the trace: stamp the terminal status, feed the per-phase
        histograms, and tail-capture when it qualifies. Idempotent — the
        first terminal status wins (handoff/cancel races call this from
        more than one path)."""
        if rec is None or rec.t_end is not None:
            return
        rec.t_end = self._clock() if t_end is None else t_end
        rec.status = status if status in _TERMINAL else "error"
        with self._lock:
            self.finished_total += 1
            for phase, _start, duration in rec.phase_durations():
                hist = self.phase_hist.get(phase)
                if hist is None:
                    hist = self.phase_hist[phase] = HistogramData()
                hist.observe(duration)
            if self.tail.should_capture(rec.total_seconds(), rec.status):
                self.tail.capture(rec.to_dict())

    def record_dropped(self, request_id: Any, *, status: str = "shed",
                       x_request_id: Optional[str] = None,
                       traceparent: Optional[str] = None,
                       t0: Optional[float] = None) -> None:
        """One-shot trace for a request refused before it got a timeline
        (a QoS shed): one qos_admission phase, terminal at once, so the
        tail store still sees it."""
        rec = self.begin(request_id, x_request_id=x_request_id,
                         traceparent=traceparent, first_phase="qos_admission",
                         t0=t0)
        self.finish(rec, status)

    def get(self, key: Any) -> Optional[Dict[str, Any]]:
        """Trace snapshot by engine request id or client X-Request-ID:
        the live ring first, then the tail store (a slow trace outlives
        its recycled ring slot there)."""
        with self._lock:
            rec = self._index.get(key)
            if rec is None and isinstance(key, str) and key.isdigit():
                rec = self._index.get(int(key))
            if rec is not None:
                return rec.to_dict()
            for snap in reversed(self.tail.snapshots()):
                if key in (snap.get("request_id"), snap.get("x_request_id")):
                    return snap
        return None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "started_total": self.started_total,
                "finished_total": self.finished_total,
                "recycled_total": self.recycled_total,
                "tail_enabled": self.tail.enabled,
                "tail_slow_ms": self.tail.slow_ms,
                "tail_captured_total": self.tail.captured_total,
            }

    def phase_histograms(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {p: h.to_dict() for p, h in self.phase_hist.items()}
