"""Per-tenant QoS primitives in front of the serving engine (the port's
copy of `dstack_tpu.dataplane.qos`: the same classes, names, defaults and
decisions; stdlib only).

Multi-tenant serving fails in one characteristic way: a single tenant
floods the queue and every other tenant's TTFT moves. The defense has
three independent layers, composed by `QoSGate`:

- `TokenBucket` — per-tenant rate limiting. A tenant whose bucket is
  empty is *shed* (HTTP 429) with a computed `Retry-After`, not queued:
  queueing overload just moves the latency to everyone behind it.
- `DRRQueue` — deficit round robin over per-tenant FIFOs. Admission
  order into the engine is decided per-round by deficit counters, so a
  tenant with 500 queued requests and a tenant with 2 still alternate
  (weighted by configuration) instead of draining in arrival order.
- `TenantLabels` — bounded-cardinality label mapping for metrics. The
  tenant id is an API key or adapter name chosen by clients; exporting
  it raw would let one client mint unbounded Prometheus series. Above
  the cap every new tenant collapses into the single ``overflow`` label.

Tenancy is identified by API key when present, else adapter name, else
the literal ``default`` — the same identity the prefix cache namespaces
KV blocks by (workloads/kv_blocks.BlockAllocator).

Everything here is clock-injectable (``clock=`` callables) so tests run
on frozen time, and thread-safe: `native_server` calls `admit` from one
handler thread per connection.
"""

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

OVERFLOW_TENANT = "overflow"
DEFAULT_TENANT = "default"


class TenantShedError(RuntimeError):
    """Raised by admission when a tenant exceeds its rate: the caller
    maps it to HTTP 429 with ``Retry-After: ceil(retry_after)``."""

    def __init__(self, tenant: str, retry_after: float):
        super().__init__(
            f"tenant {tenant!r} over rate limit;"
            f" retry after {retry_after:.1f}s"
        )
        self.tenant = tenant
        self.retry_after = float(retry_after)


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst`.

    NOT thread-safe on its own — QoSGate serializes access under its
    lock; standalone use from one thread (tests, bench) is fine."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._t) * self.rate
        )
        self._t = now

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will have refilled (0 if available
        now). The shed response's Retry-After is computed from this, so
        a compliant client that waits exactly this long is admitted."""
        self._refill()
        missing = n - self._tokens
        if missing <= 0:
            return 0.0
        return missing / self.rate


class DRRQueue:
    """Deficit round robin over per-tenant FIFOs (Shreedhar &
    Varghese): each round a tenant's deficit grows by `quantum x
    weight`; items pop while their cost fits the deficit. O(1) amortized
    per pop; a tenant's burst depth cannot starve another tenant's
    single queued item. NOT thread-safe on its own (see TokenBucket)."""

    def __init__(self, quantum: float = 1.0,
                 weights: Optional[Dict[str, float]] = None):
        self._quantum = float(quantum)
        self._weights = dict(weights or {})
        # tenant -> deque[(item, cost)]; OrderedDict doubles as the
        # round-robin ring (move_to_end on requeue).
        self._queues: "OrderedDict[str, Deque[Tuple[Any, float]]]" = (
            OrderedDict()
        )
        self._deficit: Dict[str, float] = {}
        self._len = 0

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def push(self, tenant: str, item: Any, cost: float = 1.0) -> None:
        q = self._queues.get(tenant)
        if q is None:
            q = deque()
            self._queues[tenant] = q
            self._deficit.setdefault(tenant, 0.0)
        q.append((item, float(cost)))
        self._len += 1

    def pop(self) -> Optional[Tuple[str, Any]]:
        """Next (tenant, item) in DRR order, or None when empty."""
        if self._len == 0:
            return None
        # Each iteration either pops an item or rotates one tenant to
        # the back with a bigger deficit; with >=1 queued item the
        # second visit to any tenant is guaranteed to afford its head
        # (deficit grows by quantum*weight each visit), so the loop is
        # bounded by 2 * n_tenants.
        for _ in range(2 * len(self._queues) + 1):
            tenant, q = next(iter(self._queues.items()))
            if not q:
                # Empty queue leaves the ring; deficit resets so a
                # returning tenant starts fresh instead of cashing in
                # credit accrued while absent.
                del self._queues[tenant]
                self._deficit.pop(tenant, None)
                continue
            item, cost = q[0]
            if self._deficit[tenant] < cost:
                self._deficit[tenant] += self._quantum * self.weight(tenant)
                self._queues.move_to_end(tenant)
                continue
            self._deficit[tenant] -= cost
            q.popleft()
            self._len -= 1
            if not q:
                del self._queues[tenant]
                self._deficit.pop(tenant, None)
            return tenant, item
        raise AssertionError("DRR pop did not converge")  # unreachable

    def remove(self, tenant: str, item: Any) -> bool:
        """Withdraw a queued item (admission timeout / disconnect)."""
        q = self._queues.get(tenant)
        if q is None:
            return False
        for entry in q:
            if entry[0] is item:
                q.remove(entry)
                self._len -= 1
                if not q:
                    del self._queues[tenant]
                    self._deficit.pop(tenant, None)
                return True
        return False

    def __len__(self) -> int:
        return self._len

    def depth(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return 0 if q is None else len(q)


class TenantLabels:
    """Bounded-cardinality tenant -> metric-label mapping: the first
    `cap` distinct tenants keep their names; later ones collapse into
    OVERFLOW_TENANT so client-chosen ids cannot mint unbounded series."""

    def __init__(self, cap: int = 64):
        if cap < 1:
            raise ValueError("cap must be >= 1")
        self._cap = cap
        self._known: Dict[str, str] = {}
        self._lock = threading.Lock()

    def label(self, tenant: str) -> str:
        tenant = tenant or DEFAULT_TENANT
        with self._lock:
            got = self._known.get(tenant)
            if got is not None:
                return got
            label = (
                tenant if len(self._known) < self._cap else OVERFLOW_TENANT
            )
            self._known[tenant] = label
            return label

    @property
    def known_count(self) -> int:
        with self._lock:
            return len(self._known)


class _Ticket:
    __slots__ = ("granted", "shed")

    def __init__(self) -> None:
        self.granted = False
        self.shed: Optional[TenantShedError] = None


class QoSGate:
    """Composed admission control in front of `ServingEngine.submit`.

    `check(tenant)` — non-blocking: take a token or raise
    TenantShedError. The async dataplane/proxy path uses this (ordering
    there is the engine's problem; the proxy only enforces rates).

    `admit(tenant)` — blocking: take a token (or shed), then wait for
    the request's DRR turn at one of `concurrency` grant permits
    (matched to the engine's slot count; a finished request's
    `release()` frees the permit). The native server calls this from
    its per-connection handler thread, so under contention the order in
    which handler threads reach `submit` IS weighted-fair, regardless
    of arrival order. Grants are advanced cooperatively by whichever
    waiter holds the condition — no pump thread to leak. With
    `concurrency=None` grants are unbounded (rate limiting only).

    Per-tenant overrides: `rates[tenant] = (rate, burst)` and
    `weights[tenant] = w` (default weight 1.0)."""

    def __init__(
        self,
        *,
        rate: float = 10.0,
        burst: float = 20.0,
        rates: Optional[Dict[str, Tuple[float, float]]] = None,
        weights: Optional[Dict[str, float]] = None,
        quantum: float = 1.0,
        tenant_cap: int = 64,
        concurrency: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._rate = float(rate)
        self._burst = float(burst)
        self._rates = dict(rates or {})
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._queue = DRRQueue(quantum=quantum, weights=weights)
        self._cond = threading.Condition()
        self._permits = concurrency
        self.labels = TenantLabels(cap=tenant_cap)
        self._admitted: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        self.grant_log: Deque[str] = deque(maxlen=4096)  # fairness probe

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            rate, burst = self._rates.get(tenant, (self._rate, self._burst))
            b = TokenBucket(rate, burst, clock=self._clock)
            self._buckets[tenant] = b
        return b

    def _take_or_shed(self, tenant: str, cost: float) -> None:
        # Caller holds _cond.
        bucket = self._bucket(tenant)
        label = self.labels.label(tenant)
        if not bucket.try_take(cost):
            self._shed[label] = self._shed.get(label, 0) + 1
            raise TenantShedError(tenant, bucket.retry_after(cost))
        self._admitted[label] = self._admitted.get(label, 0) + 1

    def check(self, tenant: str, cost: float = 1.0) -> None:
        """Rate-only admission (non-blocking, async-safe)."""
        tenant = tenant or DEFAULT_TENANT
        with self._cond:
            self._take_or_shed(tenant, cost)

    def admit(self, tenant: str, cost: float = 1.0,
              timeout: Optional[float] = 30.0) -> None:
        """Rate check + weighted-fair ordering (blocking)."""
        tenant = tenant or DEFAULT_TENANT
        ticket = _Ticket()
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            self._take_or_shed(tenant, cost)  # sheds before queueing
            self._queue.push(tenant, ticket, cost)
            self._cond.notify_all()
            while not ticket.granted:
                # Cooperative advance: the queue never waits on a pump —
                # any waiter may grant the DRR head (possibly itself)
                # while permits are free.
                if self._permits is None or self._permits > 0:
                    nxt = self._queue.pop()
                    if nxt is not None:
                        if self._permits is not None:
                            self._permits -= 1
                        nxt[1].granted = True
                        self.grant_log.append(nxt[0])
                        self._cond.notify_all()
                        continue
                if ticket.granted:
                    break
                if deadline is not None and self._clock() >= deadline:
                    if self._queue.remove(tenant, ticket):
                        raise TenantShedError(tenant, 1.0)
                    # Granted in the race with the deadline: proceed.
                    break
                self._cond.wait(timeout=0.05)

    def release(self) -> None:
        """Return a grant permit (request finished or failed). No-op
        when concurrency is unbounded."""
        with self._cond:
            if self._permits is not None:
                self._permits += 1
                self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "queued": len(self._queue),
                "tenants": self.labels.known_count,
                "admitted_total": dict(self._admitted),
                "shed_total": dict(self._shed),
            }
