"""The port's per-tenant QoS gate (dstack_tpu_torch/utils/qos.py): the
cases of tests/test_qos.py on the port's copy, the same frozen-clock
sequence through the JAX gate and the port's with equal decisions and
retry_after values, and native_server's --qos-rate: a 429 with
Retry-After to the tenant over its bucket, a 200 to another tenant, the
per-tenant series, and a shed's one-shot trace."""

import json
import math
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from dstack_tpu.dataplane import qos as jqos
from dstack_tpu_torch.utils.qos import (
    DEFAULT_TENANT,
    OVERFLOW_TENANT,
    DRRQueue,
    QoSGate,
    TenantLabels,
    TenantShedError,
    TokenBucket,
)


class FrozenClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# --- token bucket ------------------------------------------------------------


def test_token_bucket_burst_then_refill():
    clk = FrozenClock()
    b = TokenBucket(rate=2.0, burst=4.0, clock=clk)
    # Full burst is available immediately.
    for _ in range(4):
        assert b.try_take()
    assert not b.try_take()
    # 2 tokens/s: after 1.5s exactly 3 tokens have refilled.
    clk.advance(1.5)
    assert b.tokens == pytest.approx(3.0)
    assert b.try_take(3.0)
    assert not b.try_take(0.5)


def test_token_bucket_caps_at_burst():
    clk = FrozenClock()
    b = TokenBucket(rate=100.0, burst=5.0, clock=clk)
    clk.advance(3600.0)
    assert b.tokens == pytest.approx(5.0)


def test_token_bucket_retry_after_is_exact():
    clk = FrozenClock()
    b = TokenBucket(rate=2.0, burst=2.0, clock=clk)
    assert b.try_take(2.0)
    # Empty: 1 token refills in 0.5s at 2/s.
    assert b.retry_after(1.0) == pytest.approx(0.5)
    assert b.retry_after(2.0) == pytest.approx(1.0)
    # A compliant client that waits exactly retry_after is admitted.
    clk.advance(0.5)
    assert b.retry_after(1.0) == 0.0
    assert b.try_take(1.0)


def test_token_bucket_rejects_bad_params():
    with pytest.raises(ValueError):
        TokenBucket(rate=0, burst=1)
    with pytest.raises(ValueError):
        TokenBucket(rate=1, burst=0)


# --- deficit round robin -----------------------------------------------------


def test_drr_alternates_under_asymmetric_burst():
    """A tenant with 10 queued items and one with 2 alternate: the
    burst depth cannot push the small tenant to the back of the line."""
    q = DRRQueue()
    for i in range(10):
        q.push("flood", f"f{i}")
    q.push("steady", "s0")
    q.push("steady", "s1")
    order = [q.pop()[0] for _ in range(12)]
    # Both steady items are served within the first four grants.
    assert order[:4].count("steady") == 2
    assert len(q) == 0
    assert q.pop() is None


def test_drr_weights_bias_throughput():
    q = DRRQueue(quantum=1.0, weights={"gold": 2.0})
    for i in range(8):
        q.push("gold", f"g{i}")
        q.push("best-effort", f"b{i}")
    first8 = [q.pop()[0] for _ in range(8)]
    # Weight 2 earns two pops per round vs one: ~2/3 of early grants.
    assert first8.count("gold") > first8.count("best-effort")


def test_drr_remove_and_depth():
    q = DRRQueue()
    item = object()
    q.push("a", item)
    q.push("a", "other")
    assert q.depth("a") == 2
    assert q.remove("a", item)
    assert not q.remove("a", item)  # already gone
    assert q.depth("a") == 1
    assert q.pop() == ("a", "other")
    assert q.depth("a") == 0


def test_drr_returning_tenant_starts_fresh():
    """Deficit does not accrue while a tenant has nothing queued — an
    idle tenant cannot bank credit and burst past the others later."""
    q = DRRQueue()
    q.push("a", "a0")
    assert q.pop() == ("a", "a0")
    for i in range(4):
        q.push("b", f"b{i}")
    q.push("a", "a1")
    order = [q.pop()[0] for _ in range(5)]
    # "a" gets exactly its one item, interleaved, not a banked run.
    assert order.count("a") == 1


# --- tenant label cardinality ------------------------------------------------


def test_tenant_labels_cap_collapses_to_overflow():
    labels = TenantLabels(cap=3)
    assert labels.label("t1") == "t1"
    assert labels.label("t2") == "t2"
    assert labels.label("t3") == "t3"
    # Cap reached: client-chosen ids can no longer mint new series.
    assert labels.label("t4") == OVERFLOW_TENANT
    assert labels.label("t999") == OVERFLOW_TENANT
    # Known tenants keep their own label even after the cap is hit.
    assert labels.label("t2") == "t2"
    assert labels.known_count == 5


def test_tenant_labels_default_for_empty():
    labels = TenantLabels(cap=4)
    assert labels.label("") == DEFAULT_TENANT
    assert labels.label(None) == DEFAULT_TENANT


# --- composed gate -----------------------------------------------------------


def test_gate_check_sheds_with_retry_after():
    clk = FrozenClock()
    gate = QoSGate(rate=1.0, burst=2.0, clock=clk)
    gate.check("t")
    gate.check("t")
    with pytest.raises(TenantShedError) as ei:
        gate.check("t")
    assert ei.value.tenant == "t"
    assert ei.value.retry_after == pytest.approx(1.0)
    # Other tenants have their own bucket — unaffected by t's flood.
    gate.check("u")
    # After the advertised wait, t is admitted again.
    clk.advance(1.0)
    gate.check("t")
    s = gate.stats()
    assert s["shed_total"] == {"t": 1}
    assert s["admitted_total"] == {"t": 3, "u": 1}


def test_gate_per_tenant_rate_overrides():
    clk = FrozenClock()
    gate = QoSGate(rate=1.0, burst=1.0, rates={"gold": (100.0, 50.0)}, clock=clk)
    for _ in range(50):
        gate.check("gold")
    gate.check("plain")
    with pytest.raises(TenantShedError):
        gate.check("plain")


def test_gate_admit_unbounded_is_rate_only():
    clk = FrozenClock()
    gate = QoSGate(rate=5.0, burst=5.0, clock=clk)  # concurrency=None
    for _ in range(5):
        gate.admit("t", timeout=0.0)
    with pytest.raises(TenantShedError):
        gate.admit("t", timeout=0.0)
    gate.release()  # no-op when unbounded


def test_gate_admit_drr_fairness_under_contention():
    """With one grant permit held, a flood of queued tenant-a admits and
    one tenant-b admit interleave in DRR order: b is granted among the
    first two permits released, regardless of arrival order."""
    gate = QoSGate(rate=1000.0, burst=1000.0, concurrency=1)
    gate.admit("a")  # takes the only permit; everyone below queues

    done = []
    lock = threading.Lock()

    def worker(tenant):
        gate.admit(tenant, timeout=10.0)
        with lock:
            done.append(tenant)

    threads = [threading.Thread(target=worker, args=("a",)) for _ in range(5)]
    threads.append(threading.Thread(target=worker, args=("b",)))
    for t in threads[:5]:
        t.start()
    deadline = time.time() + 5.0
    while gate.stats()["queued"] < 5 and time.time() < deadline:
        time.sleep(0.01)
    threads[5].start()  # b arrives LAST, behind a 5-deep a-burst
    while gate.stats()["queued"] < 6 and time.time() < deadline:
        time.sleep(0.01)
    assert gate.stats()["queued"] == 6

    for _ in range(6):
        gate.release()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=5.0)
    assert len(done) == 6
    grants = list(gate.grant_log)[1:]  # drop the unqueued first admit
    assert "b" in grants[:2], f"DRR should interleave b early, got {grants}"


def test_gate_admit_timeout_sheds():
    gate = QoSGate(rate=1000.0, burst=1000.0, concurrency=1)
    gate.admit("a")  # permit taken
    t0 = time.monotonic()
    with pytest.raises(TenantShedError):
        gate.admit("b", timeout=0.2)
    assert time.monotonic() - t0 < 5.0
    gate.release()
    # The timed-out ticket was withdrawn: the freed permit goes to a
    # fresh admit, not a ghost.
    gate.admit("c", timeout=1.0)


# --- lockstep with the JAX gate ----------------------------------------------


def _run_sequence(mod, seed):
    """A frozen-clock sequence of checks over 3 tenants with per-tenant
    overrides; every decision and retry_after, then the stats."""
    clk = FrozenClock()
    gate = mod.QoSGate(rate=2.0, burst=3.0, rates={"gold": (5.0, 6.0)},
                       weights={"gold": 2.0}, tenant_cap=2, clock=clk)
    rng = random.Random(seed)
    out = []
    for _ in range(200):
        clk.advance(rng.choice((0.0, 0.05, 0.1, 0.37, 1.0)))
        tenant = rng.choice(("gold", "t1", "t2", ""))
        cost = rng.choice((1.0, 1.0, 2.0))
        try:
            gate.check(tenant, cost)
            out.append(("ok", tenant))
        except mod.TenantShedError as e:
            out.append(("shed", e.tenant, e.retry_after))
    return out, gate.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_decisions_and_retry_after_equal_the_jax_gate(seed):
    import dstack_tpu_torch.utils.qos as tqos

    assert _run_sequence(tqos, seed) == _run_sequence(jqos, seed)


def test_drr_order_equals_the_jax_queue():
    import dstack_tpu_torch.utils.qos as tqos

    def order(mod):
        q = mod.DRRQueue(quantum=1.0, weights={"gold": 3.0, "b": 1.5})
        rng = random.Random(5)
        for i in range(60):
            q.push(rng.choice(("gold", "a", "b")), i)
        return [q.pop() for _ in range(61)]

    assert order(tqos) == order(jqos)


# --- native_server --qos-rate ------------------------------------------------


def _call(method, url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


MSG = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
       "temperature": 0}


def test_native_server_qos_rate_sheds_with_retry_after_and_counts_tenants():
    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

    engine = Engine("tiny", 8, device="cpu", slots=2, qos_rate=1.0, qos_burst=2.0,
                    trace_slow_ms=0.0)
    # The gate as the server builds it, on a frozen clock: no token refills
    # however long the chats take.
    assert isinstance(engine.qos, QoSGate) and engine.tenant_labels is engine.qos.labels
    engine.qos = QoSGate(rate=1.0, burst=2.0, concurrency=16, clock=FrozenClock())
    engine.tenant_labels = engine.qos.labels
    server, ready = make_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        start_warmup(engine, ready).join(timeout=60)
        got = [_call("POST", base + "/v1/chat/completions", MSG,
                     {"Authorization": "Bearer flood", "X-Request-ID": f"f{i}"})
               for i in range(6)]
        codes = [c for c, _, _ in got]
        assert codes == [200, 200, 429, 429, 429, 429], codes
        for code, body, hdrs in got[2:]:
            err = json.loads(body)["error"]
            assert err["type"] == "rate_limited" and err["tenant"] == "flood"
            assert err["retry_after"] == 1.0  # one token short at 1/s
            assert hdrs["Retry-After"] == str(max(1, math.ceil(err["retry_after"])))
        assert _call("POST", base + "/v1/chat/completions", MSG,
                     {"Authorization": "Bearer other"})[0] == 200
        shed = next(i for i, (c, _, _) in enumerate(got) if c == 429)
        trace = engine.serving.request_trace(f"f{shed}")
        assert trace["status"] == "shed"
        assert [p["phase"] for p in trace["phases"]] == ["qos_admission"]
        ok = engine.serving.request_trace("f0")
        assert [p["phase"] for p in ok["phases"]][:2] == ["qos_admission", "queue_wait"]
        code, text, _ = _call("GET", base + "/metrics?format=prometheus")
        n_shed = codes.count(429)
        assert 'dstack_tpu_serving_tenant_requests_total{tenant="flood"} 2' in text
        assert 'dstack_tpu_serving_tenant_requests_total{tenant="other"} 1' in text
        assert f'dstack_tpu_serving_tenant_shed_total{{tenant="flood"}} {n_shed}' in text
        assert 'dstack_tpu_serving_tenant_ttft_seconds_count{tenant="other"} 1' in text
        from dstack_tpu.server.metrics_registry import METRICS

        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, mtype = line.split()
                assert name in METRICS and METRICS[name][0] == mtype, line
        stats = json.loads(_call("GET", base + "/metrics")[1])
        assert stats["qos"]["shed_total"] == {"flood": n_shed}
        assert stats["qos"]["admitted_total"] == {"flood": 2, "other": 1}
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.close()
