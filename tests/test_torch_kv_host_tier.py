"""The host KV tier of the PyTorch port against the JAX package's.

`HostKVTier` runs the unit script of tests/test_kv_host_tier.py in step
with the JAX tier (put, get, pop, LRU under budget, pinned reservations,
replace, clear), counters equal after every step; its payloads are torch
tensors, byte counts their raw bytes. The engine cases of
tests/test_kv_host_tier.py (tiny, f32, on the CPU) hold the port's
temperature-0 streams against JAX `generate` token for token: a spilled
prefix swapping back as a host hit, preempt and resume, overcommit past
the resident cap, a heavier tenant jumping the queue, cancel while
swapped out, and with speculation the drafter's pool riding the swap."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.generate import generate as jgenerate
from dstack_tpu.workloads.kv_host_tier import HostKVTier as JTier
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.kv_host_tier import HostKVTier as TTier
from dstack_tpu_torch.workloads.weights import params_from_numpy

JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")


# -- the tier, in step with the JAX tier ------------------------------------------


class _Both:
    """One JAX tier and one port tier driven by the same calls: every
    call's answer and the counters after it must agree."""

    def __init__(self, budget):
        self.j, self.t = JTier(budget), TTier(budget)

    def put(self, key, n, seed=0):
        a = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        r = self.j.put(key, [("k", a)]), self.t.put(key, [("k", torch.from_numpy(a))])
        self.check(r)
        return r[0]

    def call(self, name, *args):
        r = getattr(self.j, name)(*args), getattr(self.t, name)(*args)
        if name == "get":
            r = (None if r[0] is None else r[0]["k"].tolist(),
                 None if r[1] is None else r[1]["k"].tolist())
        self.check(r)
        return r[0]

    def check(self, r):
        assert r[0] == r[1]
        assert self.j.stats() == self.t.stats()
        assert list(self.j._spilled) == list(self.t._spilled)


def test_tier_put_get_pop_and_counters():
    b = _Both(1 << 20)
    assert b.put("a", 16) is True
    assert b.call("has", "a") and b.t.blocks == 1
    assert b.call("get", "a") is not None and b.call("has", "a")
    b.call("pop", "a")
    assert not b.call("has", "a") and b.call("get", "a") is None
    s = b.t.stats()
    assert s["spills_total"] == 1 and s["swap_ins_total"] == 1 and s["spill_bytes"] == 0


def test_tier_lru_eviction_under_budget_pressure():
    b = _Both(3 * 64 * 4)
    for key in ("a", "b", "c"):
        assert b.put(key, 64)
    b.call("get", "a")  # "b" becomes the LRU
    assert b.put("d", 64)
    assert not b.call("has", "b") and b.call("has", "a") and b.call("has", "c")
    assert b.t.stats()["evictions_total"] == 1
    assert b.put("huge", 64 * 4) is False
    assert b.t.stats()["dropped_total"] == 1


def test_tier_pinned_reservations_evict_spills_but_never_pins():
    one = 64 * 4
    b = _Both(3 * one)
    for key in ("a", "b", "c"):
        b.put(key, 64)
    assert b.call("reserve", 2 * one) is True
    assert b.t.blocks == 1 and b.t.pinned_bytes == 2 * one
    assert b.call("reserve", 2 * one) is False
    assert b.put("big", 128) is False
    b.call("unreserve", 2 * one)
    assert b.t.pinned_bytes == 0
    for tier in (b.j, b.t):
        with pytest.raises(AssertionError):
            tier.unreserve(1)


def test_tier_replace_and_clear_keep_accounting_exact():
    b = _Both(1 << 16)
    b.put("a", 16, seed=1)
    b.put("a", 32, seed=2)
    assert b.t.blocks == 1 and b.t.stats()["spill_bytes"] == 32 * 4
    assert len(b.call("get", "a")) == 32
    for i in range(3):
        b.put(("F", bytes([i])), 8)
    assert b.call("reserve", 4096)
    assert b.call("clear") == 4
    assert b.t.stats()["pinned_bytes"] == 4096 and b.call("clear") == 0


def test_tier_counts_raw_bytes_of_bf16_and_holds_host_tensors_only():
    t = TTier(1 << 20)
    x = torch.randn(2, 3, 4).to(torch.bfloat16)
    assert t.put("k", [("k", x), ("v", x.float())]) and t.spill_bytes == 24 * 2 + 24 * 4
    assert torch.equal(t.get("k")["k"], x)
    with pytest.raises(ValueError):
        t.put("m", [("k", torch.empty(1, device="meta"))])


# -- the engine -------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=120)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return out
        out.append(tok)


def _reference(jp, prompt, n):
    toks = jgenerate(JCFG, jp, jnp.asarray([prompt], jnp.int32), max_new_tokens=n,
                     temperature=0.0)
    return [int(t) for t in toks[0]]


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


def _engine(tp, **kw):
    kw.setdefault("prefill_chunk_tokens", 16)
    kw.setdefault("kv_block_size", 8)
    return tsrv.ServingEngine(TCFG, tp, device="cpu", **kw)


def _assert_no_residue(engine):
    st = engine.stats()
    assert st["kv_blocks_in_use"] == st["kv_blocks_cached"], st
    assert st["slots_swapped"] == 0, st
    if engine._host_tier is not None:
        assert engine._host_tier.pinned_bytes == 0, engine._host_tier.stats()


def test_spilled_prefix_swaps_back_as_host_hit(weights):
    jp, tp = weights
    engine = _engine(tp, slots=2, max_len=64, kv_pool_blocks=16,
                     kv_host_budget_bytes=32 << 20)
    try:
        p0 = _prompt(1, 24)
        first = _drain(engine.submit(p0, max_new_tokens=8, temperature=0.0))
        assert first == _reference(jp, p0, 8)
        for s in range(2, 10):  # 8 distinct prompts > a 16-block pool
            _drain(engine.submit(_prompt(s, 24), max_new_tokens=8, temperature=0.0))
        st = engine.stats()
        assert st["kv_spills_total"] > 0 and st["kv_host_blocks"] > 0, st
        assert _drain(engine.submit(p0, max_new_tokens=8, temperature=0.0)) == first
        st = engine.stats()
        assert st["prefix_cache_host_hits_total"] >= 1 and st["kv_swap_ins_total"] >= 1, st
        assert (st["prefix_cache_device_hits_total"] + st["prefix_cache_host_hits_total"]
                == st["prefix_cache_hits_total"]), st
        text = tsrv.prometheus_metrics(st)
        assert "dstack_tpu_serving_prefix_cache_host_hits_total 1" in text
        assert "dstack_tpu_serving_kv_swap_in_seconds_count" in text
    finally:
        engine.close()
    _assert_no_residue(engine)


def test_preempt_and_resume_is_token_exact_at_temp0(weights):
    jp, tp = weights
    engine = _engine(tp, slots=2, max_len=96, kv_host_budget_bytes=32 << 20)
    try:
        prompt = _prompt(11, 20)
        out = engine.submit(prompt, max_new_tokens=24, temperature=0.0)
        got = [out.get(timeout=60) for _ in range(4)]  # mid-generation
        engine.preempt(out)
        assert got + _drain(out) == _reference(jp, prompt, 24)
        st = engine.stats()
        assert st["slot_preemptions_total"] >= 1 and st["slot_swap_ins_total"] >= 1, st
        assert st["swap_in_hist"]["count"] >= 1, st
    finally:
        engine.close()
    _assert_no_residue(engine)


def test_overcommit_admits_past_resident_capacity(weights):
    jp, tp = weights
    engine = _engine(tp, slots=6, max_len=64, kv_host_budget_bytes=64 << 20,
                     max_resident_slots=2)
    try:
        outs = [(s, engine.submit(_prompt(30 + s, 16), max_new_tokens=10, temperature=0.0))
                for s in range(6)]
        for s, q in outs:
            assert _drain(q) == _reference(jp, _prompt(30 + s, 16), 10), s
        st = engine.stats()
        assert st["admitted_total"] == 6 and st["max_resident_slots"] == 2, st
    finally:
        engine.close()
    _assert_no_residue(engine)


def test_heavier_tenant_queue_jumps_lighter_live_slot(weights):
    jp, tp = weights
    engine = _engine(tp, slots=1, max_len=96, kv_host_budget_bytes=32 << 20,
                     qos_weights={"paid": 8.0})
    try:
        slow_prompt = _prompt(41, 20)
        slow = engine.submit(slow_prompt, max_new_tokens=32, temperature=0.0,
                             tenant="besteffort")
        first = [slow.get(timeout=60) for _ in range(2)]  # live mid-decode
        fast_prompt = _prompt(42, 16)
        fast = engine.submit(fast_prompt, max_new_tokens=6, temperature=0.0,
                             tenant="paid")
        assert _drain(fast) == _reference(jp, fast_prompt, 6)
        assert engine.stats()["slot_preemptions_total"] >= 1
        assert first + _drain(slow) == _reference(jp, slow_prompt, 32)
        assert engine.stats()["slot_swap_ins_total"] >= 1
    finally:
        engine.close()
    _assert_no_residue(engine)


def test_cancel_while_swapped_out_leaves_zero_residue(weights):
    jp, tp = weights
    engine = _engine(tp, slots=2, max_len=96, kv_host_budget_bytes=32 << 20,
                     max_resident_slots=1)
    try:
        q1 = engine.submit(_prompt(51, 20), max_new_tokens=40, temperature=0.0)
        got1 = [q1.get(timeout=60) for _ in range(2)]
        q2 = engine.submit(_prompt(52, 16), max_new_tokens=24, temperature=0.0)
        engine.preempt(q1)
        deadline = time.monotonic() + 30
        while engine.stats()["slots_swapped"] != 1:
            assert time.monotonic() < deadline, engine.stats()
            time.sleep(0.01)
        engine.cancel(q1)
        toks1 = got1 + _drain(q1)
        ref1 = _reference(jp, _prompt(51, 20), 40)
        assert toks1 == ref1[:len(toks1)] and len(toks1) < 40
        assert _drain(q2) == _reference(jp, _prompt(52, 16), 24)
        assert engine.stats()["slots_swapped"] == 0
    finally:
        engine.close()
    _assert_no_residue(engine)


def test_close_answers_swapped_out_requests_and_unpins(weights):
    """close() with a request parked host-side: its consumer gets the
    close error (not a clean end) and the tier's pinned bytes return."""
    engine = _engine(weights[1], slots=2, max_len=96, kv_host_budget_bytes=32 << 20,
                     max_resident_slots=1)
    q1 = engine.submit(_prompt(61, 20), max_new_tokens=60, temperature=0.0)
    q1.get(timeout=60)
    q2 = engine.submit(_prompt(62, 16), max_new_tokens=60, temperature=0.0)
    engine.preempt(q1)
    deadline = time.monotonic() + 30
    while engine.stats()["slots_swapped"] != 1:
        assert time.monotonic() < deadline, engine.stats()
        time.sleep(0.01)
    engine.close()
    for q in (q1, q2):
        with pytest.raises(RuntimeError, match="closed"):
            _drain(q)
    assert engine._host_tier.pinned_bytes == 0 and engine.stats()["slots_swapped"] == 0


def test_spec_and_tier_together_the_drafter_pool_rides_the_swap(weights):
    """Preempt a speculating slot: its chain parks with both pools' rows
    and comes back into fresh blocks of both; the target drafting for
    itself keeps accepting every draft after the resume, which it could
    not with stale drafter rows; the stream stays token-exact."""
    jp, tp = weights
    engine = _engine(tp, slots=2, max_len=96, kv_host_budget_bytes=32 << 20,
                     spec_enable=True, spec_draft_params=tp, spec_draft_config=TCFG,
                     spec_max_draft=3)
    parked = []
    real = engine._preempt_slot

    def spy(slot):
        ok = real(slot)
        parked.append(sorted(engine._swapped[-1].arrays) if ok else None)
        return ok

    engine._preempt_slot = spy
    try:
        prompt = _prompt(71, 20)
        out = engine.submit(prompt, max_new_tokens=30, temperature=0.0)
        got = [out.get(timeout=60) for _ in range(3)]
        engine.preempt(out)
        assert got + _drain(out) == _reference(jp, prompt, 30)
        st = engine.stats()
        assert parked == [["draft_k", "draft_v", "k", "v"]]
        assert st["slot_swap_ins_total"] == 1 and st["spec_tokens_rejected_total"] == 0, st
        with pytest.raises(RuntimeError, match="lacks"):
            engine._inject_chain({"k": None, "v": None}, [0])
    finally:
        engine.close()
    _assert_no_residue(engine)


def test_host_tier_refuses_a_budget_of_zero():
    for tier in (JTier, TTier):
        with pytest.raises(ValueError, match="host tier budget"):
            tier(0)
