"""Speculative decoding in the PyTorch port against the JAX package (tiny,
f32, bridged weights, on the CPU): `_sampling_probs` (1e-6), the draft
program (drafts equal, qlogits within 1e-5 of max |logit|, written pool
rows within 1e-6 of the pool's max |value|) and the verify program (emitted, accepted, lengths,
last_token, active, remaining equal) on the same pools and tables; the
rejection sampler's first emitted token against the target distribution
(chi-square, alpha 1e-3); and the engine cases of
tests/test_serving_spec.py, whose temperature-0 streams must equal JAX
`generate` token for token.

Tolerances: the programs run the same f32 arithmetic in another order
(XLA against eager PyTorch), so probs are held within 1e-6, pool rows
within 1e-6 of the pool's max |value| and logits within 1e-5 of their
max |logit|; every token, count and length is held equal."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import kv_blocks as jkv
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.generate import generate as jgenerate
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import kv_blocks as tkv
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import params_from_numpy

JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")
CPU = torch.device("cpu")
NB, BS, ML, B = 24, 8, 64, 3


def _bridge(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    return jp, _bridge(jp)


@pytest.fixture(scope="module")
def bad_drafter():
    # Same architecture, other weights: its greedy drafts disagree with
    # the target's almost everywhere.
    jp = jinit(JCFG, jax.random.PRNGKey(7))
    return jp, _bridge(jp)


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


# -- _sampling_probs ------------------------------------------------------------


@pytest.mark.parametrize("top_p", [(1.0, 1.0, 1.0, 1.0), (0.9, 1.0, 0.5, 0.3)])
def test_sampling_probs_match_jax(top_p):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 3, 50)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    tps = np.array(top_p, np.float32)
    want = np.asarray(jkv._sampling_probs(jnp.asarray(logits), jnp.asarray(temps),
                                          jnp.asarray(tps)))
    got = tkv._sampling_probs(torch.from_numpy(logits), torch.from_numpy(temps),
                              torch.from_numpy(tps))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if top_p[1] < 1.0 or top_p[2] < 1.0:
        assert (want == 0).any()  # the nucleus filter ran in both


# -- the two programs on the same state -------------------------------------------


def _state(seed=0, shared_pools=False):
    """Random pools, scattered tables and per-slot scalars, as JAX and
    port states, and the drafter's pools (the target's own with
    `shared_pools`): slot 2 is inactive with a stale table, slot 1 sits
    near the end of its window (rows past max_len are dropped)."""
    rng = np.random.default_rng(seed)
    shape = (TCFG.n_layers, NB, BS, TCFG.n_kv_heads, TCFG.head_dim)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    perm = rng.permutation(NB).tolist()
    tables = np.full((B, ML // BS), NB, np.int32)
    tables[0, :4] = perm[:4]
    tables[1, :8] = perm[4:12]
    tables[2, :3] = perm[12:15]
    scal = dict(lengths=np.array([13, 60, 9], np.int32),
                last_token=np.array([5, 17, 40], np.int32),
                active=np.array([True, True, False]),
                remaining=np.array([20, 9, 0], np.int32),
                temperature=np.zeros(B, np.float32),
                top_p=np.ones(B, np.float32))
    js = jkv.init_paged_state(JCFG, B, ML, BS, NB)._replace(
        k=jnp.asarray(pools[0]), v=jnp.asarray(pools[1]),
        block_tables=jnp.asarray(tables),
        **{f: jnp.asarray(a) for f, a in scal.items()})
    ts = tkv.init_paged_state(TCFG, B, ML, BS, NB, CPU)
    ts.k[:, :NB] = torch.from_numpy(pools[0])
    ts.v[:, :NB] = torch.from_numpy(pools[1])
    ts.block_tables[:] = torch.from_numpy(tables)
    for f, a in scal.items():
        setattr(ts, f, torch.from_numpy(a.copy()))
    return js, ts, pools[:2] if shared_pools else pools[2:]


def _draft_state(pools):
    ds = tkv.init_paged_state(TCFG, B, ML, BS, NB, CPU)
    ds.k[:, :NB] = torch.from_numpy(pools[0])
    ds.v[:, :NB] = torch.from_numpy(pools[1])
    return ds


def _draft_both(weights, drafter, k, js, ts, pools):
    jp, tp = drafter
    jfn, tfn = jkv.make_spec_draft(JCFG, k), tkv.make_spec_draft(TCFG, k)
    jdk, jdv, jd, jq = jfn(jp, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
                           js.block_tables, js.lengths, js.last_token, js.active,
                           js.temperature, js.top_p, jax.random.PRNGKey(3))
    ds = _draft_state(pools)
    td, tq = tfn(tp, ds, ts.block_tables, ts.lengths, ts.last_token, ts.active,
                 ts.temperature, ts.top_p, None, sampling=False, nucleus=False)
    return (jdk, jdv, jd, jq), (ds, td, tq)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_spec_draft_matches_jax(weights, k):
    js, ts, pools = _state()
    (jdk, jdv, jd, jq), (ds, td, tq) = _draft_both(weights, weights, k, js, ts, pools)
    assert td.dtype == torch.int32 and td.tolist() == np.asarray(jd).tolist()
    jq = np.asarray(jq)
    assert tq.shape == jq.shape == (B, k, TCFG.vocab_size)
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-5 * np.abs(jq).max(), rtol=0)
    # Every pool row, the k+1 written ones included (and nothing of the
    # inactive slot, nor past max_len).
    for t, j in ((ds.k, jdk), (ds.v, jdv)):
        _rows_close(t[:, :NB].numpy(), np.asarray(j))
    assert not np.array_equal(ds.k[:, :NB].numpy(), pools[0])


def _rows_close(got, want):
    """Pool rows within 1e-6 of the pool's max |value|: rows written by
    the last of tiny's layers carry four layers of f32 reordering (up to
    3.6e-6 at values near 3)."""
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


def _verify_both(weights, k, js, ts, jd, jq):
    jp, tp = weights
    js2, je, ja, jact = jkv.make_spec_verify(JCFG, k)(jp, js, jd, jq,
                                                      jax.random.PRNGKey(4))
    ts, te, ta, tact = tkv.make_spec_verify(TCFG, k)(
        tp, ts, torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(jq)),
        None, sampling=False, nucleus=False)
    return (js2, je, ja, jact), (ts, te, ta, tact)


@pytest.mark.parametrize("k,reject_at", [(3, None), (3, 1), (4, 0), (2, 1)])
def test_spec_verify_matches_jax_at_temperature_0(weights, bad_drafter, k, reject_at):
    """Drafts from the target itself (all accepted, bonus token), or with
    one draft replaced so the run stops at `reject_at`."""
    js, ts, pools = _state(shared_pools=True)
    (_, _, jd, jq), _ = _draft_both(weights, weights, k, js, ts, pools)
    jd = np.asarray(jd).copy()
    if reject_at is not None:
        jd[:, reject_at] = (jd[:, reject_at] + 1) % TCFG.vocab_size
    jd = jnp.asarray(jd)
    (js2, je, ja, jact), (ts2, te, ta, tact) = _verify_both(weights, k, js, ts, jd, jq)
    assert te.tolist() == np.asarray(je).tolist()
    assert ta.tolist() == np.asarray(ja).tolist()
    assert tact.tolist() == np.asarray(jact).tolist()
    for f in ("lengths", "last_token", "active", "remaining"):
        assert getattr(ts2, f).tolist() == np.asarray(getattr(js2, f)).tolist(), f
    _rows_close(ts2.k[:, :NB].numpy(), np.asarray(js2.k))
    want_m = k if reject_at is None else reject_at
    assert ta.tolist()[0] == want_m and ta.tolist()[2] == 0
    # Slot 1 is capped by its window: at most ML - 1 - 60 = 3 tokens.
    assert int((te[1] >= 0).sum()) == min(want_m + 1, 3)


# -- the rejection sampler keeps the target distribution ---------------------------


def test_rejection_sampler_keeps_the_target_distribution():
    """Vocab 8, fixed p (the target's probs at position 0) and q (the
    drafter's, from which d_1 is drawn): the first emitted token — d_1 if
    accepted, else the correction from norm(max(p - q, 0)) — must follow
    p. 24k draws, chi-square at alpha 1e-3 (critical value 24.32 at 7
    degrees of freedom), seed fixed."""
    from dstack_tpu_torch.workloads.config import ModelConfig

    V, N, k = 8, 24_000, 1
    p = torch.tensor([0.30, 0.05, 0.20, 0.02, 0.18, 0.10, 0.10, 0.05])
    q = torch.tensor([0.05, 0.30, 0.10, 0.20, 0.05, 0.10, 0.15, 0.05])
    cfg = ModelConfig(vocab_size=V, d_model=8, n_layers=1, n_heads=1,
                      n_kv_heads=1, d_ff=8, max_seq_len=16, dtype="float32")
    g = torch.Generator().manual_seed(1234)
    draws = torch.multinomial(q.expand(N, V), 1, replacement=True, generator=g)
    # Logits with softmax(logits / T) = p at T 1: the model is replaced by
    # a head that returns log p at every position.
    params = _constant_head_params(cfg, torch.log(p))
    st = tkv.init_paged_state(cfg, N, 16, 8, 2, CPU)
    st.active[:] = True
    st.remaining[:] = 4
    st.temperature[:] = 1.0
    qlogits = torch.log(q).expand(N, k, V).contiguous()
    _, emitted, _, _ = tkv.make_spec_verify(cfg, k)(
        params, st, draws.to(torch.int32), qlogits, g, sampling=True, nucleus=False)
    first = emitted[:, 0].to(torch.int64)
    counts = torch.bincount(first, minlength=V).double()
    expected = p.double() * N
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts.tolist())
    # And not merely the drafter's: q fails the same test.
    chi2_q = float(((counts - q.double() * N) ** 2 / (q.double() * N)).sum())
    assert chi2_q > 1000


def _constant_head_params(cfg, logp):
    """Params whose forward ignores its input and returns `logp` as the
    logits at every position: zero attention and MLP outputs, a final
    norm of weight 0 ... except for a constant feature, and an lm-head
    that maps it to log p."""
    from dstack_tpu_torch.workloads.transformer import init_params

    params = init_params(cfg, 0, device="cpu")
    d = cfg.d_model
    params["embed"] = torch.ones_like(params["embed"])
    for key in ("wo", "w_down"):
        params["layers"][key] = torch.zeros_like(params["layers"][key])
    params["final_norm"] = torch.ones_like(params["final_norm"])
    head = torch.zeros_like(params["lm_head"])
    head[:] = logp[None, :] / d  # rms_norm of an all-ones row is ones
    params["lm_head"] = head
    return params


def test_full_acceptance_leaves_the_drafter_rows_of_the_new_length(weights):
    """Step k of the draft writes d_k's KV at lengths + k: after a round
    that accepts all k drafts, the drafter's pool holds every row the
    target's does up to the new length (the target drafting for itself,
    so the rows are the same numbers), and the next round's drafts are
    again all accepted."""
    _, tp = weights
    k = 3
    _, ts, pools = _state(shared_pools=True)
    ds = _draft_state(pools)
    for rnd in range(2):
        before = ts.lengths.clone()
        d, q = tkv.make_spec_draft(TCFG, k)(
            tp, ds, ts.block_tables, ts.lengths, ts.last_token, ts.active,
            ts.temperature, ts.top_p, None, sampling=False, nucleus=False)
        _, em, acc, _ = tkv.make_spec_verify(TCFG, k)(tp, ts, d, q, None,
                                                      sampling=False, nucleus=False)
        assert acc.tolist()[0] == k, rnd
        # Slot 0's rows lengths .. lengths + k in both pools.
        pos = torch.arange(int(before[0]), int(ts.lengths[0]))
        blk = ts.block_tables[0, pos // BS].long()
        for t, dpool in ((ts.k, ds.k), (ts.v, ds.v)):
            np.testing.assert_allclose(dpool[:, blk, pos % BS].numpy(),
                                       t[:, blk, pos % BS].numpy(), atol=1e-5, rtol=0)
    assert int(ts.lengths[0]) == 13 + 2 * (k + 1)


# -- the engine (tests/test_serving_spec.py, one for one) ---------------------------


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


def _spec_engine(tp, drafter, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("prefill_chunk_tokens", 16)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("spec_max_draft", 3)
    return tsrv.ServingEngine(TCFG, tp, device="cpu", spec_enable=True,
                              spec_draft_params=drafter, spec_draft_config=TCFG, **kw)


def test_spec_temp0_token_exact_at_awkward_lengths(weights):
    jp, tp = weights
    engine = _spec_engine(tp, tp)
    try:
        engine.warmup()
        for seed, n in ((1, 5), (3, 33)):
            p = _prompt(seed, n)
            assert _drain(engine.submit(p, max_new_tokens=8)) == _reference(jp, p, 8), n
        st = engine.stats()
        assert st["spec_rounds_total"] > 0 and st["spec_tokens_accepted_total"] > 0
        assert st["attn_dispatch_plain_total"] > 0
    finally:
        engine.close()


def test_spec_temp0_token_exact_under_adversarial_drafter(weights, bad_drafter):
    jp, tp = weights
    engine = _spec_engine(tp, bad_drafter[1])
    try:
        p = _prompt(5, 21)
        assert _drain(engine.submit(p, max_new_tokens=10)) == _reference(jp, p, 10)
        st = engine.stats()
        assert st["spec_rounds_total"] > 0 and st["spec_tokens_rejected_total"] > 0
    finally:
        engine.close()


def test_spec_rollback_keeps_shared_prefix_blocks_intact(weights, bad_drafter):
    """A rejection-heavy run whose decode tail extends into the prompt's
    cached (shared) last block, then the same prompt again: it must still
    prefix-hit and still match the reference."""
    jp, tp = weights
    engine = _spec_engine(tp, bad_drafter[1])
    try:
        p = _prompt(6, 20)  # 2.5 blocks: rows 20.. land in the shared tail
        ref = _reference(jp, p, 10)
        assert _drain(engine.submit(p, max_new_tokens=10)) == ref
        st0 = engine.stats()
        assert st0["spec_tokens_rejected_total"] > 0
        assert _drain(engine.submit(p, max_new_tokens=10)) == ref
        st1 = engine.stats()
        assert st1["prefix_cache_hits_total"] > st0["prefix_cache_hits_total"]
        assert st1["prefix_tokens_reused_total"] > st0["prefix_tokens_reused_total"]
    finally:
        engine.close()


def test_spec_cancel_mid_round_leaks_zero_blocks(weights):
    jp, tp = weights
    engine = _spec_engine(tp, tp, prefix_cache=False)
    try:
        round_started, release = threading.Event(), threading.Event()
        real = engine._spec_verify_fn

        def gated(k):
            fn = real(k)

            def wrapped(*args, **kw):
                round_started.set()
                assert release.wait(30)
                return fn(*args, **kw)

            return wrapped

        engine._spec_verify_fn = gated
        p0 = _prompt(8, 11)
        q = engine.submit(p0, max_new_tokens=24)
        assert round_started.wait(60)
        engine.cancel(q)  # lands while the verify is gated
        release.set()
        got = _drain(q)
        assert len(got) < 24 and got == _reference(jp, p0, 24)[:len(got)]
        engine._spec_verify_fn = real
        assert engine.stats()["kv_blocks_in_use"] == 0
        p = _prompt(9, 9)
        assert _drain(engine.submit(p, max_new_tokens=6)) == _reference(jp, p, 6)
        assert engine.stats()["kv_blocks_in_use"] == 0
    finally:
        engine.close()


def test_spec_draft_length_adapts_up_on_full_acceptance(weights):
    """The target drafting for itself: every round accepts all k, so k
    climbs to spec_max_draft, and no round ever rejects — which also
    shows each fully accepted round left the drafter the rows of the new
    length (a drafter short of d_k's row would miss in the next round)."""
    jp, tp = weights
    engine = _spec_engine(tp, tp, slots=1)
    try:
        p = _prompt(10, 9)
        assert _drain(engine.submit(p, max_new_tokens=24)) == _reference(jp, p, 24)
        st = engine.stats()
        assert st["spec_accept_rate_ewma"] > 0.9
        assert st["spec_draft_len_mean"] == engine._spec_max_draft
        assert st["spec_fallback_rounds_total"] == 0
        assert st["spec_rounds_total"] >= 3 and st["spec_tokens_rejected_total"] == 0
        assert st["spec_tokens_accepted_total"] == st["spec_tokens_proposed_total"]
    finally:
        engine.close()


def test_spec_adapts_down_and_falls_back_on_low_acceptance(weights, bad_drafter):
    jp, tp = weights
    engine = _spec_engine(tp, bad_drafter[1], slots=1)
    try:
        p = _prompt(11, 9)
        assert _drain(engine.submit(p, max_new_tokens=24)) == _reference(jp, p, 24)
        st = engine.stats()
        assert st["spec_accept_rate_ewma"] < 0.3
        assert st["spec_draft_len_mean"] == 1.0
        assert st["spec_fallback_rounds_total"] > 0
    finally:
        engine.close()


def test_spec_ctor_validation(weights):
    _, tp = weights
    kw = dict(device="cpu", slots=2, max_len=96, kv_block_size=8)
    with pytest.raises(ValueError, match="spec_max_draft"):
        tsrv.ServingEngine(TCFG, tp, spec_enable=True, spec_max_draft=0, **kw)
    # One pool's bytes: layers x (slots x max_len / block) blocks x block
    # rows x k and v of every KV head.
    one_pool = (TCFG.n_layers * 2 * (96 // 8) * 8 * 2 * TCFG.n_kv_heads * TCFG.head_dim
                * TCFG.dtype_bytes)
    tsrv.ServingEngine(TCFG, tp, kv_budget_bytes=one_pool, **kw).close()
    with pytest.raises(ValueError, match="cannot fit the KV pool"):
        tsrv.ServingEngine(TCFG, tp, kv_budget_bytes=one_pool - 1, **kw)
    with pytest.raises(ValueError, match="drafter KV pool"):
        tsrv.ServingEngine(TCFG, tp, spec_enable=True, spec_draft_params=tp,
                           spec_draft_config=TCFG, kv_budget_bytes=int(one_pool * 1.5),
                           **kw)
    tsrv.ServingEngine(TCFG, tp, kv_budget_bytes=int(one_pool * 1.5), **kw).close()


def test_spec_window_is_made_private_in_both_pools(weights):
    """`_ensure_spec_writable`: a window block still shared (here with the
    prefix cache's hold) is swapped for a private copy before any draft or
    verify write, in the target's pool and the drafter's alike, and the
    device table row follows. Driven on a stopped engine's state."""
    _, tp = weights
    engine = _spec_engine(tp, tp)
    engine.close()
    a = engine._alloc
    b0, b1 = a.alloc(), a.alloc()
    a.retain(b1)  # a second holder: the window's block is shared
    engine._live[0] = object()
    engine._slot_tables[0] = [b0, b1]
    engine._lengths_host[0] = 12  # window rows 12 .. 15 sit in block b1
    for pool in (engine.state.k, engine.state.v, engine._draft_state.k,
                 engine._draft_state.v):
        pool.normal_()
    before = [p[:, b1].clone() for p in (engine.state.k, engine._draft_state.k)]
    engine._ensure_spec_writable(3)
    new = engine._slot_tables[0][1]
    assert new not in (b0, b1) and a.cow_copies == 1 and a._ref[b1] == 1
    assert engine.state.block_tables[0, :2].tolist() == [b0, new]
    assert torch.equal(engine.state.k[:, new], before[0])
    assert torch.equal(engine._draft_state.k[:, new], before[1])
    assert torch.equal(engine._draft_state.v[:, new], engine._draft_state.v[:, b1])
