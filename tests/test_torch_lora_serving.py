"""Multi-tenant LoRA serving in the PyTorch port against the JAX package
(tiny, f32, bridged weights and adapters, on the CPU): the adapter
registry in step with the JAX registry (slots, refs, LRU, busy and full,
shape checks, the bank's contents), adapter npz files across packages,
`project_qkv_lora`, the LoRA chunk-prefill, decode and verify programs on
one state, and the engine cases of tests/test_lora_serving.py, whose
mixed-adapter streams are held against the JAX batched LoRA engine token
for token at temperature 0; then the port's own cases: slot reuse after an
adapter retires, an adapter slot preempted and resumed through the host
tier, cancel and close while swapped out, and no cross-tenant prefix hit
from the device or the host tier. Every engine case ends with no adapter
ref held (`inflight == 0`).

Tolerances: `project_qkv_lora` within 1e-5 of max |y| (the same f32 sums
in another order); program pool rows within 1e-6 of the pool's max
|value| (as tests/test_torch_spec.py: rows of tiny's last layer carry four
layers of reordering); every token, count, length and `adapter_ix` equal.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import kv_blocks as jkv
from dstack_tpu.workloads import lora_serving as jls
from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.generate import generate as jgenerate
from dstack_tpu_torch.workloads import kv_blocks as tkv
from dstack_tpu_torch.workloads import lora_serving as tls
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads import transformer as ttr
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import lora_from_numpy, params_from_numpy

JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")
RANK = 4
TARGETS = ("wq", "wv")
CPU = torch.device("cpu")
ENGINE_KW = dict(slots=4, max_len=96, prefill_chunk_tokens=16, kv_block_size=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jp = jtr.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(_np_tree(jp), "cpu")


@pytest.fixture(scope="module")
def adapters(weights):
    """JAX demo adapters t1..t3 and their bridged copies."""
    jp, _ = weights
    out = {}
    for name, seed in (("t1", 11), ("t2", 22), ("t3", 33)):
        ja = jls.demo_adapter(JCFG, jp, jax.random.PRNGKey(seed), rank=RANK,
                              targets=TARGETS)
        out[name] = (ja, lora_from_numpy(_np_tree(ja), "cpu"))
    return out


def _drain(q, timeout=120):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return out
        out.append(tok)


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


_REF = {}


def _reference(jp, prompt, n):
    key = (None, tuple(prompt), n)
    if key not in _REF:
        toks = jgenerate(JCFG, jp, jnp.asarray([prompt], jnp.int32), max_new_tokens=n,
                         temperature=0.0)
        _REF[key] = [int(t) for t in toks[0]]
    return _REF[key]


@pytest.fixture(scope="module")
def jengine(weights, adapters):
    """The JAX batched LoRA engine, t1..t3 loaded (one per module)."""
    jp, _ = weights
    eng = jsrv.ServingEngine(JCFG, jp, lora_max_adapters=3, lora_rank=RANK,
                             lora_targets=TARGETS, **ENGINE_KW)
    for name, (ja, _) in adapters.items():
        eng.load_adapter(name, ja)
    yield eng
    eng.close()


def _jax_streams(jengine, reqs):
    """(prompt, n, adapter) requests submitted together to the JAX LoRA
    engine; memoized per request."""
    todo = [r for r in reqs if ("jax",) + r not in _REF]
    qs = [jengine.submit(list(p), max_new_tokens=n, temperature=0.0, adapter=a)
          for p, n, a in todo]
    for r, q in zip(todo, qs):
        _REF[("jax",) + r] = _drain(q)
    return [_REF[("jax",) + r] for r in reqs]


def _engine(tp, **kw):
    kw = {**ENGINE_KW, **kw}
    kw.setdefault("lora_max_adapters", 2)
    kw.setdefault("lora_rank", RANK)
    kw.setdefault("lora_targets", TARGETS)
    return tsrv.ServingEngine(TCFG, tp, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(weights):
    _, tp = weights
    eng = _engine(tp)
    yield eng
    eng.close()


def _unload_all(engine):
    for name in list(engine.adapters()):
        engine.unload_adapter(name)


def _no_refs(engine):
    assert engine._lora.inflight == 0
    assert not engine._adapter_holds


# -- the registry, in step with the JAX registry -------------------------------------


class _Both:
    """One JAX registry and one port registry driven by the same calls:
    answers (or exception types), loaded() and the bank must agree."""

    def __init__(self, weights, max_adapters=2):
        jp, tp = weights
        self.j = jls.AdapterRegistry(JCFG, jp, max_adapters=max_adapters, rank=RANK,
                                     targets=TARGETS)
        self.t = tls.AdapterRegistry(TCFG, tp, max_adapters=max_adapters, rank=RANK,
                                     targets=TARGETS)

    def call(self, name, *args, **kw):
        res = []
        for reg, side in ((self.j, 0), (self.t, 1)):
            a = [x[side] if isinstance(x, tuple) else x for x in args]
            try:
                res.append(("ok", getattr(reg, name)(*a, **kw)))
            except Exception as e:  # both must raise the same kind
                res.append(("raise", type(e).__name__))
        assert res[0] == res[1], (name, res)
        assert self.j.loaded() == self.t.loaded()
        assert (self.j.loaded_count, self.j.inflight) == (self.t.loaded_count,
                                                          self.t.inflight)
        for key, leaf in self.t.bank["layers"].items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(self.j.bank["layers"][key]))
        np.testing.assert_array_equal(self.t.bank["scale"].numpy(),
                                      np.asarray(self.j.bank["scale"]))
        return res[0]


def test_registry_load_acquire_release_in_step(weights, adapters):
    b = _Both(weights)
    s1 = b.call("load", "a", adapters["t1"], alpha=8.0)[1]
    assert b.call("slot_of", "a") == ("ok", s1)
    assert b.call("acquire", "a") == ("ok", s1)
    assert b.t.loaded()["a"] == {"slot": s1, "refs": 1, "alpha": 8.0, "rank": RANK}
    b.call("release", "a")
    assert b.call("acquire", "nope") == ("raise", "KeyError")


def test_registry_lru_evicts_idle_not_inflight_in_step(weights, adapters):
    b = _Both(weights)
    b.call("load", "t1", adapters["t1"])
    b.call("load", "t2", adapters["t2"])
    b.call("acquire", "t1")
    b.call("release", "t1")
    b.call("load", "t3", adapters["t3"])  # t2 is idle and coldest: evicted
    assert set(b.t.loaded()) == {"t1", "t3"}
    b.call("acquire", "t1")
    b.call("acquire", "t3")
    assert b.call("load", "t2", adapters["t2"]) == ("raise", "AdapterPoolFullError")
    b.call("release", "t3")
    b.call("load", "t2", adapters["t2"])
    assert set(b.t.loaded()) == {"t1", "t2"}


def test_registry_busy_refuses_reload_and_unload_in_step(weights, adapters):
    b = _Both(weights)
    b.call("load", "t1", adapters["t1"])
    b.call("acquire", "t1")
    assert b.call("load", "t1", adapters["t2"]) == ("raise", "AdapterBusyError")
    assert b.call("unload", "t1") == ("raise", "AdapterBusyError")
    b.call("release", "t1")
    b.call("unload", "t1")  # the slot's bank rows and scale zeroed in both
    assert b.t.loaded_count == 0
    assert b.call("unload", "t1") == ("raise", "KeyError")


def test_registry_validates_adapter_shape_in_step(weights, adapters):
    jp, tp = weights
    b = _Both(weights, max_adapters=1)
    assert b.call("load", "bad", {}) == ("raise", "ValueError")
    for kw in ({"rank": RANK + 1, "targets": TARGETS}, {"rank": RANK, "targets": ("wq",)}):
        ja = jls.demo_adapter(JCFG, jp, jax.random.PRNGKey(5), **kw)
        assert b.call("load", "bad", (ja, lora_from_numpy(_np_tree(ja), "cpu"))) \
            == ("raise", "ValueError")
    with pytest.raises(ValueError, match="rank"):
        b.t.load("bad", lora_from_numpy(_np_tree(jls.demo_adapter(
            JCFG, jp, jax.random.PRNGKey(5), rank=RANK + 1, targets=TARGETS)), "cpu"))
    with pytest.raises(ValueError, match="unsupported"):
        tls.make_lora_bank(TCFG, tp, max_adapters=1, rank=RANK, targets=("w_up",))


# -- adapter files across packages -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adapter_files_load_in_both_packages(tmp_path, weights, adapters, dtype):
    ja = adapters["t1"][0]
    ja = {"layers": {k: v.astype(dtype) for k, v in ja["layers"].items()}}
    ta = lora_from_numpy(_np_tree(ja), "cpu")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jls.save_adapter(jpath, ja, rank=RANK, alpha=12.0)
    tls.save_adapter(tpath, ta, rank=RANK, alpha=12.0)
    from_jax, rank, alpha = tls.load_adapter_file(jpath)
    assert (rank, alpha) == (RANK, 12.0)
    from_port, rank2, alpha2 = jls.load_adapter_file(tpath)
    assert (rank2, alpha2) == (RANK, 12.0)
    for key, leaf in ja["layers"].items():
        want = np.asarray(leaf, np.float32)
        np.testing.assert_array_equal(from_jax["layers"][key].numpy(), want)
        np.testing.assert_array_equal(np.asarray(from_port["layers"][key]), want)
    with np.load(tpath) as z, np.load(jpath) as zj:
        assert sorted(z.files) == sorted(zj.files)


def test_demo_adapter_is_seeded_and_nonzero(weights):
    _, tp = weights
    a, b = (tls.demo_adapter(TCFG, tp, 7, rank=RANK) for _ in range(2))
    for k in a["layers"]:
        assert torch.equal(a["layers"][k], b["layers"][k]) and a["layers"][k].any()


# -- project_qkv_lora ------------------------------------------------------------------


def _banks(weights, adapters):
    """JAX and port registries with t1 and t2 loaded (alphas 16 and 8)."""
    b = _Both(weights, max_adapters=3)
    b.call("load", "t1", adapters["t1"])
    b.call("load", "t2", adapters["t2"], alpha=8.0)
    return b.j, b.t


@pytest.mark.parametrize("chunk", [False, True])
def test_project_qkv_lora_matches_jax(weights, adapters, chunk):
    jp, tp = weights
    jreg, treg = _banks(weights, adapters)
    rng = np.random.default_rng(3)
    s = 5 if chunk else 1
    b = 1 if chunk else 5
    x = rng.standard_normal((b, s, TCFG.d_model)).astype(np.float32)
    pos = np.arange(7, 7 + s)
    slot = treg.slot_of("t2")
    aix = slot if chunk else np.array([treg.slot_of("t1"), -1, slot, -1, treg.slot_of("t1")])
    for layer in (0, TCFG.n_layers - 1):
        jpl = {k: v[layer] for k, v in jp["layers"].items()}
        tpl = ttr.layer_params(tp, layer)
        jlp = {k: v[layer] for k, v in jreg.bank["layers"].items()}
        pool = jreg.bank["scale"].shape[0] - 1
        jsafe = jnp.where(jnp.asarray(aix) >= 0, jnp.asarray(aix), pool).astype(jnp.int32)
        jq = jls.project_qkv_lora(JCFG, jnp.asarray(x), jpl, jnp.asarray(pos), jlp, jsafe,
                                  jreg.bank["scale"][jsafe], jnp.asarray(True))
        tix = int(aix) if chunk else torch.from_numpy(aix.astype(np.int32))
        ix, scale = tls.safe_index(treg.bank, tix)
        tq = tls.project_qkv_lora(TCFG, torch.from_numpy(x), tpl, torch.from_numpy(pos),
                                  tls.bank_layer(treg.bank, layer), ix, scale, True)
        plain = ttr.project_qkv(TCFG, torch.from_numpy(x), tpl, torch.from_numpy(pos))
        for got, want, base in zip(tq, jq, plain):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            if not chunk:  # rows without an adapter are the plain projection
                assert torch.equal(got[[1, 3]], base[[1, 3]])
        # wq and wv moved, wk did not; has_lora False is project_qkv itself.
        assert not torch.equal(tq[0], plain[0]) and torch.equal(tq[1], plain[1])
        off = tls.project_qkv_lora(TCFG, torch.from_numpy(x), tpl, torch.from_numpy(pos),
                                   tls.bank_layer(treg.bank, layer), ix, scale, False)
        for got, base in zip(off, plain):
            assert torch.equal(got, base)


# -- the LoRA programs on one state ------------------------------------------------------

NB, BS, ML, B = 24, 8, 64, 3


def _state(aix, seed=0):
    """Random pools, scattered tables, per-slot scalars and adapter_ix, as
    JAX and port states; slot 2 is inactive with a stale table."""
    rng = np.random.default_rng(seed)
    shape = (TCFG.n_layers, NB, BS, TCFG.n_kv_heads, TCFG.head_dim)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    perm = rng.permutation(NB).tolist()
    tables = np.full((B, ML // BS), NB, np.int32)
    tables[0, :4] = perm[:4]
    tables[1, :6] = perm[4:10]
    tables[2, :3] = perm[12:15]
    scal = dict(lengths=np.array([13, 40, 9], np.int32),
                last_token=np.array([5, 17, 40], np.int32),
                active=np.array([True, True, False]),
                remaining=np.array([20, 9, 0], np.int32),
                temperature=np.zeros(B, np.float32),
                top_p=np.ones(B, np.float32),
                adapter_ix=np.asarray(aix, np.int32))
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
    return js, ts


def _rows_close(ts, js):
    for t, j in ((ts.k, js.k), (ts.v, js.v)):
        want = np.asarray(j)
        np.testing.assert_allclose(t[:, :NB].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _fields(st):
    return {f: np.asarray(getattr(st, f)).tolist()
            for f in ("lengths", "last_token", "active", "remaining", "adapter_ix")}


@pytest.mark.parametrize("adapter", ["t1", None])
def test_lora_chunk_prefill_matches_jax(weights, adapters, adapter):
    jp, tp = weights
    jreg, treg = _banks(weights, adapters)
    aix = -1 if adapter is None else treg.slot_of(adapter)
    js, ts = _state([2, -1, 0])
    prompt = _prompt(4, 21)
    row = [19, 1, 7] + [NB] * (ML // BS - 3)
    pos = 0
    for i, n in enumerate((16, 5)):
        c = 16 if n > 8 else 8
        final = i == 1
        toks = prompt[pos:pos + n] + [0] * (c - n)
        js, jf = jkv.make_chunk_prefill(JCFG, c, lora=True)(
            jp, js, jnp.int32(2), jnp.asarray(row, jnp.int32), jnp.asarray([toks], jnp.int32),
            jnp.int32(n), jnp.int32(pos), jnp.int32(6), jnp.float32(0.0), jnp.float32(1.0),
            jax.random.PRNGKey(0), jnp.asarray(final), jnp.int32(aix), jreg.bank)
        ts, tf, _ = tkv.make_chunk_prefill(TCFG, c, lora=True)(
            tp, ts, 2, row, toks, n, pos, 6, 0.0, 1.0, None, final, aix, treg.bank)
        pos += n
    assert int(tf) == int(jf)
    _rows_close(ts, js)
    assert _fields(ts) == _fields(js)
    assert ts.adapter_ix.tolist()[2] == aix


def test_lora_decode_step_matches_jax(weights, adapters):
    jp, tp = weights
    jreg, treg = _banks(weights, adapters)
    js, ts = _state([treg.slot_of("t2"), treg.slot_of("t1"), -1])
    jstep = jkv.make_paged_decode_step(JCFG, steps=3, lora=True)
    tstep = tkv.make_paged_decode_step(TCFG, steps=3, lora=True)
    for _ in range(2):
        js, jt, ja = jstep(jp, js, jax.random.PRNGKey(1), jreg.bank)
        ts, tt, ta = tstep(tp, ts, None, treg.bank, sampling=False, nucleus=False,
                           has_lora=True)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert ta.tolist() == np.asarray(ja).tolist()
    _rows_close(ts, js)
    assert _fields(ts) == _fields(js)
    # The adapters change the tokens: the plain program on the same state
    # disagrees.
    _, ts2 = _state([treg.slot_of("t2"), treg.slot_of("t1"), -1])
    _, pt, _ = tkv.make_paged_decode_step(TCFG, steps=3)(tp, ts2, None, sampling=False,
                                                          nucleus=False)
    _, ts3 = _state([treg.slot_of("t2"), treg.slot_of("t1"), -1])
    _, lt, _ = tstep(tp, ts3, None, treg.bank, sampling=False, nucleus=False)
    assert pt.tolist() != lt.tolist()


def test_lora_verify_k2_matches_jax(weights, adapters):
    jp, tp = weights
    jreg, treg = _banks(weights, adapters)
    js, ts = _state([treg.slot_of("t1"), -1, treg.slot_of("t2")])
    k = 2
    rng = np.random.default_rng(5)
    drafts = rng.integers(1, 100, (B, k)).astype(np.int32)
    qlogits = rng.standard_normal((B, k, TCFG.vocab_size)).astype(np.float32)
    # Draft the target's own greedy first token for slot 0 so a draft is
    # accepted there.
    js2, je, ja, jact = jkv.make_spec_verify(JCFG, k, lora=True)(
        jp, js, jnp.asarray(drafts), jnp.asarray(qlogits), jax.random.PRNGKey(4), jreg.bank)
    drafts[:, 0] = np.asarray(je)[:, 0] if np.asarray(ja)[0] == 0 else drafts[:, 0]
    js, ts = _state([treg.slot_of("t1"), -1, treg.slot_of("t2")])
    js2, je, ja, jact = jkv.make_spec_verify(JCFG, k, lora=True)(
        jp, js, jnp.asarray(drafts), jnp.asarray(qlogits), jax.random.PRNGKey(4), jreg.bank)
    ts2, te, ta, tact = tkv.make_spec_verify(TCFG, k, lora=True)(
        tp, ts, torch.from_numpy(drafts), torch.from_numpy(qlogits), None, treg.bank,
        sampling=False, nucleus=False)
    assert te.tolist() == np.asarray(je).tolist()
    assert ta.tolist() == np.asarray(ja).tolist() and ta.tolist()[0] >= 1
    assert tact.tolist() == np.asarray(jact).tolist()
    _rows_close(ts2, js2)
    assert _fields(ts2) == _fields(js2)


# -- the engine cases of tests/test_lora_serving.py --------------------------------------


def test_lora_engine_without_adapters_matches_plain(weights, engine):
    jp, _ = weights
    _unload_all(engine)
    for seed, n in ((4, 5), (5, 33)):
        p = _prompt(seed, n)
        assert _drain(engine.submit(p, max_new_tokens=8)) == _reference(jp, p, 8), n
    _no_refs(engine)


def test_mixed_adapter_batch_matches_the_jax_lora_engine(weights, adapters, engine,
                                                         jengine):
    """Three tenants in one batch (t1, t2, none): each stream equals the
    JAX batched LoRA engine's token for token; prompts of 27 straddle the
    chunk (16) and block (8) boundaries."""
    jp, _ = weights
    _unload_all(engine)
    engine.load_adapter("t1", adapters["t1"][1])
    engine.load_adapter("t2", adapters["t2"][1])
    reqs = [(tuple(_prompt(1, 27)), 8, "t1"), (tuple(_prompt(2, 27)), 8, "t2"),
            (tuple(_prompt(3, 27)), 8, None)]
    qs = [engine.submit(list(p), max_new_tokens=n, adapter=a) for p, n, a in reqs]
    got = [_drain(q) for q in qs]
    assert got == _jax_streams(jengine, reqs)
    assert got[2] == _reference(jp, _prompt(3, 27), 8)
    # Same prompt, another tenant: other tokens (B != 0 in demo_adapter).
    assert _drain(engine.submit(_prompt(3, 27), max_new_tokens=8, adapter="t1")) != got[2]
    st = engine.stats()
    assert st["lora_enabled"] is True and st["adapters_loaded"] == 2
    assert st["lora_max_adapters"] == 2
    _no_refs(engine)


def test_spec_round_with_adapter_matches_the_jax_lora_engine(weights, adapters, jengine):
    """Speculation on a LoRA engine: the drafter (the target's own weights)
    never applies the adapter, the verify does; t1 and base streams equal
    the JAX engine's."""
    jp, tp = weights
    eng = _engine(tp, slots=2, spec_enable=True, spec_draft_params=tp,
                  spec_draft_config=TCFG, spec_max_draft=2)
    try:
        eng.load_adapter("t1", adapters["t1"][1])
        reqs = [(tuple(_prompt(1, 27)), 8, "t1"), (tuple(_prompt(3, 27)), 8, None)]
        qs = [eng.submit(list(p), max_new_tokens=n, adapter=a) for p, n, a in reqs]
        assert [_drain(q) for q in qs] == _jax_streams(jengine, reqs)
        assert eng.stats()["spec_rounds_total"] > 0
        _no_refs(eng)
    finally:
        eng.close()


def test_engine_prefix_cache_keyed_by_adapter(weights, adapters, engine, jengine):
    jp, _ = weights
    _unload_all(engine)
    engine.load_adapter("t1", adapters["t1"][1])
    engine.load_adapter("t2", adapters["t2"][1])
    p = tuple(_prompt(12, 27))
    for adapter in ("t1", "t2", None, "t1"):
        got = _drain(engine.submit(list(p), max_new_tokens=8, adapter=adapter))
        assert got == _jax_streams(jengine, [(p, 8, adapter)])[0], adapter
    assert engine._alloc.hits > 0  # the second t1 run hit its own blocks
    _no_refs(engine)


def test_engine_inflight_adapter_pins_unload(weights, adapters, engine):
    _unload_all(engine)
    engine.load_adapter("t1", adapters["t1"][1])
    q = engine.submit(_prompt(9, 12), max_new_tokens=48, adapter="t1")
    with pytest.raises(tls.AdapterBusyError):
        engine.unload_adapter("t1")
    _drain(q)  # the stream ends: the ref is released
    engine.unload_adapter("t1")
    assert "t1" not in engine.adapters()
    _no_refs(engine)


def test_engine_submit_unknown_adapter_raises(weights, engine):
    _, tp = weights
    with pytest.raises(KeyError):
        engine.submit(_prompt(1, 8), max_new_tokens=4, adapter="ghost")
    assert engine.stats()["pending"] == 0
    plain = tsrv.ServingEngine(TCFG, tp, device="cpu", **ENGINE_KW)
    try:
        with pytest.raises(ValueError, match="lora_max_adapters"):
            plain.submit(_prompt(1, 8), max_new_tokens=4, adapter="t1")
        with pytest.raises(RuntimeError, match="no adapter support"):
            plain.load_adapter("t1", {})
        assert plain.stats()["lora_enabled"] is False and plain.adapters() == {}
    finally:
        plain.close()
    with pytest.raises(ValueError, match="role='unified'"):
        _engine(tp, role="prefill")
    _no_refs(engine)


def test_adapters_loaded_gauge_exported(weights, adapters, engine):
    from dstack_tpu.server.metrics_registry import METRICS

    _unload_all(engine)
    engine.load_adapter("t1", adapters["t1"][1])
    text = tsrv.prometheus_metrics(engine.stats())
    assert "dstack_tpu_serving_adapters_loaded 1" in text
    assert METRICS["dstack_tpu_serving_adapters_loaded"][0] == "gauge"
    assert 'tenant="' not in text


# -- the port's added cases ---------------------------------------------------------------


def test_slot_reuse_after_an_adapter_retires_serves_the_base(weights, adapters):
    """One slot: a t1 request retires, a base request takes the slot
    through the plain chunk program, and a second t1 request keeps t1 in
    flight so the decode steps run the LoRA program: the base stream must
    not carry t1's delta (retire resets adapter_ix)."""
    jp, tp = weights
    eng = _engine(tp, slots=2)
    try:
        eng.load_adapter("t1", adapters["t1"][1])
        _drain(eng.submit(_prompt(1, 10), max_new_tokens=4, adapter="t1"))
        assert eng.state.adapter_ix.tolist() == [-1, -1]
        q_base = eng.submit(_prompt(3, 10), max_new_tokens=12)
        q_t1 = eng.submit(_prompt(2, 10), max_new_tokens=12, adapter="t1")
        assert _drain(q_base) == _reference(jp, _prompt(3, 10), 12)
        _drain(q_t1)
        _no_refs(eng)
        assert eng.state.adapter_ix.tolist() == [-1, -1]
    finally:
        eng.close()


def _tier_engine(tp, **kw):
    return _engine(tp, slots=2, kv_host_budget_bytes=32 << 20, **kw)


def test_adapter_slot_preempted_and_resumed_keeps_its_ref(weights, adapters, jengine):
    _, tp = weights
    eng = _tier_engine(tp)
    try:
        eng.load_adapter("t1", adapters["t1"][1])
        p = tuple(_prompt(11, 20))
        want = _jax_streams(jengine, [(p, 24, "t1")])[0]
        out = eng.submit(list(p), max_new_tokens=24, temperature=0.0, adapter="t1")
        got = [out.get(timeout=60) for _ in range(4)]
        eng.preempt(out)
        t0 = time.monotonic()
        while eng.stats()["slot_preemptions_total"] == 0:
            assert time.monotonic() - t0 < 30
            time.sleep(0.001)
        got += _drain(out)
        assert got == want
        st = eng.stats()
        assert st["slot_preemptions_total"] == 1 and st["slot_swap_ins_total"] == 1
        _no_refs(eng)
    finally:
        eng.close()


def _park(eng, adapter):
    """A request on `adapter` swapped out and held parked: the tier engine's
    readmission is gated until the caller releases it."""
    release = threading.Event()
    real = eng._readmit_swapped

    def gated():
        return real() if release.is_set() else False

    eng._readmit_swapped = gated
    out = eng.submit(_prompt(13, 20), max_new_tokens=40, temperature=0.0, adapter=adapter)
    out.get(timeout=60)
    eng.preempt(out)
    t0 = time.monotonic()
    while not eng._swapped:
        assert time.monotonic() - t0 < 30
        time.sleep(0.001)
    return out, release


def test_cancel_while_swapped_releases_the_adapter(weights, adapters):
    _, tp = weights
    eng = _tier_engine(tp)
    try:
        eng.load_adapter("t1", adapters["t1"][1])
        out, release = _park(eng, "t1")
        with pytest.raises(tls.AdapterBusyError):  # parked, still holding t1
            eng.unload_adapter("t1")
        eng.cancel(out)
        while out.get(timeout=60) is not None:
            pass
        release.set()
        _no_refs(eng)
        assert eng.stats()["slots_swapped"] == 0 and eng._host_tier.pinned_bytes == 0
        eng.unload_adapter("t1")
    finally:
        eng.close()


def test_close_while_swapped_releases_the_adapter(weights, adapters):
    _, tp = weights
    eng = _tier_engine(tp)
    eng.load_adapter("t1", adapters["t1"][1])
    out, _ = _park(eng, "t1")
    eng.close()
    tail = []
    while True:
        tok = out.get(timeout=60)
        tail.append(tok)
        if tok is None or isinstance(tok, BaseException):
            break
    assert isinstance(tail[-1], RuntimeError)
    _no_refs(eng)
    assert eng._host_tier.pinned_bytes == 0


def test_no_cross_tenant_host_hit(weights, adapters, jengine):
    """A prompt's blocks spilled to the host tier under t1 are never handed
    to t2 (or the base): their chains are keyed by the adapter's name. The
    t2 request misses device and host alike and matches its reference;
    t1 again gets a host hit."""
    _, tp = weights
    eng = _engine(tp, slots=2, max_len=64, kv_pool_blocks=16, kv_host_budget_bytes=32 << 20)
    try:
        eng.load_adapter("t1", adapters["t1"][1])
        eng.load_adapter("t2", adapters["t2"][1])
        p0 = tuple(_prompt(1, 24))
        want = {a: _jax_streams(jengine, [(p0, 8, a)])[0] for a in ("t1", "t2")}
        assert _drain(eng.submit(list(p0), max_new_tokens=8, adapter="t1")) == want["t1"]
        for s in range(2, 10):  # 8 other prompts through a 16-block pool
            _drain(eng.submit(_prompt(s, 24), max_new_tokens=8))
        st = eng.stats()
        assert st["kv_spills_total"] > 0, st
        hits = st["prefix_cache_hits_total"]
        assert _drain(eng.submit(list(p0), max_new_tokens=8, adapter="t2")) == want["t2"]
        st = eng.stats()
        assert st["prefix_cache_hits_total"] == hits and st["prefix_cache_host_hits_total"] == 0
        assert _drain(eng.submit(list(p0), max_new_tokens=8, adapter="t1")) == want["t1"]
        assert eng.stats()["prefix_cache_host_hits_total"] >= 1
        _no_refs(eng)
    finally:
        eng.close()
