"""Paged KV cache of the PyTorch port against the JAX package: the
allocator (pure Python, so identical ids, keys and counters), the chunk
prefill and paged decode programs on the same state (tiny, f32: pools to
1e-5, tokens identical), masked writes, and the dense reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import kv_blocks as jkv
from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import kv_blocks as tkv
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import params_from_numpy

JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


# -- allocator ----------------------------------------------------------------


def _allocator_script(a):
    """One sequence of allocator operations; returns what it observed."""
    seen = []
    p1 = _prompt(1, 21)
    t1 = [a.alloc() for _ in range(3)]
    a.insert_full(p1, t1)
    a.insert_tail(p1, t1)
    seen.append(("t1", t1, sorted(a._cache.items())))
    blocks, n = a.match(p1[:20] + [7])
    seen.append(("match", blocks, n))
    seen.append(("cow", [a.ensure_writable(b) for b in blocks]))
    for b in t1:
        a.release(b)
    ns_blocks, ns_n = a.match(p1, namespace=b"tenant-b")
    seen.append(("ns", ns_blocks, ns_n))
    a.insert_full(p1, t1[:2], namespace=b"tenant-b")
    seen.append(("ns2", a.match(p1, namespace=b"tenant-b")))
    hog = [a.alloc() for _ in range(a.num_blocks)]  # forces LRU evictions
    seen.append(("hog", hog))
    for b in hog:
        if b is not None:
            a.release(b)
    seen.append(("cache_after", sorted(a._cache.items())))
    seen.append(("free", sorted(a._free), list(a._ref)))
    return seen


def test_allocator_matches_jax_allocator_op_for_op():
    ja, ta = jkv.BlockAllocator(8, 8), tkv.BlockAllocator(8, 8)
    assert _allocator_script(ta) == _allocator_script(ja)
    js, ts = ja.stats(), ta.stats()
    assert ts == js and ts["host_hits"] == 0  # no host tier attached


def test_chain_hash_is_the_reference_chain():
    h = b""
    for blk in ([1, 2, 3], [4, 5, 6]):
        assert tkv._chain_hash(h, blk) == jkv._chain_hash(h, blk)
        h = tkv._chain_hash(h, blk)
    assert (tkv.BlockAllocator._ns_seed(b"a")
            == jkv.BlockAllocator._ns_seed(b"a"))


def test_double_release_raises():
    a = tkv.BlockAllocator(2, 4)
    b = a.alloc()
    a.release(b)
    with pytest.raises(RuntimeError):
        a.release(b)


# -- programs -------------------------------------------------------------------

NB, BS, ML, SLOTS = 20, 8, 64, 3


def _pools_close(ts, js):
    for t, j in ((ts.k, js.k), (ts.v, js.v)):
        np.testing.assert_allclose(t[:, :NB].numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)


def _scalars(st):
    return {f: np.asarray(getattr(st, f)).tolist()
            for f in ("block_tables", "lengths", "last_token", "active",
                      "remaining")}


def _run_chunks(weights, splits, prompt, slot, table):
    """The prompt prefilled in chunks of `splits` through both packages'
    chunk programs, on fresh states; returns both states and firsts."""
    jp, tp = weights
    js = jkv.init_paged_state(JCFG, SLOTS, ML, BS, NB)
    ts = tkv.init_paged_state(TCFG, SLOTS, ML, BS, NB, CPU)
    row = table + [NB] * (ML // BS - len(table))
    pos, firsts = 0, []
    for i, n in enumerate(splits):
        c = max(8, 1 << (n - 1).bit_length())
        final = i == len(splits) - 1
        toks = prompt[pos:pos + n] + [0] * (c - n)
        js, jf = jkv.make_chunk_prefill(JCFG, c)(
            jp, js, jnp.int32(slot), jnp.asarray(row, jnp.int32),
            jnp.asarray([toks], jnp.int32), jnp.int32(n), jnp.int32(pos),
            jnp.int32(6), jnp.float32(0.0), jnp.float32(1.0),
            jax.random.PRNGKey(0), jnp.asarray(final))
        ts, tf, logits = tkv.make_chunk_prefill(TCFG, c)(
            tp, ts, slot, row, toks, n, pos, 6, 0.0, 1.0, None, final)
        pos += n
        if final:
            firsts.append((int(jf), int(tf)))
            assert logits.shape == (TCFG.vocab_size,)
    return js, ts, firsts


@pytest.mark.parametrize("splits", [(27,), (5, 16, 6), (8, 8, 8, 3), (16, 11)])
def test_chunk_prefill_then_paged_decode_match_jax(weights, splits):
    jp, tp = weights
    prompt = _prompt(4, sum(splits))
    table = [11, 3, 17, 0, 6]  # scattered blocks, room for decode growth
    js, ts, firsts = _run_chunks(weights, splits, prompt, 1, table)
    assert firsts[0][0] == firsts[0][1]
    _pools_close(ts, js)
    assert _scalars(ts) == _scalars(js)
    jstep = jkv.make_paged_decode_step(JCFG, steps=3)
    tstep = tkv.make_paged_decode_step(TCFG, steps=3)
    for _ in range(2):  # 6 tokens: the budget runs out, the slot retires
        js, jt, ja = jstep(jp, js, jax.random.PRNGKey(1))
        ts, tt, ta = tstep(tp, ts, None, sampling=False, nucleus=False)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert ta.tolist() == np.asarray(ja).tolist()
    _pools_close(ts, js)
    assert _scalars(ts) == _scalars(js)


def test_masked_writes_leave_the_pool_byte_identical(weights):
    """Inactive slots with stale tables, and prompt rows whose table entry
    is the sentinel, write only to the discard block."""
    _, tp = weights
    ts = tkv.init_paged_state(TCFG, SLOTS, ML, BS, NB, CPU)
    ts.k[:, :NB].normal_()
    ts.v[:, :NB].normal_()
    ts.block_tables[:, :3] = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                                          dtype=torch.int32)
    ts.lengths[:] = torch.tensor([5, 17, 23], dtype=torch.int32)
    before = (ts.k[:, :NB].clone(), ts.v[:, :NB].clone())
    tkv.make_paged_decode_step(TCFG, steps=2)(tp, ts, None, sampling=False,
                                              nucleus=False)
    assert torch.equal(ts.k[:, :NB], before[0])
    assert torch.equal(ts.v[:, :NB], before[1])
    # A chunk whose table ends early: rows 8.. have no block -> dropped.
    row = [12] + [NB] * (ML // BS - 1)
    tkv.make_chunk_prefill(TCFG, 16)(tp, ts, 0, row, _prompt(1, 16), 16, 0,
                                     4, 0.0, 1.0, None, False)
    changed = (ts.k[:, :NB] != before[0]).any(dim=(0, 2, 3, 4))
    assert changed.nonzero().flatten().tolist() == [12]
    assert torch.equal(ts.k[:, 12, :, :, :][:, BS:], before[0][:, 12][:, BS:])


def test_copy_block_copies_every_layer():
    ts = tkv.init_paged_state(TCFG, 1, ML, BS, NB, CPU)
    ts.k.normal_()
    ts.v.normal_()
    tkv.make_copy_block()(ts, 3, 9)
    assert torch.equal(ts.k[:, 9], ts.k[:, 3]) and torch.equal(ts.v[:, 9], ts.v[:, 3])


def test_init_paged_state_layout():
    with pytest.raises(ValueError):
        tkv.init_paged_state(TCFG, 2, 32, 5, 8, CPU)
    js = jkv.init_paged_state(JCFG, 2, 32, 8, 8)
    ts = tkv.init_paged_state(TCFG, 2, 32, 8, 8, CPU)
    assert ts.num_blocks == 8 and tuple(ts.pools(0)[0].shape) == js.k.shape[1:]
    assert _scalars(ts) == _scalars(js)


# -- dense reference ----------------------------------------------------------


def test_dense_prefill_insert_decode_match_jax(weights):
    jp, tp = weights
    p1, p2 = _prompt(2, 9), _prompt(3, 9)
    js = jsrv.init_decode_state(JCFG, 2, 32)
    ts = tsrv.init_decode_state(TCFG, 2, 32, CPU)
    jpre, tpre = jsrv.make_prefill(JCFG), tsrv.make_prefill(TCFG)
    rows_j, rows_t, firsts = [], [], []
    for p in (p1, p2):
        jk, jv, jf = jpre(jp, jnp.asarray([p], jnp.int32), jnp.float32(0.0),
                          jnp.float32(1.0), jax.random.PRNGKey(0))
        tk, tv, tf = tpre(tp, torch.tensor([p]), 0.0, 1.0, None)
        assert int(jf) == int(tf)
        rows_j.append((jk, jv))
        rows_t.append((tk, tv))
        firsts.append(int(tf))
    jk = jnp.concatenate([r[0] for r in rows_j], 1)
    jv = jnp.concatenate([r[1] for r in rows_j], 1)
    tk = torch.cat([r[0] for r in rows_t], 1)
    tv = torch.cat([r[1] for r in rows_t], 1)
    args = ([0, 1], [9, 9], firsts, [5, 5], [0.0, 0.0], [1.0, 1.0])
    js = jsrv.make_insert()(js, jnp.asarray([0, 1]), jk, jv,
                            *(jnp.asarray(a) for a in args[1:]))
    ts = tsrv.make_insert()(ts, args[0], tk, tv, *args[1:])
    jt = jsrv.make_decode_step(JCFG, steps=5)(jp, js, jax.random.PRNGKey(0))[1]
    tt = tsrv.make_decode_step(TCFG, steps=5)(tp, ts, None)[1]
    assert tt.tolist() == np.asarray(jt).tolist()


def _spill_script(a, spilled, log):
    """Fill the pool with published blocks, then allocate past it: each
    eviction spills its key; a match on a spilled key swaps it back in."""
    p1 = _prompt(1, 33)
    t1 = [a.alloc() for _ in range(4)]
    a.insert_full(p1, t1)
    for b in t1:
        a.release(b)
    hog = [a.alloc() for _ in range(a.num_blocks)]
    log.append(("hog", hog, sorted(spilled)))
    for b in hog:
        if b is not None:
            a.release(b)
    log.append(("match", a.match(p1[:20] + [7])))
    log.append(("match_again", a.match(p1[:20] + [7])))
    log.append(("stats", a.stats()))
    return log


def test_allocator_host_tier_hooks_match_jax():
    """The spill hook runs at eviction with the victim's key, the swap-in
    hook on a miss (its block becomes the cache's hold and a host hit is
    counted), op for op as the JAX allocator does with the same hooks."""

    def run(mod):
        spilled, log = {}, []
        a = None

        def spill(key, b):
            spilled[key] = b

        def swap_in(key):
            if key not in spilled:
                return None
            spilled.pop(key)
            return a.alloc()

        a = mod.BlockAllocator(6, 8, spill=spill, swap_in=swap_in)
        return _spill_script(a, spilled, log)

    got, want = run(tkv), run(jkv)
    assert got == want
    stats = got[-1][1]
    # The first match swaps the spilled blocks back (a host hit), the
    # second finds them on the device again.
    assert stats["host_hits"] == 1 and stats["hits"] == 2 and stats["evictions"] >= 4
