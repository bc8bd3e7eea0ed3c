"""Tests of the port's CUDA kernels, which run only on the card (a CUDA
kernel has no interpret mode). Each skips without a CUDA device. This
file imports neither JAX nor the JAX package, so the card's machine
(which has no JAX) runs it on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the paged kernel is one-pass (probabilities rounded to the
storage dtype against the running max of its split), the plain version
two-pass (rounded at the final stats). Its output is held over the output
rows (b, i, h) by three scale-free readings (`_paged_errors`), within
PAGED_TOL: bf16 rel_l2 1e-2, row_rel 2.5e-2 and row_l2 1.2e-2, f32
2.6e-6, 1.1e-5 and 4.7e-6, each ~3x the largest reading of the unsplit
kernel that the split-KV one replaced, on the H100, over these cases and
chip_smoke.py's (bf16 3.19e-3,
7.81e-3 and 5.40e-3, f32 8.52e-7, 3.55e-6 and 1.56e-6) but bf16 row_l2,
2.2x, since 3x would pass a 1.6% error. A max |diff| would be set by
the shortest slot, whose outputs are ~8x a 2047-position slot's, and would
pass a 1.6% error everywhere else; row_l2, the largest per-row relative
L2, fails a 1.6% error in any one row. The flash kernels round P and dS to bf16 before their products where the
plain versions keep f32. Each output is held by two scale-free readings
(`_errors`), at ~3x the largest reading of sound runs on the H100: bf16
rel_l2 9e-3 and row_rel 2.5e-2, f32 2e-6 and 1.2e-5 (summation order).
The ring-step kernel's unnormalised o is held the same way, its m by max
abs error and its l by max relative error (BLOCK_STAT_TOL).
"""

import numpy as np
import pytest
import torch

from dstack_tpu_torch.workloads import flash_attention as tfa
from dstack_tpu_torch.workloads import paged_attention as tpa

SHAPES = (
    # (B, S, H, KV, hd, NB, bs, MB): decode, verify and chunk shapes over
    # every head_dim the kernel takes, n_rep 1/2/4, blocks 8/16/32; the
    # last two span many KV splits (MB * bs 2048).
    (3, 1, 4, 2, 32, 16, 8, 6),
    (2, 5, 4, 4, 64, 12, 8, 5),
    (1, 16, 8, 2, 128, 20, 16, 4),
    (8, 1, 16, 8, 128, 300, 16, 32),
    (1, 128, 16, 8, 128, 64, 16, 48),
    (2, 7, 8, 8, 64, 40, 32, 9),
    (4, 1, 16, 8, 128, 600, 16, 128),
    (2, 3, 32, 8, 64, 300, 16, 128),
)
# (rel_l2, row_rel, row_l2) over the output rows, as chip_smoke.PAGED_TOL.
PAGED_TOL = {torch.float32: (2.6e-6, 1.1e-5, 4.7e-6), torch.bfloat16: (1e-2, 2.5e-2, 1.2e-2)}


def _inputs(seed, B, S, H, KV, hd, NB, bs, MB, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)
    nblk = rng.integers(1, MB + 1, B)
    blocks = rng.permutation(NB)[: int(nblk.sum())]
    c = 0
    for b in range(B):
        tables[b, : nblk[b]] = blocks[c: c + nblk[b]]
        c += nblk[b]
    vlen = np.stack([rng.integers(1, nblk[b] * bs + 1, S)
                     for b in range(B)]).astype(np.int32)
    dev = torch.device("cuda")
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype), torch.from_numpy(tables).to(dev),
            torch.from_numpy(vlen).to(dev))


def _slot_inputs(seed, starts, S, H, KV, hd, bs, MB, dtype, nan=True):
    """Slot b holds starts[b] + S positions in blocks drawn at random from
    a pool of B * MB blocks, its row i attends positions < starts[b] + 1 +
    i (a decode step at S 1, a chunk at S > 1); with `nan`, every position
    no row may see (each slot's tail, blocks no table names) is NaN."""
    B = len(starts)
    NB = B * MB
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)
    perm = rng.permutation(NB)
    used = set()
    c = 0
    for b, start in enumerate(starts):
        n = -(-(start + S) // bs)
        tables[b, :n] = perm[c:c + n]
        used.update(perm[c:c + n].tolist())
        c += n
        if nan:
            tail = start + S - (n - 1) * bs
            kp[perm[c - 1], tail:] = np.nan
            vp[perm[c - 1], tail:] = np.nan
    if nan:
        for blk in set(range(NB)) - used:
            kp[blk] = np.nan
            vp[blk] = np.nan
    vlen = np.stack([np.arange(s + 1, s + S + 1) for s in starts]).astype(np.int32)
    dev = torch.device("cuda")
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype), torch.from_numpy(tables).to(dev),
            torch.from_numpy(vlen).to(dev))


def _paged_errors(got, want, heads):
    """`_errors` over the output rows (b, i, h) of a (B, S, H*hd) output,
    and row_l2: the largest over rows of ||got - want|| / ||want|| in the
    row (floored at ROW_FLOOR x the RMS row norm)."""
    B, S, _ = want.shape
    g, w = (x.reshape(B, S, heads, -1).double() for x in (got, want))
    d, wn = (g - w).norm(dim=-1), w.norm(dim=-1)
    floor = max(ROW_FLOOR * float(wn.square().mean().sqrt()), 1e-30)
    return (*_errors(g, w), float((d / wn.clamp_min(floor)).max()))


def _check_paged(got, args, dtype, label):
    want = tpa._ragged_attention_plain(*args)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    errs = _paged_errors(got, want, args[0].shape[2])
    print(f"paged readings {label} {dtype}: rel_l2={errs[0]:.3e} row_rel={errs[1]:.3e}"
          f" row_l2={errs[2]:.3e}")
    assert _within(errs, PAGED_TOL[dtype]), errs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100): the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    args = _inputs(9, *shape, dtype)
    before = tpa.LAUNCHES["ragged_paged_attention"]
    got = tpa.ragged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["ragged_paged_attention"] == before + 1
    _check_paged(got, args, dtype, shape)


# Slot lengths around the KV splits (tests/test_torch_paged_attention.py
# pins the plans: 256 positions of 2048 at the decode shapes, B 8): 1, one
# split exactly, one past a split boundary, two splits, a block past, and
# the full 2047 (start + 1 with S 1); a 128-token chunk ending at 2048.
SPLIT_CASES = {
    "decode_n_rep2": (dict(S=1, H=16, KV=8), [0, 255, 256, 511, 527, 2046, 1000, 63]),
    "decode_n_rep4": (dict(S=1, H=32, KV=8), [0, 255, 256, 1023, 1500, 2046, 767, 64]),
    "chunk_at_1920": (dict(S=128, H=16, KV=8), [1920]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_kernel_matches_plain_across_splits_on_card(cuda, case, dtype):
    """Slots that end on and just past KV-split boundaries, NaN in every
    position no row sees (tails that fall in later splits included)."""
    geo, starts = SPLIT_CASES[case]
    args = _slot_inputs(13, starts, hd=128, bs=16, MB=128, dtype=dtype, **geo)
    got = tpa.ragged_attention(*args)
    torch.cuda.synchronize()
    _check_paged(got, args, dtype, case)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["one_split", "across_splits"])
def test_kernel_ignores_nan_in_positions_no_row_sees(cuda, where):
    """NaN written into every position no row may see leaves the output
    bit-for-bit unchanged; in the second case the NaN tails fall in KV
    splits other than the first (slots of 300 and 700 positions, splits
    of 64, pinned in tests/test_torch_paged_attention.py)."""
    if where == "one_split":
        q, kp, vp, tables, vlen = _inputs(3, 2, 3, 4, 2, 64, 10, 8, 4, torch.float32)
    else:
        q, kp, vp, tables, vlen = _slot_inputs(3, [297, 697], 3, 16, 8, 128, 16, 128,
                                               torch.float32, nan=False)
    NB, bs, MB = kp.shape[0], kp.shape[1], tables.shape[1]
    clean = tpa.ragged_attention(q, kp, vp, tables, vlen)
    named = set(tables[tables < NB].tolist())
    for blk in set(range(NB)) - named:
        kp[blk] = float("nan")
        vp[blk] = float("nan")
    for b in range(q.shape[0]):
        for pos in range(int(vlen[b].max()), MB * bs):
            blk = int(tables[b, pos // bs])
            if blk < NB:
                kp[blk, pos % bs] = float("nan")
                vp[blk, pos % bs] = float("nan")
    out = tpa.ragged_attention(q, kp, vp, tables, vlen)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, clean, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph_on_card(cuda):
    """The call captured once in a CUDA graph, replayed after valid_len and
    the table contents change in place (shapes kept), gives the eager
    call's output: the grid is fixed by shapes and nothing of the call
    reads the device from the host."""
    q, kp, vp, tables, vlen = _slot_inputs(21, [100, 900, 2046, 0], 1, 16, 8, 128, 16,
                                           128, torch.bfloat16, nan=False)
    tables.copy_(torch.arange(tables.numel(), dtype=torch.int32,
                              device="cuda").reshape(tables.shape))
    tpa.ragged_attention(q, kp, vp, tables, vlen)  # builds, warms the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.ragged_attention(q, kp, vp, tables, vlen)
    rng = np.random.default_rng(5)
    for lens in ([2048, 5, 300, 1500], [1, 2047, 257, 64]):
        perm = rng.permutation(tables.numel()).astype(np.int32).reshape(tables.shape)
        tables.copy_(torch.from_numpy(perm).cuda())
        vlen.copy_(torch.tensor(lens, dtype=torch.int32, device="cuda")[:, None])
        graph.replay()
        eager = tpa.ragged_attention(q, kp, vp, tables, vlen)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, eager, rtol=0, atol=0)
        _check_paged(out, (q, kp, vp, tables, vlen), torch.bfloat16, f"graph {lens}")


# (rel_l2, row_rel) limits and the lse limit, as chip_smoke.py's.
FLASH_TOL = {torch.float32: (2e-6, 1.2e-5), torch.bfloat16: (9e-3, 2.5e-2)}
LSE_TOL = 3e-6
ROW_FLOOR = 1e-2
# f32 kernels against float64: delta = rowsum(dO * O) in f32 carries ~1e-7
# of |dP| that rows whose dQ cancels to ~0 magnify (read 2.3e-4 on the H100).
F64_TOL = (2e-6, 1e-3)
# At S = 1, dQ and dK vanish up to f32 rounding of dP - delta (~1e-7 of
# |dP| ~ 10, times scale and |K|): max |dQ|, |dK| within this share of
# dV's RMS (dV = dO there).
S1_ZERO_TOL = 1e-5


def _errors(got, want):
    """(rel_l2, row_rel): ||got - want|| / ||want||, and the largest over
    rows (the last dim) of max|got - want| / max|want| in the row. Both are
    scale-free, so a late row of a causal head (values ~20x smaller than
    the first rows' at S 2048) is held as tightly as an early one. A row
    that cancels to 0 (a causal head's first dQ row) is held against
    ROW_FLOOR x the tensor's RMS instead."""
    d = got.detach().double() - want.detach().double()
    w = want.detach().double()
    floor = max(ROW_FLOOR * float(w.square().mean().sqrt()), 1e-30)
    row = d.abs().amax(-1) / w.abs().amax(-1).clamp_min(floor)
    return float(d.norm() / w.norm()), float(row.max())


def _within(errs, tol):
    return all(e <= t for e, t in zip(errs, tol))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 128, 129, 1000, 2048])
def test_flash_kernels_match_plain_on_card(cuda, s, hd, causal, dtype):
    """Forward and backward through the autograd Function (kernels) against
    the plain versions on the same inputs, and the launch counters."""
    rng = np.random.default_rng(s + hd)
    bh = 4 if s < 2048 else 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, hd)).astype(np.float32))
                   .to("cuda", dtype) for _ in range(4))
    before = dict(tfa.LAUNCHES)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    o = tfa._Flash.apply(qq, kk, vv, causal)
    dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_block_fwd": 0}
    # Each plain version on the inputs its kernel saw: the backward ones on
    # the kernel's own o and lse, and delta as _Flash.backward forms it.
    # (From the plain o, delta would differ by o's bf16 rounding, which rows
    # whose dQ cancels, such as a causal head's second query, magnify.)
    o_k, lse = tfa._flash_fwd_cuda(q, k, v, causal)
    torch.testing.assert_close(o_k, o.detach(), rtol=0, atol=0)
    o2, lse2 = tfa._flash_fwd_plain(q, k, v, causal)
    assert float((lse - lse2).abs().max()) <= LSE_TOL
    delta = (do.float() * o_k.float()).sum(-1)
    want = tfa._flash_bwd_plain(q, k, v, o_k, lse, do, delta, causal)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), (o2, *want)):
        assert got.dtype == dtype and torch.isfinite(got.float()).all(), name
        if s == 1 and name in ("dq", "dk"):
            # One key: P = 1, so dS = P (dP - delta) scale and with it dQ and
            # dK are 0 but for the rounding of dP and delta, which no
            # relative reading can hold; they are held to 0 on dV's scale.
            worst = float(got.float().abs().max())
            print(f"flash readings s=1 hd={hd} causal={causal} {dtype} {name}: max={worst:.3e}")
            assert worst <= S1_ZERO_TOL * float(dv.float().square().mean().sqrt()), (name, worst)
            continue
        errs = _errors(got, ref)
        print(f"flash readings s={s} hd={hd} causal={causal} {dtype} {name}:"
              f" rel_l2={errs[0]:.3e} row_rel={errs[1]:.3e}")
        assert _within(errs, FLASH_TOL[dtype]), (name, errs)


@pytest.mark.cuda
def test_flash_f32_kernels_match_a_float64_reference(cuda):
    """The f32 kernels against dense float64 autograd, independent of the
    plain versions: forward, lse and all three grads."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 300, 64))).cuda()
                   for _ in range(4))
    q64, k64, v64 = (x.clone().requires_grad_() for x in (q, k, v))
    logits = torch.einsum("bqd,bkd->bqk", q64, k64) * 64 ** -0.5
    logits = logits.masked_fill(~torch.ones(300, 300, dtype=torch.bool,
                                            device="cuda").tril(), float("-inf"))
    o64 = torch.einsum("bqk,bkd->bqd", logits.softmax(-1), v64)
    g64 = torch.autograd.grad(o64, (q64, k64, v64), do)
    o, lse = tfa._flash_fwd_cuda(q.float(), k.float(), v.float(), True)
    delta = (do.float() * o).sum(-1)
    dq = tfa._flash_bwd_dq_cuda(q.float(), k.float(), v.float(), do.float(), lse, delta, True)
    dk, dv = tfa._flash_bwd_dkv_cuda(q.float(), k.float(), v.float(), do.float(), lse,
                                     delta, True)
    torch.testing.assert_close(lse.double(), logits.logsumexp(-1).detach(),
                               rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), (o64, *g64)):
        errs = _errors(got, want)
        print(f"flash readings f32 vs float64 {name}: rel_l2={errs[0]:.3e}"
              f" row_rel={errs[1]:.3e}")
        assert _within(errs, F64_TOL), (name, errs)


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 16, 4, 96), device="cuda")
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(x, x, x)
    with pytest.raises(ValueError):
        tfa._flash_fwd_cuda(*(torch.zeros((2, 16, 64), device="cuda").transpose(1, 2)
                              .contiguous().transpose(1, 2),) * 3, True)


@pytest.mark.cuda
def test_remat_rungs_through_the_kernels_on_card(cuda):
    """tiny at f32 on the card: "dots" and "full" give the loss and grads of
    "none", and re-run the forward kernel once per layer in backward."""
    from dstack_tpu_torch.workloads.attention import make_attention_fn
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.train import loss_fn, synthetic_batch
    from dstack_tpu_torch.workloads.weights import flatten_params
    from dstack_tpu_torch.workloads.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for remat in ("none", "dots", "full"):
        cfg = PRESETS["tiny"].with_(dtype="float32", remat=remat)
        params = init_params(cfg, seed=3)
        pairs = flatten_params(params)
        for _, p in pairs:
            p.requires_grad_(True)
        batch = synthetic_batch(cfg, 2, 128, seed=3)
        before = dict(tfa.LAUNCHES)
        loss, _ = loss_fn(cfg, params, batch, make_attention_fn())
        grads = torch.autograd.grad(loss, [p for _, p in pairs])
        torch.cuda.synchronize()
        n = {k: tfa.LAUNCHES[k] - before[k] for k in before}
        fwd = cfg.n_layers * (1 if remat == "none" else 2)
        assert n == {"flash_fwd": fwd, "flash_bwd_dq": cfg.n_layers,
                     "flash_bwd_dkv": cfg.n_layers, "flash_block_fwd": 0}, (remat, n)
        results[remat] = (float(loss.detach()), grads)
    for remat in ("dots", "full"):
        assert results[remat][0] == pytest.approx(results["none"][0], rel=1e-6)
        for a, b in zip(results[remat][1], results["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# The ring step's m (max abs error) and l (max relative error): f32 sums of
# the same logits in another order, ~3x the largest sound reading on the
# H100 against plain and float64 (m 2.5e-6, l 2.6e-6).
BLOCK_STAT_TOL = (8e-6, 8e-6)


def _block_f64(q, k, v, causal):
    """The ring step in float64, independent of the plain version."""
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool, device=q.device).tril(),
                          float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bqk,bkd->bqd", p, v.double()), m, p.sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 128, 129, 1000, 2048])
def test_ring_block_kernel_matches_plain_and_float64_on_card(cuda, s, hd, causal, dtype):
    """The ring-step kernel through `_RingBlock` (one launch counted)
    against `_block_ref_bh` and a float64 reference: o, m and l each."""
    rng = np.random.default_rng(100 + s + hd)
    bh = 4 if s < 2048 else 2
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, hd)).astype(np.float32))
               .to("cuda", dtype) for _ in range(3))
    before = dict(tfa.LAUNCHES)
    o, m, l = tfa._RingBlock.apply(q, k, v, causal)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_block_fwd": 1}
    assert o.dtype == m.dtype == l.dtype == torch.float32
    for ref_name, (ro, rm, rl) in (("plain", tfa._block_ref_bh(q, k, v, causal)),
                                   ("float64", _block_f64(q, k, v, causal))):
        errs = _errors(o, ro)
        m_err = float((m.double() - rm.double()).abs().max())
        l_err = float(((l.double() - rl.double()).abs() / rl.double().abs()).max())
        print(f"ring block readings s={s} hd={hd} causal={causal} {dtype} vs {ref_name}:"
              f" o rel_l2={errs[0]:.3e} row_rel={errs[1]:.3e} m={m_err:.3e} l={l_err:.3e}")
        assert torch.isfinite(o).all()
        assert _within(errs, FLASH_TOL[dtype]), (ref_name, errs)
        assert m_err <= BLOCK_STAT_TOL[0] and l_err <= BLOCK_STAT_TOL[1], (ref_name, m_err, l_err)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [129, 2048])
def test_flash_fwd_and_ring_step_epilogues_agree_on_card(cuda, s, causal):
    """The bf16 forward and the ring step share one body and differ in
    the epilogue: the ring step's o / l is the forward's O before its bf16
    rounding, and m + log(l) its lse."""
    rng = np.random.default_rng(300 + s)
    bh = 4 if s < 2048 else 2
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, 128)).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    o, lse = tfa._flash_fwd_cuda(q, k, v, causal)
    bo, bm, bl = tfa._ring_block_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    errs = _errors(o, bo / bl[..., None])
    lse_err = float((lse - (bm + torch.log(bl))).abs().max())
    print(f"epilogues s={s} causal={causal}: rel_l2={errs[0]:.3e} row_rel={errs[1]:.3e}"
          f" lse={lse_err:.3e}")
    assert _within(errs, FLASH_TOL[torch.bfloat16]), errs
    assert lse_err <= LSE_TOL


@pytest.mark.cuda
def test_ring_block_rejects_unequal_shards_on_card(cuda):
    q = torch.zeros((2, 64, 64), device="cuda")
    with pytest.raises(ValueError):
        tfa._ring_block_cuda(q, q[:, :32].contiguous(), q[:, :32].contiguous(), False)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_inside_a_2_layer_model_matches_plain_attention_on_card(cuda, causal):
    """tiny at f32 on the card over a 4-way seq mesh: the loss and every
    leaf's grad through the ring-step kernel against plain_attention, and
    the kernel's launches (10 per layer causal, 16 full)."""
    from dstack_tpu_torch.workloads.attention import make_attention_fn, plain_attention
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.sharding import make_mesh
    from dstack_tpu_torch.workloads.train import loss_fn, synthetic_batch
    from dstack_tpu_torch.workloads.weights import flatten_params
    from dstack_tpu_torch.workloads.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["tiny"].with_(dtype="float32")
    params = init_params(cfg, seed=4)
    pairs = flatten_params(params)
    for _, p in pairs:
        p.requires_grad_(True)
    batch = synthetic_batch(cfg, 2, 128, seed=4)
    mesh = make_mesh(seq=4)
    res = {}
    for name, attn in (("ring", make_attention_fn(mesh, causal=causal)),
                       ("plain", lambda q, k, v: plain_attention(q, k, v, causal=causal))):
        before = tfa.LAUNCHES["flash_block_fwd"]
        loss, _ = loss_fn(cfg, params, batch, attn, mesh)
        grads = torch.autograd.grad(loss, [p for _, p in pairs])
        torch.cuda.synchronize()
        res[name] = (float(loss.detach()), grads, tfa.LAUNCHES["flash_block_fwd"] - before)
    assert res["ring"][2] == cfg.n_layers * (10 if causal else 16) and res["plain"][2] == 0
    assert res["ring"][0] == pytest.approx(res["plain"][0], rel=1e-5)
    for (path, _), g, r in zip(pairs, res["ring"][1], res["plain"][1]):
        assert float((g - r).norm() / r.norm()) <= 1e-4, path
