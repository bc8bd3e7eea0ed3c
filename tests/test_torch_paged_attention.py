"""Ragged paged attention in the PyTorch port, held against the JAX
package's implementations on the same numpy inputs.

The port's plain version mirrors `_ragged_attention_lax` (two-pass,
probabilities rounded to q.dtype at the final stats). Tolerances:
- f32: 1e-6 against the lax version (same algorithm, summation order
  only); 1e-5 against the interpret-mode Pallas kernel (one-pass).
- bf16: inputs are the same bf16 values in both; the outputs are bf16,
  whose ulp near 1 is 2^-7, and a probability that rounds to the other
  side of a bf16 tie moves one term by 2^-8 relative: 2e-2 absolute.
The CUDA kernel runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads.paged_attention import (
    _ragged_attention_lax,
    _ragged_attention_pallas,
)
from dstack_tpu_torch.workloads import paged_attention as tpa

SHAPES = (
    # (B, S, H, KV, hd, NB, bs, MB): the JAX tests' decode-, verify- and
    # chunk-shaped cases (tests/test_paged_attention.py).
    (3, 1, 4, 2, 32, 16, 8, 6),
    (2, 5, 4, 4, 32, 12, 8, 5),
    (1, 16, 8, 2, 128, 20, 16, 4),
)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, B, S, H, KV, hd, NB, bs, MB):
    """Random pool, sentinel-padded tables, ragged valid lengths that
    straddle block boundaries (numpy, f32)."""
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
    vlen = np.stack(
        [rng.integers(1, nblk[b] * bs + 1, S) for b in range(B)]
    ).astype(np.int32)
    return q, kp, vp, tables, vlen


def _torch(arrays, dtype):
    q, kp, vp, tables, vlen = arrays
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
            torch.from_numpy(vlen))


def _jax(arrays, dtype):
    q, kp, vp, tables, vlen = arrays
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(tables), jnp.asarray(vlen))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_lax_fallback(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(7, *shape)
    want = _ragged_attention_lax(*_jax(arrays, jdt))
    got = tpa._ragged_attention_plain(*_torch(arrays, tdt))
    assert got.dtype == tdt and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel_interpret(dtype):
    """The hd-128 shape through the TPU kernel itself (interpret mode)."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(5, *SHAPES[2])
    want = _ragged_attention_pallas(*_jax(arrays, jdt), interpret=True)
    got = tpa._ragged_attention_plain(*_torch(arrays, tdt))
    tol = max(tol, 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_nan_in_unused_blocks_and_sentinel_columns_never_reaches_output():
    """NaN in every pool position no row may see — blocks no table names
    (where sentinel columns clamp), and rows past each slot's longest
    valid length — leaves the output finite and unchanged, K and V both."""
    B, S, H, KV, hd, NB, bs, MB = 2, 3, 4, 2, 32, 10, 8, 4
    q, kp, vp, tables, vlen = _torch(_inputs(3, B, S, H, KV, hd, NB, bs, MB),
                                     torch.float32)
    clean = tpa._ragged_attention_plain(q, kp, vp, tables, vlen)
    kp2, vp2 = kp.clone(), vp.clone()
    named = set(tables[tables < NB].tolist())
    for blk in set(range(NB)) - named:
        kp2[blk] = float("nan")
        vp2[blk] = float("nan")
    for b in range(B):
        longest = int(vlen[b].max())
        for pos in range(longest, MB * bs):
            blk = int(tables[b, pos // bs])
            if blk < NB:
                kp2[blk, pos % bs] = float("nan")
                vp2[blk, pos % bs] = float("nan")
    out = tpa.ragged_attention(q, kp2, vp2, tables, vlen)
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)


def test_dispatch_on_cpu_names_the_plain_path():
    assert tpa.dispatch_path(torch.device("cpu"), 128) == "plain"
    assert tpa.dispatch_path("cpu", 96) == "plain"
    arrays = _torch(_inputs(1, *SHAPES[0]), torch.float32)
    before = dict(tpa.LAUNCHES)
    assert torch.equal(tpa.ragged_attention(*arrays),
                       tpa._ragged_attention_plain(*arrays))
    assert tpa.LAUNCHES == before  # the plain path launches no kernel


def test_cuda_dispatch_refuses_head_dims_the_kernel_lacks():
    assert tpa.dispatch_path("cuda", 128) == "cuda"
    with pytest.raises(NotImplementedError):
        tpa.dispatch_path("cuda", 96)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "table_dtype", "host"])
def test_kernel_wrapper_raises_instead_of_falling_back(bad):
    """The CUDA wrapper validates before any launch and raises; it never
    hands its inputs to the plain version."""
    q, kp, vp, tables, vlen = _torch(_inputs(2, *SHAPES[2]), torch.float32)
    if bad == "head_dim":
        q, kp, vp = q[..., :96], kp[..., :96].contiguous(), vp[..., :96].contiguous()
        q = q.contiguous()
        err = NotImplementedError
    elif bad == "dtype":
        q = q.to(torch.bfloat16)
        err = TypeError
    elif bad == "table_dtype":
        tables = tables.to(torch.int64)
        err = TypeError
    else:
        err = ValueError  # CPU tensors: the kernel runs on the card only
    with pytest.raises(err):
        tpa._ragged_attention_cuda(q, kp, vp, tables, vlen)


# -------------------------------------------------- the kernel's split plan

# (B, S, H, KV, MB, bs): the smoke's decode and chunk shapes on smol-1b,
# the 8b preset's n_rep 4, a long single slot, a wide batch, tiny blocks.
PLAN_SHAPES = (
    (8, 1, 16, 8, 128, 16),
    (1, 128, 16, 8, 128, 16),
    (8, 1, 32, 8, 128, 16),
    (1, 1, 16, 8, 2048, 16),
    (64, 1, 16, 8, 2048, 16),
    (3, 5, 4, 2, 6, 8),
    (2, 7, 8, 8, 4096, 1),
)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_split_plan_covers_every_column_once(shape):
    B, S, H, KV, MB, bs = shape
    plan = tpa._split_plan(B, S, H, KV, MB, bs, 64, torch.bfloat16, 132)
    cols = MB * bs
    starts = [s * plan.keys_per_split for s in range(plan.splits)]
    covered = [c for s in starts for c in range(s, min(s + plan.keys_per_split, cols))]
    assert covered == list(range(cols))
    assert plan.keys_per_split % tpa.KEY_ALIGN == 0
    assert (plan.keys_per_split - 1) // bs + 2 <= tpa.MAX_TABLE_ENTRIES
    assert plan.rows_per_cta * (H // KV) <= tpa.CTA_VECTORS
    assert plan.row_tiles * plan.rows_per_cta >= S > (plan.row_tiles - 1) * plan.rows_per_cta
    assert plan.ctas == plan.row_tiles * plan.splits * KV * B
    assert plan.workspace == ((plan.splits, B * S * H, 66) if plan.splits > 1 else None)


@pytest.mark.parametrize("shape,sms,ctas", [((8, 1, 16, 8, 128, 16), 132, 512),
                                            ((1, 128, 16, 8, 128, 16), 132, 1024),
                                            ((8, 1, 16, 8, 128, 16), 114, 512),
                                            ((1, 128, 16, 8, 128, 16), 114, 512)])
def test_split_plan_fills_the_card_at_the_smoke_shapes(shape, sms, ctas):
    """A full-length batch puts at least 2 CTAs on each SM (the H100 SXM's
    132, the PCIe card's 114): at decode 8 splits of 256 keys (8 x 8 x 8
    CTAs), for the 128-token chunk 32 of 64 (4 row tiles x 32 x 8) on 132
    SMs and 16 of 128 on 114."""
    plan = tpa._split_plan(*shape, 128, torch.bfloat16, sms)
    assert plan.ctas == ctas >= 2 * sms
    assert plan.splits > 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("S", [1, 2, 128])
def test_split_plan_takes_its_target_from_shape_and_dtype(S, dtype):
    """A decode step (S 1) and a chunk (S > 1) take the CTAs-per-SM target
    of their dtype: 8 for a bf16 chunk, else 4. Passing the target gives
    the same plan, the other one a different plan."""
    per_sm = 8 if dtype == torch.bfloat16 and S > 1 else 4
    assert tpa.CTAS_PER_SM[(dtype, S == 1)] == per_sm
    shape = (8, S, 16, 8, 128, 16, 128, dtype, 132)
    assert tpa._split_plan(*shape) == tpa._split_plan(*shape, per_sm)
    assert tpa._split_plan(*shape, {4: 8, 8: 4}[per_sm]) != tpa._split_plan(*shape)


def test_split_plan_ignores_valid_lengths():
    """The plan's inputs are shapes: nothing of it can read valid_len."""
    import inspect

    assert list(inspect.signature(tpa._split_plan).parameters) == [
        "B", "S", "H", "KV", "MB", "bs", "hd", "dtype", "sms", "per_sm"]


@pytest.mark.parametrize("keys_per_split", [8, 16, 24, 64])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_then_merge_matches_plain_and_jax(shape, keys_per_split):
    """The kernel's structure in plain PyTorch: per-split partials merged
    as the combine kernel merges them, on tiny f32, against the plain
    two-pass version and the JAX `_ragged_attention_lax` (1e-6). The many
    splits include empty ones (past a row's length, never read) and ones
    over sentinel columns only (m at its floor, l 0)."""
    bs = shape[6]
    if keys_per_split % bs:
        pytest.skip(f"splits are whole blocks of {bs}")
    arrays = _inputs(11, *shape)
    args = _torch(arrays, torch.float32)
    got = tpa._ragged_attention_split(*args, keys_per_split)
    np.testing.assert_allclose(_np(got), _np(tpa._ragged_attention_plain(*args)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(_ragged_attention_lax(*_jax(arrays, jnp.float32))),
                               rtol=1e-6, atol=1e-6)


def test_merge_floors_rows_with_no_split_and_sentinel_only_splits():
    """A row that reads no split is 0; a split whose keys are all masked
    (m at NEG_INF / 2, l 0) weighs nothing beside a real one, and alone
    gives 0 through the 1e-30 floor rather than NaN."""
    o = torch.ones((1, 1, 2, 4))
    real = (o * 3, torch.zeros((1, 1, 2, 1)), torch.full((1, 1, 2, 1), 2.0))
    empty = (torch.zeros_like(o), torch.full((1, 1, 2, 1), tpa.NEG_INF / 2),
             torch.zeros((1, 1, 2, 1)))
    used = torch.tensor([[[True, True]], [[False, True]]])           # (splits, B, S)
    out = tpa._merge_splits([empty, real], used)
    assert torch.equal(out[0, 0, 0], torch.zeros(4))                  # the empty split alone
    assert torch.equal(out[0, 0, 1], torch.full((4,), 1.5))           # the real one, 3 / 2
    none = tpa._merge_splits([real], torch.zeros((1, 1, 2), dtype=torch.bool))
    assert torch.equal(none, torch.zeros_like(none))


@pytest.mark.parametrize("shape,dtype,splits,kps", [
    ((8, 1, 16, 8, 128, 16), torch.bfloat16, 8, 256),   # the card tests' decode split cases
    ((8, 1, 32, 8, 128, 16), torch.float32, 8, 256),
    ((1, 128, 16, 8, 128, 16), torch.bfloat16, 32, 64),  # the chunk at 1920
    ((1, 128, 16, 8, 128, 16), torch.float32, 16, 128),
    ((2, 3, 16, 8, 128, 16), torch.float32, 32, 64),    # the NaN case across splits
], ids=str)
def test_split_plan_of_the_card_tests(shape, dtype, splits, kps):
    plan = tpa._split_plan(*shape, 128, dtype, 132)
    assert (plan.splits, plan.keys_per_split) == (splits, kps)
