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
