"""Tests of the port's CUDA kernels, which run only on the card (a CUDA
kernel has no interpret mode). Each skips without a CUDA device. This
file imports neither JAX nor the JAX package, so the card's machine
(which has no JAX) runs it on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernel is one-pass (probabilities rounded to the storage
dtype against the running max), the plain version two-pass (rounded at
the final stats): bf16 outputs agree to 1e-2, f32 to 2e-5.
"""

import numpy as np
import pytest
import torch

from dstack_tpu_torch.workloads import paged_attention as tpa

SHAPES = (
    # (B, S, H, KV, hd, NB, bs, MB): decode, verify and chunk shapes over
    # every head_dim the kernel takes, n_rep 1/2/4, blocks 8/16/32.
    (3, 1, 4, 2, 32, 16, 8, 6),
    (2, 5, 4, 4, 64, 12, 8, 5),
    (1, 16, 8, 2, 128, 20, 16, 4),
    (8, 1, 16, 8, 128, 300, 16, 32),
    (1, 128, 16, 8, 128, 64, 16, 48),
    (2, 7, 8, 8, 64, 40, 32, 9),
)
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


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
    want = tpa._ragged_attention_plain(*args)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["ragged_paged_attention"] == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_ignores_nan_in_positions_no_row_sees(cuda):
    q, kp, vp, tables, vlen = _inputs(3, 2, 3, 4, 2, 64, 10, 8, 4, torch.float32)
    clean = tpa.ragged_attention(q, kp, vp, tables, vlen)
    named = set(tables[tables < 10].tolist())
    for blk in set(range(10)) - named:
        kp[blk] = float("nan")
        vp[blk] = float("nan")
    for b in range(2):
        for pos in range(int(vlen[b].max()), 32):
            blk = int(tables[b, pos // 8])
            if blk < 10:
                kp[blk, pos % 8] = float("nan")
                vp[blk, pos % 8] = float("nan")
    out = tpa.ragged_attention(q, kp, vp, tables, vlen)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, clean, rtol=0, atol=0)
