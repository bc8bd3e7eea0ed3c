"""Dense KV-cache generation in the PyTorch port against the JAX package,
on bridged JAX weights (tiny, f32). Logits agree to 1e-5 (summation
order); tokens at temperature 0 are identical; the nucleus filter keeps
exactly the tokens the JAX filter keeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import generate as jgen
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import generate as tgen
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import params_from_numpy

JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _prompt(seed, n, b=1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, JCFG.vocab_size, (b, n)).astype(np.int32)


def test_forward_cached_prefill_and_decode_logits(weights):
    jp, tp = weights
    prompt = _prompt(0, 13, b=2)
    jc = jgen.init_cache(JCFG, 2, 20)
    tc = tgen.init_cache(TCFG, 2, 20, torch.device("cpu"))
    jl, jc = jgen._forward_cached(JCFG, jp, jnp.asarray(prompt), jc)
    tl, tc = tgen._forward_cached(TCFG, tp, torch.from_numpy(prompt), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    assert tc.length == int(jc.length) == 13
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jgen._forward_cached(JCFG, jp, jnp.asarray(nxt), jc)
        tl, tc = tgen._forward_cached(TCFG, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=1e-5, atol=1e-5)


def test_forward_cached_bf16_logits_within_tolerance():
    """bf16 weights and cache: the two frameworks round at other places
    (matmul outputs, softmax), so logits are held to 5e-2 of their
    largest magnitude, not to bits."""
    jcfg, tcfg = JCFG.with_(dtype="bfloat16"), TCFG.with_(dtype="bfloat16")
    jp = jinit(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    prompt = _prompt(5, 11)
    jl, _ = jgen._forward_cached(jcfg, jp, jnp.asarray(prompt),
                                 jgen.init_cache(jcfg, 1, 11))
    tl, _ = tgen._forward_cached(tcfg, tp, torch.from_numpy(prompt),
                                 tgen.init_cache(tcfg, 1, 11, torch.device("cpu")))
    want = np.asarray(jl)
    assert np.abs(tl.numpy() - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("seed,n,new", [(1, 5, 12), (2, 31, 9), (3, 17, 16)])
def test_generate_temperature0_token_exact(weights, seed, n, new):
    jp, tp = weights
    prompt = _prompt(seed, n, b=2)
    want = jgen.generate(JCFG, jp, jnp.asarray(prompt), max_new_tokens=new)
    got = tgen.generate(TCFG, tp, torch.from_numpy(prompt), max_new_tokens=new)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()


def test_generate_sampling_runs_and_stays_in_vocab(weights):
    _, tp = weights
    g = torch.Generator().manual_seed(3)
    out = tgen.generate(TCFG, tp, torch.from_numpy(_prompt(4, 6)),
                        max_new_tokens=8, temperature=0.9, generator=g)
    assert out.shape == (1, 8)
    assert ((out >= 0) & (out < TCFG.vocab_size)).all()


NUCLEUS_CASES = [
    # (logits, top_p): cumulative-mass boundaries hit exactly, ties, p=1
    ([2.0, 1.0, 0.0, -1.0], 1.0),
    ([2.0, 1.0, 0.0, -1.0], 0.5),
    ([0.0, 0.0, 0.0, 0.0], 0.5),    # preceding mass exactly 0.5 at rank 2
    ([0.0, 0.0, 0.0, 0.0], 0.25),   # only the first of the tie survives
    ([3.0, 3.0, -2.0, 1.0], 0.6),
    ([5.0, -5.0, -5.0, -5.0], 1e-6),  # the top token always survives
    ([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0], 0.9),
]


@pytest.mark.parametrize("logits,top_p", NUCLEUS_CASES)
def test_nucleus_filter_boundaries_match_jax(logits, top_p):
    x = np.asarray(logits, np.float32)
    want = np.asarray(jgen._nucleus_filter(jnp.asarray(x), top_p))
    got = tgen._nucleus_filter(torch.from_numpy(x), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_nucleus_filter_random_rows_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        x = rng.standard_normal(64).astype(np.float32) * 3
        p = float(rng.uniform(0.05, 1.0))
        want = np.isinf(np.asarray(jgen._nucleus_filter(jnp.asarray(x), p)))
        got = np.isinf(tgen._nucleus_filter(torch.from_numpy(x), p).numpy())
        np.testing.assert_array_equal(got, want)


def test_sample_logits_row_greedy_and_filtered():
    x = torch.tensor([0.5, 3.0, -1.0, 2.9])
    assert int(tgen.sample_logits_row(x, 0.0, 0.3, None)) == 1
    g = torch.Generator().manual_seed(0)
    # top_p tiny: only the argmax survives, whatever the draw.
    for _ in range(5):
        assert int(tgen.sample_logits_row(x, 1.5, 1e-6, g)) == 1
