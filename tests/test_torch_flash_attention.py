"""The port's flash attention on the CPU (its plain versions behind the
autograd Function) against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs: O, and dQ/dK/dV through jax.grad.
Tolerance 1e-5 in f32 (summation order only: both sides compute the same
formulas in f32). The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import flash_attention as jfa
from dstack_tpu_torch.workloads import attention as tattn
from dstack_tpu_torch.workloads import flash_attention as tfa

TOL = 1e-5


def _qkvg(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    g = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, g


def _torch_grads(fn, q, k, v, g):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


# (S, hd, causal): S 128 and 256, hd 32 and 64, GQA 2, causal and not. Each
# case costs a few seconds of interpret-mode Pallas, so they stay few.
CASES = [(128, 32, True), (256, 64, False), (128, 64, True)]


@pytest.mark.parametrize("s,hd,causal", CASES)
def test_plain_flash_matches_jax_interpret_kernels(s, hd, causal):
    q, k, v, g = _qkvg(s + hd, 1, s, 4, 2, hd)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o * g), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to, tgrads = _torch_grads(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal), q, k, v, g)
    np.testing.assert_allclose(to, np.asarray(jo), rtol=TOL, atol=TOL)
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_matches_autograd_of_plain_attention(causal):
    """_Flash's hand-written backward against torch autograd through
    plain_attention (f32, where plain_attention's probs rounding is a
    no-op), ragged S included."""
    q, k, v, g = _qkvg(7, 2, 37, 4, 2, 32)
    fo, fg = _torch_grads(lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal),
                          q, k, v, g)
    po, pg = _torch_grads(lambda a, b, c: tattn.plain_attention(a, b, c, causal=causal),
                          q, k, v, g)
    np.testing.assert_allclose(fo, po, rtol=TOL, atol=TOL)
    for tg, jg in zip(fg, pg):
        np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


def test_plain_attention_matches_jax_in_f32_and_bf16():
    q, k, v, _ = _qkvg(3, 2, 16, 4, 2, 32)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        from dstack_tpu.workloads.attention import plain_attention as jplain

        want = jplain(*(jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v)))
        got = tattn.plain_attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                                      for x in (q, k, v)))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_plain_versions_floor_and_mask_like_the_kernel():
    """Fully masked logits never reach exp(-inf - -inf): lse stays finite
    and the floors of the reference hold."""
    q = torch.zeros((1, 4, 32))
    o, lse = tfa._flash_fwd_plain(q, q, torch.ones((1, 4, 32)), causal=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # Row i sees i + 1 equal logits: lse = log(i + 1).
    torch.testing.assert_close(lse[0], torch.log(torch.arange(1.0, 5.0)))


def test_use_flash_is_false_on_the_cpu():
    assert not tfa.use_flash(2048, 128, "cpu")
    assert not tfa.use_flash(1000, 96, torch.device("cpu"))


def test_use_flash_raises_for_a_head_dim_the_kernels_do_not_take():
    assert tfa.use_flash(1000, 64, "cuda")  # any S on the card
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfa.use_flash(2048, 96, "cuda")


def test_make_attention_fn_dispatch(monkeypatch):
    """On the CPU the single-device path is plain_attention; a head_dim the
    kernels do not take raises on a CUDA device (device check
    monkeypatched: there is no card here); a seq mesh axis > 1 gives the
    ring, which computes the same attention."""
    fn = tattn.make_attention_fn()
    q, k, v, _ = _qkvg(1, 1, 8, 2, 1, 32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    torch.testing.assert_close(fn(tq, tk, tv), tattn.plain_attention(tq, tk, tv))
    assert fn.memory_is_quadratic(2048, 128, 2, device="cpu")
    assert not fn.memory_is_quadratic(2048, 128, 2, device="cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    with pytest.raises(NotImplementedError, match="head_dim"):
        fn(torch.zeros(1, 8, 2, 48), torch.zeros(1, 8, 1, 48), torch.zeros(1, 8, 1, 48))
    monkeypatch.undo()

    class Mesh:
        shape = {"data": 1, "seq": 2}

    ring = tattn.make_attention_fn(Mesh())
    assert ring.__name__ == "ring"
    torch.testing.assert_close(ring(tq, tk, tv), tattn.plain_attention(tq, tk, tv))
    Mesh.shape = {"seq": 1}
    assert tattn.make_attention_fn(Mesh()).__name__ == "single_device"


def test_cuda_wrappers_raise_for_cpu_tensors():
    """The kernels' wrappers take no CPU tensor: the CPU goes through the
    plain versions, chosen by the autograd Function, never by a fallback."""
    x = torch.zeros((2, 16, 32))
    with pytest.raises((ValueError, RuntimeError)):
        tfa._flash_fwd_cuda(x, x, x, True)
