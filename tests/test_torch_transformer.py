"""Decoder blocks, int8 quantization and the weight bridge of the PyTorch
port against the JAX package, on the same numpy inputs and bridged JAX
weights. Tolerances: f32 1e-5 (matmul summation order); bf16 2e-2
relative (one bf16 rounding of the result, 2^-8, plus operand order);
int8 quantization and the bridge bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import checkpoint as jckpt
from dstack_tpu.workloads import quant as jquant
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu_torch.workloads import quant as tquant
from dstack_tpu_torch.workloads import transformer as ttr
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import load_packed, params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype):
    return (JPRESETS["tiny"].with_(dtype=dtype),
            PRESETS["tiny"].with_(dtype=dtype))


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x):
    """Raw bytes of a torch tensor or a numpy / JAX array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(_to_np(jparams), "cpu")
    return request.param, jcfg, tcfg, jparams, tparams


def _layer0(jparams, tparams):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    return jp, ttr.layer_params(tparams, 0)


def _x(cfg, dtype, seed=0, b=2, s=5):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _flat_torch(tree, prefix=""):
    """Port params -> {path: tensor}, in the packed format's naming
    ("/"-joined keys, `.q`/`.scale` for a QTensor)."""
    if isinstance(tree, tquant.QTensor):
        return {prefix + ".q": tree.q, prefix + ".scale": tree.scale}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_rms_norm(model):
    dtype, jcfg, tcfg, jparams, tparams = model
    jx, tx = _x(tcfg, dtype)
    jp, tp = _layer0(jparams, tparams)
    _close(ttr.rms_norm(tx, tp["attn_norm"], tcfg.norm_eps),
           jtr.rms_norm(jx, jp["attn_norm"], jcfg.norm_eps), dtype)


@pytest.mark.parametrize("pos_kind", ["shared", "per_row"])
def test_rope(model, pos_kind):
    dtype, jcfg, tcfg, _, _ = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = (np.arange(5, dtype=np.int32) + 3 if pos_kind == "shared"
           else rng.integers(0, 200, (2, 5)).astype(np.int32))
    want = jtr._rope(jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(pos), jcfg.rope_theta)
    got = ttr._rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                    torch.from_numpy(pos), tcfg.rope_theta)
    _close(got, want, dtype)


def test_project_qkv(model):
    dtype, jcfg, tcfg, jparams, tparams = model
    jx, tx = _x(tcfg, dtype, seed=2)
    jp, tp = _layer0(jparams, tparams)
    pos = np.arange(5, dtype=np.int32) + 7
    want = jtr.project_qkv(jcfg, jx, jp, jnp.asarray(pos))
    got = ttr.project_qkv(tcfg, tx, tp, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, dtype)


def test_mlp_block(model):
    dtype, jcfg, tcfg, jparams, tparams = model
    jx, tx = _x(tcfg, dtype, seed=3)
    jp, tp = _layer0(jparams, tparams)
    _close(ttr.mlp_block(tcfg, tx, tp), jtr.mlp_block(jcfg, jx, jp), dtype)


@pytest.mark.parametrize("quantized", [False, True])
def test_linear_and_logits_linear(model, quantized):
    dtype, jcfg, tcfg, jparams, tparams = model
    jx, tx = _x(tcfg, dtype, seed=4)
    jw, tw = jparams["lm_head"], tparams["lm_head"]
    if quantized:
        jw = jquant.quantize_tensor(jw)
        tw = tquant.quantize_tensor(tw)
    y_j, y_t = jtr.logits_linear(jx, jw), ttr.logits_linear(tx, tw)
    assert y_t.dtype == torch.float32
    _close(y_t, y_j, "float32" if dtype == "float32" else "bfloat16")
    _close(ttr.linear(tx, tw), jtr.linear(jx, jw), dtype)


def test_quantize_tensor_bit_exact(model):
    dtype, _, _, jparams, tparams = model
    jq = jquant.quantize_tensor(jparams["layers"]["wq"])
    tq = tquant.quantize_tensor(tparams["layers"]["wq"])
    assert _bits(tq.q) == _bits(jq.q)
    assert _bits(tq.scale) == _bits(jq.scale)
    deq = tquant.dequantize_tensor(tq, tparams["layers"]["wq"].dtype)
    assert _bits(deq) == _bits(jquant.dequantize_tensor(jq, jparams["layers"]["wq"].dtype))


def test_quantize_params_structure(model):
    _, _, _, _, tparams = model
    qp = tquant.quantize_params(tparams)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert isinstance(qp["layers"][k], tquant.QTensor)
    assert isinstance(qp["lm_head"], tquant.QTensor)
    assert not isinstance(qp["embed"], tquant.QTensor)
    assert qp["layers"]["attn_norm"] is tparams["layers"]["attn_norm"]


def test_bridge_round_trip_is_bit_exact_for_f32_bf16_and_int8(model):
    """JAX params (f32 or bf16 leaves, plus int8 QTensor leaves) -> numpy
    -> torch keeps every bit, shape, dtype and the stacked layout."""
    dtype, _, _, jparams, _ = model
    jtree = jquant.quantize_params(jparams)
    ttree = params_from_numpy(_to_np(jtree), "cpu")
    jleaves = jckpt._flatten_params(jtree)
    flat_t = _flat_torch(ttree)
    assert sorted(flat_t) == sorted(n for n, _ in jleaves)
    want_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}
    for name, leaf in jleaves:
        got = flat_t[name]
        assert tuple(got.shape) == tuple(leaf.shape), name
        assert got.dtype == want_dt[str(leaf.dtype)], name
        assert _bits(got) == _bits(leaf), name


def test_packed_reader_reads_jax_save_packed(model, tmp_path):
    dtype, _, _, jparams, _ = model
    jtree = {"plain": jparams, "int8": jquant.quantize_params(jparams)}
    for key, tree in jtree.items():
        jckpt.save_packed(tmp_path / key, tree)
        got = load_packed(tmp_path / key, "cpu")
        want = params_from_numpy(_to_np(tree), "cpu")
        flat_g, flat_w = _flat_torch(got), _flat_torch(want)
        assert sorted(flat_g) == sorted(flat_w)
        for n, g in flat_g.items():
            assert g.dtype == flat_w[n].dtype and _bits(g) == _bits(flat_w[n]), (key, n)
    assert load_packed(tmp_path / "absent", "cpu") is None


def test_init_params_matches_reference_layout(model):
    """Same tree, shapes and dtypes as the JAX init; N(0, 1/fan_in)."""
    dtype, jcfg, tcfg, jparams, _ = model
    tparams = ttr.init_params(tcfg, seed=0, device="cpu")
    jflat = dict(jax.tree_util.tree_leaves_with_path(jparams))
    tflat = {}

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            tflat[path] = node

    walk(tparams)
    jshapes = {tuple(p.key for p in path): (tuple(v.shape), str(v.dtype))
               for path, v in jflat.items()}
    tshapes = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tflat.items()}
    assert tshapes == jshapes
    std = float(tparams["layers"]["wq"].float().std())
    assert abs(std - tcfg.d_model ** -0.5) < 0.05 * tcfg.d_model ** -0.5


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_presets_and_derived_sizes_match_jax(name):
    """Same preset names, fields and derived sizes as the JAX config (the
    port lists every reference preset, the MoE ones included)."""
    assert set(PRESETS) == set(JPRESETS)
    j, t = JPRESETS[name], PRESETS[name]
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "rope_theta", "norm_eps", "max_seq_len", "dtype",
              "n_experts", "experts_per_token")
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    assert t.head_dim == j.head_dim
    assert t.dtype_bytes == j.dtype_bytes
    assert t.activation_dtype == getattr(torch, j.dtype)
    assert t.param_count() == j.param_count()
    for seq_len in (None, 2048):
        assert t.flops_per_token(seq_len) == j.flops_per_token(seq_len)


# ---------------------------------------------------------------- forward


def _tokens(cfg, seed=0, b=2, s=128):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_match_jax(model):
    """The full-sequence forward (plain attention on the CPU) against the
    JAX forward, logits and hidden states; aux 0 for a dense model. bf16 is
    held as max|diff| <= 2e-2 * max|ref| over the whole tensor: two layers
    of bf16 rounding at different points move single small elements by
    more than an elementwise tolerance allows."""
    dtype, jcfg, tcfg, jparams, tparams = model
    tok = _tokens(tcfg)
    want = jtr.forward(jcfg, jparams, jnp.asarray(tok))
    got, aux = ttr.forward(tcfg, tparams, torch.from_numpy(tok), return_aux=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    pos = np.arange(128, dtype=np.int32) + 5
    hid_j = jtr.forward(jcfg, jparams, jnp.asarray(tok), positions=jnp.asarray(pos),
                        return_hidden=True)
    hid_t = ttr.forward(tcfg, tparams, torch.from_numpy(tok),
                        positions=torch.from_numpy(pos), return_hidden=True)
    for g, w in ((got, want), (hid_t, hid_j)):
        if dtype == "float32":
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(_f32(g) - _f32(w)).max() <= 2e-2 * np.abs(_f32(w)).max()


def test_forward_through_flash_matches_jax_interpret_flash():
    """The same forward with each package's flash attention as
    attention_fn: the port's (plain versions behind the autograd Function,
    on the CPU) against JAX's Pallas kernels in interpret mode, f32 1e-5."""
    from dstack_tpu.workloads.flash_attention import flash_attention as jflash
    from dstack_tpu_torch.workloads.flash_attention import flash_attention as tflash

    jcfg, tcfg = _cfgs("float32")
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(_to_np(jparams), "cpu")
    tok = _tokens(tcfg, seed=1, b=1)
    want = jtr.forward(jcfg, jparams, jnp.asarray(tok),
                       attention_fn=lambda q, k, v: jflash(q, k, v, interpret=True))
    got = ttr.forward(tcfg, tparams, torch.from_numpy(tok), attention_fn=tflash)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_grads_match_jax_custom_vjp(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32) * 3
    g = rng.standard_normal((3, 7, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jy, vjp = jax.vjp(jtr._silu, jx)
    (jg,) = vjp(jnp.asarray(g, jnp.dtype(dtype)))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ty = ttr._silu(tx)
    (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(tx.dtype),
                                retain_graph=True)
    assert ty.dtype == tx.dtype and tg.dtype == tx.dtype
    _close(ty.detach(), jy, dtype)
    _close(tg, jg, dtype)
    # Backward keeps only the pre-activation, in its own dtype.
    assert [t.dtype for t in ty.grad_fn.saved_tensors] == [tx.dtype]


def test_forward_refuses_moe_and_meshes():
    """An MoE config runs (its forward and router loss equal JAX's, f32
    1e-5; tests/test_torch_moe.py holds the rest); a mesh beyond the
    port's one device is still refused."""
    jcfg, cfg = JPRESETS["tiny-moe"].with_(dtype="float32"), PRESETS["tiny-moe"].with_(
        dtype="float32")
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tok = _tokens(cfg, seed=2, b=1, s=32)
    want, want_aux = jtr.forward(jcfg, jparams, jnp.asarray(tok), return_aux=True)
    got, aux = ttr.forward(cfg, params_from_numpy(_to_np(jparams), "cpu"),
                           torch.from_numpy(tok), return_aux=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5) and float(aux) > 0
    tcfg = PRESETS["tiny"]
    with pytest.raises(NotImplementedError):
        ttr.forward(tcfg, ttr.init_params(tcfg, 0, "cpu"),
                    torch.zeros((1, 4), dtype=torch.int32), mesh=object())
