"""Mixture-of-experts in the PyTorch port against the JAX package on the
CPU (tiny-moe; JAX weights bridged through numpy): routing, both
dispatches and their grads, tests/test_moe.py's own cases mirrored, the
forward with its router loss, init and the int8 bank, the weight bridge,
train steps, the checkpoint, generate, the paged engine at the preset's
capacity factor (pad lanes holding capacity, tokens dropped), speculation
with the int8 MoE drafter, the entry points, and the paths that reach the
shared bodies (LoRA training and serving, disaggregation, RL).

Tolerances: routing indices and slots exact; gate values, dispatch,
combine and aux 1e-6 (f32 softmax and mean in another order); f32 layer
outputs and logits 1e-5; bf16 layer outputs 2e-2 of max |ref| (one bf16
rounding, 2^-8, at other points); f32 grads 1e-5 of each leaf's max;
train-step loss, grad norm and router loss 1e-5 relative, as
tests/test_torch_train.py; every token stream equal token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import generate as jgen
from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads import quant as jquant
from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu_torch.workloads import checkpoint as ckpt
from dstack_tpu_torch.workloads import generate as tgen
from dstack_tpu_torch.workloads import moe as tmoe
from dstack_tpu_torch.workloads import quant as tquant
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads import transformer as ttr
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import (
    flatten_params,
    params_from_numpy,
    train_state_from_numpy,
)

JCFG = JPRESETS["tiny-moe"].with_(dtype="float32")
TCFG = PRESETS["tiny-moe"].with_(dtype="float32")
BF16_REL = 2e-2
ENGINE_KW = dict(slots=4, max_len=96, prefill_chunk_tokens=16, kv_block_size=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(**kw):
    return JCFG.with_(**kw), TCFG.with_(**kw)


def _layer_params(key, dtype="float32", layer=0):
    """One layer's router and expert banks from the JAX init, both sides."""
    jc = JCFG.with_(dtype=dtype)
    p = jtr.init_params(jc, key)["layers"]
    jp = {k: v[layer] for k, v in p.items() if k.startswith(("router", "we_"))}
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def _h(shape, seed=0, dtype="float32"):
    h = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(h, jnp.dtype(dtype)), torch.from_numpy(h).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def weights():
    jp = jtr.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def _drain(q, timeout=120):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return out
        out.append(int(tok))


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


# -- routing -----------------------------------------------------------------


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_route_assignments_and_route_match_jax(cf):
    jc, tc = _cfgs(capacity_factor=cf)
    jp, tp = _layer_params(jax.random.PRNGKey(1))
    jh, th = _h((2, 32, jc.d_model), seed=1)
    jr = jmoe.route_assignments(jc, jh, jp["router"])
    tr = tmoe.route_assignments(tc, th, tp["router"])
    names = ("gate_vals", "gate_idx", "slot", "sel", "aux")
    for name, j, t in zip(names, jr, tr):
        if name in ("gate_idx", "slot"):
            assert t.tolist() == np.asarray(j).tolist(), name
        else:
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=0, atol=1e-6, err_msg=name)
    for j, t in zip(jmoe.route(jc, jh, jp["router"]), tmoe.route(tc, th, tp["router"])):
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=0, atol=1e-6)
    C = tmoe.expert_capacity(tc, 32)
    assert C == jmoe.expert_capacity(jc, 32)
    dropped = int((tr[2] >= C).sum())
    if cf == 0.25:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0


def test_top_k_ties_take_the_lower_expert_index_as_jax():
    """A zero input gives a uniform softmax: every expert ties, and
    lax.top_k takes the lowest indices in order."""
    jc, tc = _cfgs()
    _, tp = _layer_params(jax.random.PRNGKey(1))
    jp, _ = _layer_params(jax.random.PRNGKey(1))
    h = np.zeros((1, 3, jc.d_model), np.float32)
    jr = jmoe.route_assignments(jc, jnp.asarray(h), jp["router"])
    tr = tmoe.route_assignments(tc, torch.from_numpy(h), tp["router"])
    assert tr[1].tolist() == np.asarray(jr[1]).tolist() == [[[0, 1]] * 3]
    assert tr[2].tolist() == np.asarray(jr[2]).tolist()


def test_tf32_router_is_refused_on_the_card(monkeypatch):
    """The router product must be full f32; a CUDA input with TF32 allowed
    raises rather than route on rounded logits (checked before any
    launch, so a fake CUDA tensor shows it)."""

    class FakeCuda:
        is_cuda = True

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        tmoe._router_logits(FakeCuda(), torch.zeros(4, 4))


# -- the layer ----------------------------------------------------------------


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_mlp_matches_jax(impl, dtype, cf):
    jc, tc = _cfgs(capacity_factor=cf, moe_impl=impl, dtype=dtype)
    jp, tp = _layer_params(jax.random.PRNGKey(2), dtype)
    jh, th = _h((2, 16, jc.d_model), seed=2, dtype=dtype)
    jo, ja = jmoe.moe_mlp(jc, jh, jp)
    to, ta = tmoe.moe_mlp(tc, th, tp)
    assert to.dtype == th.dtype and tuple(to.shape) == tuple(jo.shape)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(to), _f32(jo), rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(_f32(to) - _f32(jo)).max() <= BF16_REL * np.abs(_f32(jo)).max()


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_grads_match_jax(impl):
    """Grads of sum(out^2) + aux wrt the router, the banks and the input,
    at cf 1.25 (some tokens dropped), against jax.grad."""
    jc, tc = _cfgs(capacity_factor=1.25, moe_impl=impl)
    jp, tp = _layer_params(jax.random.PRNGKey(3))
    jh, th = _h((2, 16, jc.d_model), seed=3)

    def jloss(p, h):
        out, aux = jmoe.moe_mlp(jc, h, p)
        return jnp.sum(out ** 2) + aux

    jg, jgh = jax.grad(jloss, argnums=(0, 1))(jp, jh)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    th = th.clone().requires_grad_(True)
    out, aux = tmoe.moe_mlp(tc, th, leaves)
    names = sorted(leaves)
    grads = torch.autograd.grad(torch.sum(out ** 2) + aux, [leaves[k] for k in names] + [th])
    for name, g in zip(names + ["h"], grads):
        want = _f32(jgh if name == "h" else jg[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(_f32(g), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_moe_block_matches_jax(weights):
    jp, tp = weights
    jx, tx = _h((2, 9, JCFG.d_model), seed=4)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    jo, ja = jmoe.moe_block(JCFG, jx, jl)
    to, ta = tmoe.moe_block(TCFG, tx, ttr.layer_params(tp, 1))
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=1e-5, atol=1e-5)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)


def test_unknown_moe_impl_raises():
    _, tp = _layer_params(jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.moe_mlp(TCFG.with_(moe_impl="scatter"), torch.zeros(1, 4, TCFG.d_model), tp)


# -- tests/test_moe.py's cases on the port ----------------------------------------


def test_dispatch_combine_shapes_and_capacity():
    c = PRESETS["tiny-moe"]
    _, tp = _layer_params(jax.random.PRNGKey(1), "bfloat16")
    _, th = _h((2, 16, c.d_model), seed=0, dtype="bfloat16")
    dispatch, combine, aux = tmoe.route(c, th, tp["router"])
    C = tmoe.expert_capacity(c, 16)
    assert tuple(dispatch.shape) == (2, 16, c.n_experts, C)
    assert combine.shape == dispatch.shape
    assert float(dispatch.sum(dim=1).max()) <= 1.0 + 1e-6
    assert float(combine.sum(dim=(2, 3)).max()) <= 1.0 + 1e-5
    assert float(aux) > 0.0


def test_moe_matches_dense_reference():
    """At a capacity that drops nothing the einsum layer equals the
    per-token top-k loop (test_moe.py's reference, in torch)."""
    c = PRESETS["tiny-moe"].with_(capacity_factor=8.0)
    _, p = _layer_params(jax.random.PRNGKey(2), "bfloat16")
    _, h = _h((2, 8, c.d_model), seed=5, dtype="bfloat16")
    out, _ = tmoe.moe_mlp(c, h, p)
    probs = torch.softmax(h.float() @ p["router"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, c.experts_per_token, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    def expert_ffn(e, x):
        g = torch.nn.functional.silu((x @ p["we_gate"][e]).float()).to(x.dtype)
        return (g * (x @ p["we_up"][e])) @ p["we_down"][e]

    ref = torch.zeros_like(h)
    for b in range(h.shape[0]):
        for s in range(h.shape[1]):
            acc = torch.zeros(c.d_model)
            for j in range(c.experts_per_token):
                acc += float(gate_vals[b, s, j]) * expert_ffn(int(gate_idx[b, s, j]),
                                                              h[b, s][None]).float()[0]
            ref[b, s] = acc.to(ref.dtype)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0.1, atol=0.05)


def test_capacity_overflow_drops_not_crashes():
    c = PRESETS["tiny-moe"].with_(capacity_factor=0.25)
    _, p = _layer_params(jax.random.PRNGKey(3), "bfloat16")
    _, h = _h((1, 32, c.d_model), seed=6, dtype="bfloat16")
    out, _ = tmoe.moe_mlp(c, h, p)
    assert bool(torch.isfinite(out.float()).all())
    dispatch, _, _ = tmoe.route(c, h, p["router"])
    assert float(dispatch.sum()) < h.shape[0] * h.shape[1] * c.experts_per_token


@pytest.mark.parametrize("cf,shape", [(8.0, (2, 16)), (0.25, (1, 32))])
def test_gather_matches_einsum(cf, shape):
    c = PRESETS["tiny-moe"].with_(capacity_factor=cf)
    _, p = _layer_params(jax.random.PRNGKey(11), "bfloat16")
    _, h = _h(shape + (c.d_model,), seed=7, dtype="bfloat16")
    out_e, aux_e = tmoe.moe_mlp(c, h, p)
    out_g, aux_g = tmoe.moe_mlp(c.with_(moe_impl="gather"), h, p)
    # The einsum path rounds the gate to bf16; the gather path keeps f32.
    np.testing.assert_allclose(_f32(out_e), _f32(out_g), rtol=2e-2, atol=2e-3)
    assert float(aux_e) == float(aux_g)


def test_gather_gradients_match_einsum():
    """bf16, cf 1.0: the banks' grads elementwise within bf16 rounding, the
    router's (all through the gate, rounded to bf16 on the einsum path)
    by relative L2, as tests/test_moe.py holds JAX's two paths."""
    c = PRESETS["tiny-moe"].with_(capacity_factor=1.0)
    _, p = _layer_params(jax.random.PRNGKey(13), "bfloat16")
    _, h = _h((2, 16, c.d_model), seed=8, dtype="bfloat16")
    grads = {}
    for impl in ("einsum", "gather"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        out, aux = tmoe.moe_mlp(c.with_(moe_impl=impl), h, leaves)
        loss = torch.sum(out.float() ** 2) + aux
        grads[impl] = dict(zip(sorted(leaves), torch.autograd.grad(
            loss, [leaves[k] for k in sorted(leaves)])))
    for k in ("we_gate", "we_up", "we_down"):
        np.testing.assert_allclose(_f32(grads["einsum"][k]), _f32(grads["gather"][k]),
                                   rtol=1e-1, atol=1e-1)
    re_, rg = _f32(grads["einsum"]["router"]), _f32(grads["gather"]["router"])
    assert np.linalg.norm(re_ - rg) / max(np.linalg.norm(re_), 1e-9) < 0.05


def test_forward_returns_aux_as_jax():
    """test_moe.py's all-zero tokens (identical rows, one routing for
    every token), bf16, against the JAX forward's aux and logits."""
    jc, tc = JPRESETS["tiny-moe"], PRESETS["tiny-moe"]
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    tokens = np.zeros((2, 16), np.int32)
    jl, ja = jtr.forward(jc, jp, jnp.asarray(tokens), return_aux=True)
    tl, ta = ttr.forward(tc, tp, torch.from_numpy(tokens), return_aux=True)
    assert tuple(tl.shape) == (2, 16, tc.vocab_size) and float(ta) > 0.0
    # bf16: the router reads hidden states rounded at other points.
    assert float(ta) == pytest.approx(float(ja), rel=BF16_REL)
    assert np.abs(_f32(tl) - _f32(jl)).max() <= BF16_REL * np.abs(_f32(jl)).max()


def test_train_step_single_device():
    c = PRESETS["tiny-moe"]
    state = ttrain.init_train_state(c, seed=0, device="cpu")
    batch = ttrain.synthetic_batch(c, batch_size=2, seq_len=32, device="cpu")
    state, metrics = ttrain.make_train_step(c)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["router_aux"]) > 0.0
    assert state.step == 1


def test_an_expert_mesh_is_refused():
    """An expert axis without ranks is refused; over ranks it builds a
    serving mesh (the engine serves on it, tests/test_torch_serving_expert.py)
    and a training mesh (tests/test_torch_expert_parallel.py). An engine
    refuses an expert axis that does not divide the experts."""
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.sharding import AXES, Mesh, make_mesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        make_mesh(["cpu"], expert=2)
    mesh = Mesh(torch.device("cpu"), dict(zip(AXES, (1, 1, 1, 1, 2))), group=object(),
                backend="gloo")
    assert mesh.ranked and not mesh.training
    c = PRESETS["tiny-moe"]
    odd = Mesh(torch.device("cpu"), dict(zip(AXES, (1, 1, 1, 1, c.n_experts + 1))),
               group=object(), backend="gloo")
    with pytest.raises(ValueError, match="must divide the target's n_experts"):
        ServingEngine(c, ttr.init_params(c, 0, "cpu"), mesh=odd, slots=2, max_len=64)


def test_decode_matches_forward():
    """Greedy decode through the dense KV cache equals argmax over the
    plain forward at every step, at a capacity that admits every token."""
    c = PRESETS["tiny-moe"].with_(capacity_factor=8.0)
    params = ttr.init_params(c, 0, "cpu")
    prompt = torch.tensor([[5, 7, 11, 13]], dtype=torch.int32)
    new = tgen.generate(c, params, prompt, max_new_tokens=4, temperature=0.0)
    assert tuple(new.shape) == (1, 4)
    seq = prompt
    for t in range(4):
        greedy = int(ttr.forward(c, params, seq)[0, -1].argmax())
        assert int(new[0, t]) == greedy, f"step {t}"
        seq = torch.cat([seq, new[:, t:t + 1]], dim=1)


# -- the model ------------------------------------------------------------------


def test_init_params_matches_the_reference_layout():
    jp = jtr.init_params(JPRESETS["tiny-moe"], jax.random.PRNGKey(0))
    tp = ttr.init_params(PRESETS["tiny-moe"], seed=0, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flatten_params(_np_tree(jp))}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten_params(tp)}
    assert got == want
    c = PRESETS["tiny-moe"]
    assert "w_gate" not in tp["layers"] and tp["layers"]["router"].dtype == torch.float32
    for k, fan_in in (("router", c.d_model), ("we_gate", c.d_model), ("we_down", c.d_ff)):
        std = float(tp["layers"][k].float().std())
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_aux_match_jax(dtype):
    jc, tc = _cfgs(dtype=dtype)
    jp = jtr.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    tok = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 64)).astype(np.int32)
    jl, ja = jtr.forward(jc, jp, jnp.asarray(tok), return_aux=True)
    tl, ta = ttr.forward(tc, tp, torch.from_numpy(tok), return_aux=True)
    assert tl.dtype == torch.float32
    assert float(ta) == pytest.approx(float(ja), rel=1e-5 if dtype == "float32" else BF16_REL)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(_f32(tl) - _f32(jl)).max() <= BF16_REL * np.abs(_f32(jl)).max()


def test_quantized_moe_forward_matches_jax(weights):
    """int8 expert banks dequantize to the activation dtype before the
    products, as the reference's `_expert_ffn`."""
    jp, tp = weights
    jq, tq = jquant.quantize_params(jp), tquant.quantize_params(tp)
    for k in ("we_gate", "we_up", "we_down"):
        assert isinstance(tq["layers"][k], tquant.QTensor)
        assert tq["layers"][k].q.tolist() == np.asarray(jq["layers"][k].q).tolist()
    assert not isinstance(tq["layers"]["router"], tquant.QTensor)
    tok = np.random.default_rng(2).integers(0, TCFG.vocab_size, (2, 32)).astype(np.int32)
    want = jtr.forward(JCFG, jq, jnp.asarray(tok))
    got = ttr.forward(TCFG, tq, torch.from_numpy(tok))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_layer_slices_cut_an_expert_qtensor_on_its_layer_dim(weights):
    _, tp = weights
    tq = tquant.quantize_params(tp)
    L, E, D, F = TCFG.n_layers, TCFG.n_experts, TCFG.d_model, TCFG.d_ff
    bank = tq["layers"]["we_gate"]
    assert tuple(bank.q.shape) == (L, E, D, F) and tuple(bank.scale.shape) == (L, E, 1, F)
    slices = ttr._layer_slices(tq, L)
    for i in range(L):
        for w in (ttr.layer_params(tq, i)["we_gate"], slices[i]["we_gate"]):
            assert isinstance(w, tquant.QTensor)
            assert tuple(w.q.shape) == (E, D, F) and tuple(w.scale.shape) == (E, 1, F)
            assert torch.equal(w.q, bank.q[i]) and torch.equal(w.scale, bank.scale[i])


def test_bridge_carries_moe_params_and_train_state_bit_for_bit():
    jstate = jtrain.init_train_state(JCFG, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(_np_tree(jstate), "cpu")
    for group, jtree, ttree in (("params", jstate.params, tstate.params),
                                ("mu", jstate.opt_state[0].mu, tstate.opt_state.mu),
                                ("nu", jstate.opt_state[0].nu, tstate.opt_state.nu)):
        want = dict(flatten_params(_np_tree(jtree)))
        got = dict(flatten_params(ttree))
        assert sorted(got) == sorted(want), group
        assert "layers/we_down" in got and "layers/router" in got
        for k, w in want.items():
            assert _f32(got[k]).tobytes() == np.asarray(w, np.float32).tobytes(), (group, k)


def _batch(seed, b=4, s=64):
    tok = np.random.default_rng(seed).integers(0, TCFG.vocab_size, (b, s + 1)).astype(np.int32)
    return ({"inputs": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])},
            {"inputs": torch.from_numpy(tok[:, :-1].copy()),
             "targets": torch.from_numpy(tok[:, 1:].copy())})


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_three_train_steps_match_jax(impl):
    jc, tc = _cfgs(moe_impl=impl)
    jstate = jtrain.init_train_state(jc, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(_np_tree(jstate), "cpu")
    jstep, tstep = jtrain.make_train_step(jc), ttrain.make_train_step(tc)
    for i in range(3):
        jb, tb = _batch(10 + i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for k in ("loss", "grad_norm", "router_aux"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), (i, k)
    assert float(tm["router_aux"]) > 0.0


def test_checkpoint_round_trip_and_resume_bit_for_bit(tmp_path):
    """An MoE train state saved at step 2 of 4 restores bit for bit into a
    template from another seed, and the resumed run equals the unbroken
    one bit for bit (losses, router losses, params)."""
    step = ttrain.make_train_step(TCFG)
    # tests/test_torch_checkpoint.py's batch (2 x 32): at 4 x 64 two
    # identical CPU runs differ in the last bits, dense tiny as well.
    batches = [_batch(20 + i, b=2, s=32)[1] for i in range(4)]

    def run(state, start, stop):
        seen = []
        for b in batches[start:stop]:
            state, m = step(state, b)
            seen.append((float(m["loss"]), float(m["router_aux"])))
        return state, seen

    def bits(state):
        return {k: _f32(t).tobytes() for k, t in flatten_params(state.params)}

    try:
        unbroken, want = run(ttrain.init_train_state(TCFG, 0, "cpu"), 0, 4)
        first, seen = run(ttrain.init_train_state(TCFG, 0, "cpu"), 0, 2)
        ckpt.save(tmp_path, first, wait=True)
        saved = bits(first)
        del first
        resumed = ckpt.restore_latest(tmp_path, ttrain.init_train_state(TCFG, 5, "cpu"))
        assert resumed.step == 2 and bits(resumed) == saved
        assert "layers/we_gate" in saved and "layers/router" in saved
        resumed, more = run(resumed, 2, 4)
    finally:
        ckpt.close_all()
    assert seen + more == want
    assert bits(resumed) == bits(unbroken)


# -- generation and serving --------------------------------------------------------


@pytest.fixture(scope="module")
def weights8():
    jc, _ = _cfgs(capacity_factor=8.0)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def test_generate_matches_jax_token_for_token(weights8):
    jc, tc = _cfgs(capacity_factor=8.0)
    jp, tp = weights8
    prompt = np.asarray([_prompt(1, 9), _prompt(2, 9)], np.int32)
    want = jgen.generate(jc, jp, jnp.asarray(prompt), max_new_tokens=12)
    got = tgen.generate(tc, tp, torch.from_numpy(prompt), max_new_tokens=12)
    assert got.tolist() == np.asarray(want).tolist()


# Lengths 5 and 21 leave pad lanes in their last chunk (buckets 8 and 8
# after a 16-token chunk), 27 and 41 cross the 16-token chunk and the
# 8-token block, and the two 24-token-prefix sharers hit the prefix cache.
PREFIX = _prompt(7, 24)
REQUESTS = [(_prompt(1, 5), 9), (_prompt(2, 27), 8), (PREFIX + [3, 5], 6),
            (_prompt(3, 41), 7), (PREFIX + [11, 13, 17], 6), (_prompt(5, 21), 5)]


def _serve(engine, waves):
    out = []
    for wave in waves:
        qs = [engine.submit(p, max_new_tokens=n, temperature=0.0) for p, n in wave]
        out += [_drain(q) for q in qs]
    return out


@pytest.fixture
def route_log(monkeypatch):
    """(seq_len, capacity, dropped choices) of every routed chunk of more
    than one row, from the port's route_assignments."""
    log = []
    real = tmoe.route_assignments

    def spy(c, h, router, mesh=None):
        out = real(c, h, router, mesh)
        if h.shape[1] > 1:
            C = tmoe.expert_capacity(c, h.shape[1])
            log.append((h.shape[1], C, int((out[2] >= C).sum())))
        return out

    monkeypatch.setattr(tmoe, "route_assignments", spy)
    return log


def test_engine_streams_match_the_jax_engine_with_pad_lanes_and_drops(weights, route_log):
    """tiny-moe at the preset's cf 1.25 through the paged engine: chunks
    padded to pow-2 buckets whose pad lanes route and hold capacity, and
    choices dropped; every stream equals the JAX engine's token for
    token, with the same block accounting."""
    jp, tp = weights
    waves = [REQUESTS[:4], REQUESTS[4:]]
    je = jsrv.ServingEngine(JCFG, jp, **ENGINE_KW)
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", **ENGINE_KW)
    try:
        want = _serve(je, waves)
        got = _serve(te, waves)
        jst, tst = je.stats(), te.stats()
    finally:
        je.close()
        te.close()
    assert got == want
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    for key in ("prefix_cache_hits_total", "prefix_tokens_reused_total",
                "prefill_chunks_total", "kv_blocks_in_use", "kv_blocks_cached"):
        assert tst[key] == jst[key], key
    assert tst["prefix_cache_hits_total"] >= 1
    lengths = {s for s, _, _ in route_log}
    assert 8 in lengths and 16 in lengths            # a padded bucket and a full chunk
    assert sum(d for _, _, d in route_log) > 0        # drops happened


def test_spec_engine_with_the_int8_moe_drafter_matches_jax(weights):
    """Speculation with the default drafter (the int8 quantization of the
    MoE target, its banks dequantized in the layer) against the JAX spec
    engine, token for token, with rounds accepted."""
    jp, tp = weights
    kw = dict(ENGINE_KW, spec_max_draft=3)
    je = jsrv.ServingEngine(JCFG, jp, spec_enable=True, **kw)
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", spec_enable=True, **kw)
    reqs = [REQUESTS[:3]]
    try:
        want = _serve(je, reqs)
        got = _serve(te, reqs)
        jst, tst = je.stats(), te.stats()
    finally:
        je.close()
        te.close()
    assert got == want
    assert tst["spec_rounds_total"] > 0 and tst["spec_tokens_accepted_total"] > 0
    for key in ("spec_rounds_total", "spec_tokens_proposed_total",
                "spec_tokens_accepted_total"):
        assert tst[key] == jst[key], key


# -- entry points --------------------------------------------------------------------


def test_fine_tune_trains_tiny_moe_and_refuses_expert_parallel(capsys):
    from dstack_tpu_torch import fine_tune

    fine_tune.main(["--device", "cpu", "--preset", "tiny-moe", "--steps", "2",
                    "--batch-size", "2", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "step 1: loss" in out and "router_aux" in out and "training complete" in out
    # Expert parallelism trains (tests/test_torch_expert_parallel.py), and
    # so does LoRA over an expert mesh (tests/test_torch_lora_ranks.py).
    fine_tune.main(["--device", "cpu", "--preset", "tiny-moe", "--steps", "2",
                    "--batch-size", "2", "--seq-len", "32", "--expert-parallel", "2",
                    "--lora-rank", "4"])
    out = capsys.readouterr().out
    assert "2 ranks over gloo (expert 2), LoRA rank 4" in out and "training complete" in out


def test_native_server_engine_serves_tiny_moe():
    from dstack_tpu_torch.native_server import Engine

    eng = Engine("tiny-moe", 4, device="cpu", spec_enable=True)
    try:
        usage = {}
        eng.chat([{"role": "user", "content": "hi"}], max_tokens=4, temperature=0.0,
                 usage_out=usage)
        assert usage["completion_tokens"] == 4
        assert eng.serving.stats()["spec_rounds_total"] > 0
    finally:
        eng.serving.close()


# -- the paths that reach the shared bodies ---------------------------------------------


def test_lora_step_on_moe_matches_jax(weights):
    """A LoRA step over a frozen MoE base (adapters on wq/wv; the expert
    banks stay frozen) against JAX's, from one JAX init."""
    from dstack_tpu.workloads import lora as jlora
    from dstack_tpu_torch.workloads import lora as tlora
    from dstack_tpu_torch.workloads.weights import lora_state_from_numpy

    jp, tp = weights
    jstate = jlora.init_lora_state(JCFG, jp, jax.random.PRNGKey(1), rank=4)
    tstate = lora_state_from_numpy(_np_tree(jstate), "cpu")
    jstep = jlora.make_lora_train_step(JCFG, rank=4)
    tstep = tlora.make_lora_train_step(TCFG, rank=4)
    for i in range(2):
        jb, tb = _batch(30 + i)
        jstate, jm = jstep(jstate, jp, jb)
        tstate, tm = tstep(tstate, tp, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), i
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5), i
    want = dict(flatten_params(_np_tree(jstate.lora)))
    for k, t in flatten_params(tstate.lora):
        np.testing.assert_allclose(_f32(t), want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_lora_engine_on_moe_matches_the_jax_lora_engine(weights):
    """Two tenants and the base in one batch on an MoE model, token for
    token against the JAX batched LoRA engine."""
    from dstack_tpu.workloads import lora_serving as jls
    from dstack_tpu_torch.workloads.weights import lora_from_numpy

    jp, tp = weights
    kw = dict(ENGINE_KW, lora_max_adapters=2, lora_rank=4, lora_targets=("wq", "wv"))
    je = jsrv.ServingEngine(JCFG, jp, **kw)
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", **kw)
    reqs = [(_prompt(1, 27), "t1"), (_prompt(2, 27), "t2"), (_prompt(3, 27), None)]
    try:
        for name, seed in (("t1", 11), ("t2", 22)):
            ja = jls.demo_adapter(JCFG, jp, jax.random.PRNGKey(seed), rank=4,
                                  targets=("wq", "wv"))
            je.load_adapter(name, ja)
            te.load_adapter(name, lora_from_numpy(_np_tree(ja), "cpu"))
        want = [_drain(q) for q in [je.submit(p, max_new_tokens=8, temperature=0.0,
                                              adapter=a) for p, a in reqs]]
        got = [_drain(q) for q in [te.submit(p, max_new_tokens=8, temperature=0.0,
                                             adapter=a) for p, a in reqs]]
    finally:
        je.close()
        te.close()
    assert got == want
    assert got[0] != got[2] or got[1] != got[2]


class _Bridge:
    """In-process stand-in for the KV-transfer client: stamps the decode
    engine's live epoch and hands the prefill over directly."""

    def __init__(self, engine):
        self.engine, self.outs = engine, {}

    def send(self, h):
        h = h._replace(epoch=self.engine.handoff_epoch)
        self.outs[h.request_id] = self.engine.submit_prefilled(h)


def _split_streams(make, scenarios):
    """scenarios through a prefill engine and a decode engine from
    `make(role, **kw)`; the streams, one-token requests from the prefill
    side."""
    dec = make("decode")
    bridge = _Bridge(dec)
    pre = make("prefill", kv_transfer=bridge)
    try:
        outs = [pre.submit(p, b, temperature=0.0, request_id=i)
                for i, (p, b) in enumerate(scenarios)]
        got = {i: _drain(out) for i, out in enumerate(outs)}
        got.update({rid: _drain(out) for rid, out in bridge.outs.items()})
        sent = pre.stats()["kv_handoffs_sent_total"]
    finally:
        pre.close()
        dec.close()
    return [got[i] for i in range(len(scenarios))], sent


def test_disaggregated_moe_matches_the_jax_split(weights):
    """The port's prefill and decode roles on an MoE model against the JAX
    package's, both joined in process. At cf 1.25 a split and a unified
    engine differ in both packages: a chunk's pad lanes attend the slot's
    block beyond the prompt, whose stale rows depend on which blocks the
    tier recycled, and their routing takes capacity from real tokens."""
    jp, tp = weights
    kw = dict(slots=4, max_len=128, kv_block_size=16, prefill_chunk_tokens=32)
    scenarios = [(list(range(1, 30)), 12), (list(range(5, 42)), 9), (list(range(7, 24)), 1)]
    want, jsent = _split_streams(
        lambda role, **k: jsrv.ServingEngine(JCFG, jp, role=role, **kw, **k), scenarios)
    got, tsent = _split_streams(
        lambda role, **k: tsrv.ServingEngine(TCFG, tp, device="cpu", role=role, **kw, **k),
        scenarios)
    assert got == want
    assert tsent == jsent == 2


def test_rl_scorer_and_ppo_step_on_moe_match_jax():
    """The RL policy as a small MoE: the sequence scorer and one PPO step
    (the flash path's plain version on the CPU) against JAX's."""
    from dstack_tpu.workloads import rl as jrl
    from dstack_tpu_torch.workloads import rl as trl

    jc = jrl.tiny_rl_config(n_experts=4, experts_per_token=2)
    tc = trl.tiny_rl_config(n_experts=4, experts_per_token=2)
    jstate = jrl.init_rl_state(jc, jax.random.PRNGKey(0), learning_rate=1e-2)
    tstate = train_state_from_numpy(_np_tree(jstate), "cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, 64, (4, 10)).astype(np.int32)
    want = np.asarray(jrl.make_sequence_scorer(jc)(jstate.params, jnp.asarray(tokens),
                                                   jnp.float32(1.0)))
    got = trl.make_sequence_scorer(tc)(tstate.params, torch.from_numpy(tokens), 1.0)
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)
    batch = {"tokens": tokens,
             "behavior_logprob": (want[:, 3:] + 0.3 * rng.standard_normal((4, 6))
                                  ).astype(np.float32),
             "advantage": rng.standard_normal((4, 6)).astype(np.float32),
             "mask": np.ones((4, 6), np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["temperature"] = jnp.float32(1.0)
    _, jm = jrl.make_rl_train_step(jc, learning_rate=1e-2)(jstate, jb)
    _, tm = trl.make_rl_train_step(tc, learning_rate=1e-2)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "pg_loss", "entropy", "clip_fraction", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k


def test_adamw_updates_a_large_leaf_in_slices_bit_for_bit(monkeypatch):
    """An MoE expert bank is one leaf of L x E x D x F elements; AdamW cuts
    it into slices of its leading dim so its f32 temporaries stay small.
    The update is elementwise: sliced and whole give the same bits."""
    state = ttrain.init_train_state(TCFG, seed=0, device="cpu")
    grads = {k: torch.randn_like(v, generator=torch.Generator().manual_seed(i))
             for i, (k, v) in enumerate(flatten_params(state.params))}
    from dstack_tpu_torch.workloads.weights import unflatten_params

    results = []
    for cap in (1 << 40, 1000):
        monkeypatch.setattr(ttrain, "_SLICE_ELEMS", cap)
        st = ttrain.init_train_state(TCFG, seed=0, device="cpu")
        opt = ttrain.make_optimizer()
        new = opt.apply(st.params, unflatten_params(grads.items()), st.opt_state)
        results.append({k: (_f32(v).tobytes(), _f32(m).tobytes())
                        for (k, v), (_, m) in zip(flatten_params(st.params),
                                                  flatten_params(new.mu))})
    assert len(list(ttrain._slices(state.params["layers"]["we_gate"]))) == TCFG.n_layers
    assert results[0] == results[1]
