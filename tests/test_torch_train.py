"""The port's training slice against the JAX package on the CPU: loss_fn,
make_train_step (AdamW, warmup-cosine schedule, gradient accumulation,
chunked CE), the remat rungs, resolve_remat, the packed export both ways,
the data loader and the fine_tune entry point. Same numpy inputs and
bridged JAX weights on both sides.

Tolerances: f32 loss and grad_norm 1e-5 relative (summation order);
params after 1 and 3 AdamW steps 1e-5 absolute (lr 3e-4: Adam's
normalised step turns a relative grad difference into the same relative
difference of a step of ~lr, so 1e-5 is ~3% of one step, loose only where
|g| is near eps); bf16 2e-2 relative on loss, grad_norm and grads (bf16
rounds at other places in the two frameworks), params 2e-3 absolute;
packed exports and data rows bit-exact."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import checkpoint as jckpt
from dstack_tpu.workloads import data as jdata
from dstack_tpu.workloads import quant as jquant
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu_torch.workloads import data as tdata
from dstack_tpu_torch.workloads import quant as tquant
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import (
    flatten_params,
    load_packed,
    params_from_numpy,
    save_packed,
    unflatten_params,
)

B, S = 4, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(seed, vocab):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    jb = {"inputs": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])}
    tb = {"inputs": torch.from_numpy(tok[:, :-1].copy()),
          "targets": torch.from_numpy(tok[:, 1:].copy())}
    return jb, tb


def _init(dtype, **cfg_kw):
    jcfg = JPRESETS["tiny"].with_(dtype=dtype, **cfg_kw)
    tcfg = PRESETS["tiny"].with_(dtype=dtype, **cfg_kw)
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, _np_tree(jparams)


def _assert_tree_close(tparams, jparams_np, rtol, atol):
    jl = dict(flatten_params(jparams_np))
    tl = dict(flatten_params(tparams))
    assert sorted(jl) == sorted(tl)
    for name, j in jl.items():
        np.testing.assert_allclose(_f32(tl[name]), np.asarray(j, np.float32),
                                   rtol=rtol, atol=atol, err_msg=name)


# (dtype, cfg kwargs, step kwargs, rtol, param atol)
RUNS = {
    "f32_schedule_accum_chunked": (
        "float32", {"ce_chunk": 32},
        {"accum_steps": 2, "warmup_steps": 2, "decay_steps": 5}, 1e-5, 1e-5),
    "bf16": ("bfloat16", {}, {}, 2e-2, 2e-3),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def trained(request):
    """Three train steps in both packages from the same params and batches;
    the JAX trajectory is kept as numpy after every step."""
    dtype, cfg_kw, step_kw, rtol, atol = RUNS[request.param]
    jcfg, tcfg, jparams, np_params = _init(dtype, **cfg_kw)
    jstate = jtrain.TrainState(
        jnp.zeros((), jnp.int32), jparams,
        jtrain.make_optimizer(3e-4, **{k: v for k, v in step_kw.items()
                                       if k != "accum_steps"}).init(jparams))
    jstep = jtrain.make_train_step(jcfg, **step_kw)
    tstate = ttrain.init_train_state(
        tcfg, device="cpu", params=params_from_numpy(np_params, "cpu"),
        **{k: v for k, v in step_kw.items() if k != "accum_steps"})
    tstep = ttrain.make_train_step(tcfg, **step_kw)
    out = []
    for i in range(3):
        jb, tb = _batch(10 + i, tcfg.vocab_size)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        out.append((_np_tree(jstate.params), jax.tree_util.tree_map(float, jm),
                    {k: float(v) for k, v in tm.items()},
                    {k: v.detach().clone() for k, v in flatten_params(tstate.params)},
                    _np_tree(jstate.opt_state), tstate.opt_state))
    return request.param, rtol, atol, out, tstate


def test_train_step_loss_and_grad_norm_match_jax(trained):
    _, rtol, _, out, tstate = trained
    for _, jm, tm, _, _, _ in out:
        assert tm["loss"] == pytest.approx(jm["loss"], rel=rtol)
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=rtol)
        assert tm["router_aux"] == 0.0 == jm["router_aux"]
    assert tstate.step == 3 and tstate.opt_state.count == 3


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_params_match_jax(trained, after):
    _, rtol, atol, out, _ = trained
    jparams, _, _, tparams, _, _ = out[after - 1]
    _assert_tree_close(unflatten_params(tparams.items()), jparams, rtol, atol)


def test_optimizer_moments_match_optax_dtypes_and_values(trained):
    """mu is f32 and nu in the param dtype, as optax keeps them, and both
    hold optax's values after three steps (relative norm of the difference
    per leaf: elementwise, bf16 grads differ by their rounding points)."""
    _, rtol, _, out, _ = trained
    *_, jopt, topt = out[-1]
    adam = jopt[0]
    for tree_t, tree_j in ((topt.mu, adam.mu), (topt.nu, adam.nu)):
        jl = dict(flatten_params(tree_j))
        for path, t in flatten_params(tree_t):
            assert str(t.dtype).replace("torch.", "") == str(jl[path].dtype), path
            want = np.asarray(jl[path], np.float32)
            err = np.linalg.norm(_f32(t) - want) / max(np.linalg.norm(want), 1e-30)
            assert err < rtol, (path, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    jcfg, tcfg, jparams, np_params = _init(dtype)
    jb, tb = _batch(3, tcfg.vocab_size)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(jcfg, p, jb), has_aux=True)(jparams)
    tparams = params_from_numpy(np_params, "cpu")
    pairs = flatten_params(tparams)
    for _, p in pairs:
        p.requires_grad_(True)
    tloss, _ = ttrain.loss_fn(tcfg, tparams, tb)
    grads = torch.autograd.grad(tloss, [p for _, p in pairs])
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=tol)
    jl = dict(flatten_params(_np_tree(jgrads)))
    for (path, _), g in zip(pairs, grads):
        want = np.asarray(jl[path], np.float32)
        assert g.dtype == getattr(torch, str(jl[path].dtype)), path
        err = np.linalg.norm(_f32(g) - want) / max(np.linalg.norm(want), 1e-30)
        assert err < tol, (path, err)


def test_remat_rungs_give_equal_loss_and_grads():
    """"none", "dots" (selective: matmul outputs saved) and "full" compute
    the same function; only what is saved for backward differs."""
    results = {}
    _, _, _, np_params = _init("float32")
    tb = _batch(5, 512)[1]
    for remat in ("none", "dots", "full"):
        cfg = PRESETS["tiny"].with_(dtype="float32", remat=remat)
        assert cfg.resolve_remat(B * S, seq_len=S) == remat
        params = params_from_numpy(np_params, "cpu")
        pairs = flatten_params(params)
        for _, p in pairs:
            p.requires_grad_(True)
        loss, _ = ttrain.loss_fn(cfg, params, tb)
        grads = torch.autograd.grad(loss, [p for _, p in pairs])
        results[remat] = (float(loss.detach()), grads)
    for remat in ("dots", "full"):
        assert results[remat][0] == pytest.approx(results["none"][0], rel=1e-6)
        for a, b in zip(results[remat][1], results["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("hbm_gb", [None, "16", "2"])
@pytest.mark.parametrize("preset,tokens,seq,attn_scores,ce_chunk", [
    ("smol-1b", 8 * 2048, 2048, False, 0),
    ("smol-1b", 8 * 2048, 2048, True, 0),
    ("smol-1b", 32 * 2048, 2048, False, 512),
    ("llama-8b", 4 * 8192, 8192, False, 0),
    ("tiny", B * S, S, True, 0),
])
def test_resolve_remat_agrees_with_jax(monkeypatch, hbm_gb, preset, tokens, seq,
                                       attn_scores, ce_chunk):
    """Same answer as the reference for the same config, tokens and
    DSTACK_TPU_HBM_GB; unset, the budget is 80 GB (the H100)."""
    monkeypatch.setenv("DSTACK_TPU_HBM_GB", hbm_gb or "80")
    j = JPRESETS[preset].with_(remat="auto", ce_chunk=ce_chunk)
    t = PRESETS[preset].with_(remat="auto", ce_chunk=ce_chunk)
    want = j.resolve_remat(tokens, None, seq_len=seq, attn_scores=attn_scores)
    if hbm_gb is None:
        monkeypatch.delenv("DSTACK_TPU_HBM_GB")
    assert t.resolve_remat(tokens, None, seq_len=seq, attn_scores=attn_scores) == want
    for r in (True, False, "dots", "full", "none"):
        assert t.with_(remat=r).resolve_remat(tokens) == j.with_(remat=r).resolve_remat(tokens)


def test_smol_1b_default_batch_resolves_to_no_remat_on_the_h100():
    assert PRESETS["smol-1b"].resolve_remat(8 * 2048, seq_len=2048) == "none"


def test_schedule_matches_optax():
    opt = ttrain.make_optimizer(3e-4, warmup_steps=3, decay_steps=10)
    import optax

    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 3e-5)
    for count in range(0, 14):
        assert opt.lr(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)
    assert ttrain.make_optimizer(1e-3).lr(7) == 1e-3


# --------------------------------------------------------------- exports


def _flat_bits(tree, prefix=""):
    out = {}
    if isinstance(tree, (tquant.QTensor, jquant.QTensor)):
        return {prefix + ".q": _bits(tree.q), prefix + ".scale": _bits(tree.scale)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_bits(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: _bits(tree)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (str(x.dtype).replace("torch.", ""), tuple(x.shape),
                (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes())
    a = np.asarray(x)
    return (str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_packed_is_byte_identical_and_loads_both_ways(tmp_path, dtype):
    """The port writes the same manifest and weights.bin as the JAX
    save_packed for the same params (plain and int8 QTensor leaves); the JAX
    load_packed reads the port's export and the port's reads JAX's."""
    _, _, jparams, np_params = _init(dtype)
    for kind, jtree in (("plain", jparams), ("int8", jquant.quantize_params(jparams))):
        ttree = params_from_numpy(_np_tree(jtree), "cpu")
        jdir, tdir = tmp_path / f"j_{kind}", tmp_path / f"t_{kind}"
        jckpt.save_packed(jdir, jtree)
        save_packed(tdir, ttree)
        for f in ("manifest.json", "weights.bin"):
            assert (tdir / "packed" / f).read_bytes() == (jdir / "packed" / f).read_bytes(), f
        assert json.loads((tdir / "packed" / "manifest.json").read_text())
        from_port = jckpt.load_packed(tdir, parallel=False)
        assert _flat_bits(from_port) == _flat_bits(jtree)
        from_jax = load_packed(jdir, "cpu")
        assert _flat_bits(from_jax) == _flat_bits(ttree)


# ------------------------------------------------------------------ data


def test_token_dataset_and_loader_match_jax_rows_and_order(tmp_path):
    toks = np.random.default_rng(0).integers(0, 500, 20 * 33 + 7).astype(np.int32)
    path = str(tmp_path / "toks.npy")
    tdata.write_token_file(path, toks)
    jds, tds = jdata.TokenDataset(path, 32), tdata.TokenDataset(path, 32)
    assert tds.n_rows == jds.n_rows == 20
    for epoch in range(3):
        np.testing.assert_array_equal(tds.epoch_order(epoch, 5), jds.epoch_order(epoch, 5))
    jl = jdata.BatchLoader(jds, 6, seed=5, start_step=1, vocab_size=512)
    tl = tdata.BatchLoader(tds, 6, device="cpu", seed=5, start_step=1, vocab_size=512)
    try:
        for _ in range(5):  # crosses an epoch boundary (3 batches per epoch)
            jb, tb = next(jl), next(tl)
            for k in ("inputs", "targets"):
                assert tb[k].dtype == torch.int32 and tb[k].shape == (6, 32)
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    finally:
        jl.close()
        tl.close()
    np.testing.assert_array_equal(tdata.encode_bytes("hé!", 200),
                                  jdata.encode_bytes("hé!", 200))


def test_loader_surfaces_vocab_errors_on_the_consumer(tmp_path):
    path = str(tmp_path / "toks.npy")
    tdata.write_token_file(path, np.full(100, 300, np.int32))
    loader = tdata.BatchLoader(tdata.TokenDataset(path, 9), 2, device="cpu",
                               vocab_size=256)
    with pytest.raises(RuntimeError, match="vocab_size"):
        next(loader)
    loader.close()
    with pytest.raises(ValueError, match="rows"):
        tdata.BatchLoader(tdata.TokenDataset(path, 9), 50, device="cpu")


# ----------------------------------------------------------- entry point


def test_fine_tune_cli_trains_tiny_and_exports_what_native_server_serves(tmp_path, capsys):
    from dstack_tpu_torch import fine_tune
    from dstack_tpu_torch.native_server import Engine

    toks = np.random.default_rng(1).integers(0, 512, 4 * 65 * 3).astype(np.int32)
    data = str(tmp_path / "toks.npy")
    tdata.write_token_file(data, toks)
    fine_tune.main(["--device", "cpu", "--preset", "tiny", "--steps", "3",
                    "--batch-size", "4", "--seq-len", "64", "--accum-steps", "2",
                    "--data", data, "--checkpoint-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "training complete" in out
    eng = Engine("tiny", 4, checkpoint_dir=str(tmp_path / "ckpt"), device="cpu")
    try:
        assert eng.weights_via == "packed"
        assert not eng.params["embed"].requires_grad
        usage = {}
        eng.chat([{"role": "user", "content": "hi"}], max_tokens=3, temperature=0.0,
                 usage_out=usage)
        assert usage["completion_tokens"] == 3
    finally:
        eng.serving.close()


@pytest.mark.parametrize("flag", [["--model-parallel", "2"],
                                  ["--preset", "tiny-moe", "--seq-parallel", "2",
                                   "--expert-parallel", "2"],
                                  ["--expert-parallel", "2"]])
def test_fine_tune_refuses_unported_options(flag, capsys):
    """Options once refused that now train over gloo ranks (rank 0 in this
    process starts the others): --model-parallel 2, --expert-parallel 2
    (the dense model replicated over the expert axis, as the JAX trainer's
    mesh holds it; MoE over it in tests/test_torch_expert_parallel.py), and
    tiny-moe over seq 2 x expert 2 (MoE over a seq axis of ranks; its
    parity with JAX in tests/test_torch_moe_seq_ranks.py)."""
    from dstack_tpu_torch import fine_tune

    fine_tune.main(["--device", "cpu", "--preset", "tiny", "--steps", "2",
                    "--seq-len", "32", "--batch-size", "2", *flag])
    out = capsys.readouterr().out
    mesh = ("4 ranks over gloo (seq 2 x expert 2)" if "--seq-parallel" in flag else
            "2 ranks over gloo (model 2)" if "--model-parallel" in flag else
            "2 ranks over gloo (expert 2)")
    assert mesh in out and "training complete" in out
