"""LoRA training in the PyTorch port against the JAX package on the CPU
(tiny, bridged weights): the cases of tests/test_lora.py one for one
(zero-init identity, tiny adapters, training moves the adapters and not
the base, merged adapters served quantized), `merge_lora`, three LoRA
steps from one JAX init (`lora_state_from_numpy`), the LoRA step over the
4-shard ring against JAX's on a 4-way seq mesh, the LoRA checkpoint (round
trip, resume bit for bit, no cross-format restore), and `fine_tune
--lora-rank` (resume, merged export served by native_server, drain).

Tolerances, and why:
- merge_lora f32: 1e-6 relative per element (f32 rank-8 sums in another
  order). bf16: equal bit for bit (the f32 deltas' last-bit differences
  cross no bf16 rounding point on these inputs: no element differs).
- the LoRA step, f32: loss and grad norm 1e-5 relative, adapter grads 1e-5
  of their largest magnitude, adapters after 1 and 3 AdamW steps 1e-6
  absolute (lr 1e-4: Adam's normalised step is ~lr, so this is ~1% of one
  step, the share test_torch_train.py allows at lr 3e-4), moments 1e-5
  relative norm per leaf as test_torch_train.py holds them.
- the ring: the ring train step's own limits (test_torch_ring.py): loss and
  grad norm 1e-5 relative, each adapter's update 1e-3 relative norm.
- the merged model served int8: token ids equal (the port's quantization
  and decode are held to JAX's token for token elsewhere).
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import lora as jlora
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.sharding import shard_tree
from dstack_tpu_torch.workloads import checkpoint as ckpt
from dstack_tpu_torch.workloads import lora as tlora
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads import transformer as ttr
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.sharding import make_mesh
from dstack_tpu_torch.workloads.weights import (
    flatten_params,
    lora_from_numpy,
    lora_state_from_numpy,
    params_from_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
RANK = 4
B, S = 2, 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(dtype="float32"):
    return (JPRESETS["tiny"].with_(dtype=dtype, remat=False),
            PRESETS["tiny"].with_(dtype=dtype, remat=False))


def _batch(seed, vocab=512, b=B, s=S):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return ({"inputs": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])},
            {"inputs": torch.from_numpy(tok[:, :-1].copy()),
             "targets": torch.from_numpy(tok[:, 1:].copy())})


@pytest.fixture(scope="module")
def bases():
    """One JAX init per dtype, bridged: (jax params, port params)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = _cfgs(dtype)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        out[dtype] = (jp, params_from_numpy(_np_tree(jp), "cpu"))
    return out


# -- tests/test_lora.py, one for one ------------------------------------------


def test_zero_init_is_identity(bases):
    """B = 0: the merged params equal the base bit for bit, so the merged
    forward is the base forward (JAX's test holds it within 1e-5)."""
    _, tcfg = _cfgs("bfloat16")
    _, base = bases["bfloat16"]
    lora = tlora.lora_init(tcfg, base, 1, rank=RANK)
    merged = tlora.merge_lora(base, lora, rank=RANK)
    for t in tlora.DEFAULT_TARGETS:
        assert torch.equal(merged["layers"][t], base["layers"][t])
    tokens = torch.tensor([[3, 5, 7, 11]])
    assert torch.equal(ttr.forward(tcfg, merged, tokens), ttr.forward(tcfg, base, tokens))
    # A is N(0, 1) * d_in^-0.5 in the weight's dtype, B is zero.
    a = lora["layers"]["wq_a"]
    assert a.dtype == torch.bfloat16 and a.shape == (tcfg.n_layers, tcfg.d_model, RANK)
    assert float(a.float().std()) == pytest.approx(tcfg.d_model ** -0.5, rel=0.15)
    assert not lora["layers"]["wv_b"].any()


def test_adapters_are_tiny(bases):
    _, tcfg = _cfgs("bfloat16")
    _, base = bases["bfloat16"]
    lora = tlora.lora_init(tcfg, base, 1, rank=RANK)
    base_n = sum(t.numel() for _, t in flatten_params(base))
    assert tlora.lora_param_count(lora) < base_n / 20
    jcfg, _ = _cfgs("bfloat16")
    jl = jlora.lora_init(jcfg, bases["bfloat16"][0], jax.random.PRNGKey(1), rank=RANK)
    assert tlora.lora_param_count(lora) == jlora.lora_param_count(jl)


def test_training_moves_adapters_not_base(bases):
    _, tcfg = _cfgs("bfloat16")
    _, base = bases["bfloat16"]
    before = {k: v.clone() for k, v in flatten_params(base)}
    state = tlora.init_lora_state(tcfg, base, 1, rank=RANK)
    step = tlora.make_lora_train_step(tcfg, rank=RANK)
    batch = ttrain.synthetic_batch(tcfg, 2, 32, device="cpu")
    losses = []
    for _ in range(5):
        state, m = step(state, base, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]  # the adapters learn the fixed batch
    assert state.step == 5 and state.opt_state.count == 5
    for k, v in flatten_params(base):  # the frozen base is bit-identical
        assert torch.equal(v, before[k]), k
        assert v.grad is None
    assert float(state.lora["layers"]["wq_b"].detach().abs().max()) > 0  # B moved off 0


def test_merged_adapters_serve_quantized(bases):
    """LoRA composes with int8 serving: one JAX LoRA step, the state
    bridged, merged and quantized in both packages; greedy generations
    equal token for token."""
    from dstack_tpu.workloads.generate import generate as jgenerate
    from dstack_tpu.workloads.quant import quantize_params as jquantize
    from dstack_tpu_torch.workloads.generate import generate
    from dstack_tpu_torch.workloads.quant import quantize_params

    jcfg, tcfg = _cfgs("float32")
    jp, tp = bases["float32"]
    jstate = jlora.init_lora_state(jcfg, jp, jax.random.PRNGKey(1), rank=RANK)
    jb, _ = _batch(3)
    jstate, _ = jlora.make_lora_train_step(jcfg, rank=RANK)(jstate, jp, jb)
    tstate = lora_state_from_numpy(_np_tree(jstate), "cpu")
    jq = jquantize(jlora.merge_lora(jp, jstate.lora, rank=RANK))
    with torch.no_grad():
        tq = quantize_params(tlora.merge_lora(tp, tstate.lora, rank=RANK))
    prompt = [[3, 5, 7]]
    want = jgenerate(jcfg, jq, jnp.asarray(prompt, jnp.int32), max_new_tokens=4,
                     temperature=0.0)
    got = generate(tcfg, tq, torch.tensor(prompt), max_new_tokens=4)
    assert got.shape == (1, 4) and got.tolist() == np.asarray(want).tolist()


# -- merge_lora -----------------------------------------------------------------


def _random_lora(cfg, seed, dtype):
    rng = np.random.default_rng(seed)
    L, D = cfg.n_layers, cfg.d_model
    out = {}
    for t, d_out in (("wq", cfg.n_heads * cfg.head_dim), ("wv", cfg.n_kv_heads * cfg.head_dim)):
        out[f"{t}_a"] = (rng.standard_normal((L, D, 8)) * D ** -0.5).astype(np.float32)
        out[f"{t}_b"] = (rng.standard_normal((L, 8, d_out)) * 0.05).astype(np.float32)
    jl = {"layers": {k: jnp.asarray(v, dtype) for k, v in out.items()}}
    return jl, lora_from_numpy(_np_tree(jl), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(bases, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = bases[dtype]
    jl, tl = _random_lora(tcfg, 5, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    jm = jlora.merge_lora(jp, jl, rank=8, alpha=16.0)
    tm = tlora.merge_lora(tp, tl, rank=8, alpha=16.0)
    for t in ("wq", "wv"):
        got, want = tm["layers"][t], jm["layers"][t]
        assert got.dtype == tp["layers"][t].dtype
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        else:  # bit for bit
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16)), t
    for k in ("wk", "w_up"):  # the other leaves are the base's own tensors
        assert tm["layers"][k] is tp["layers"][k]


# -- the LoRA step against JAX's ------------------------------------------------


@pytest.fixture(scope="module")
def lora_runs(bases):
    """Three LoRA steps in both packages from one JAX init (bridged by
    lora_state_from_numpy) on the same batches; the first step's loss and
    adapter grads on both sides through the functions the steps use."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = bases["float32"]
    jstate = jlora.init_lora_state(jcfg, jp, jax.random.PRNGKey(1), rank=RANK)
    tstate = lora_state_from_numpy(_np_tree(jstate), "cpu")
    # B = 0 gives A a zero gradient; a nonzero B exercises both leaves.
    jb0, tb0 = _batch(20)
    _, tl = _random_lora(tcfg, 9, jnp.float32)
    probe_np = {k: v.numpy()[..., :RANK] if k.endswith("_a") else v.numpy()[:, :RANK]
                for k, v in tl["layers"].items()}

    def jloss(lora):
        return jtrain.loss_fn(jcfg, jlora.merge_lora(jp, lora, rank=RANK), jb0)[0]

    jl, jg = jax.value_and_grad(jloss)({"layers": {k: jnp.asarray(v)
                                                   for k, v in probe_np.items()}})
    probe = {"layers": {k: torch.from_numpy(v.copy()).requires_grad_(True)
                        for k, v in probe_np.items()}}
    tl_loss, _ = ttrain.loss_fn(tcfg, tlora.merge_lora(tp, probe, rank=RANK), tb0)
    tg = torch.autograd.grad(tl_loss, [probe["layers"][k] for k in sorted(probe_np)])
    grads = (float(jl), _np_tree(jg["layers"]), float(tl_loss.detach()),
             dict(zip(sorted(probe_np), tg)))
    jstep = jlora.make_lora_train_step(jcfg, rank=RANK)
    tstep = tlora.make_lora_train_step(tcfg, rank=RANK)
    steps = []
    for i in range(3):
        jb, tb = _batch(10 + i)
        jstate, jm = jstep(jstate, jp, jb)
        tstate, tm = tstep(tstate, tp, tb)
        steps.append((_np_tree(jstate.lora), {k: float(v) for k, v in jm.items()},
                      {k: float(v) for k, v in tm.items()},
                      {k: v.detach().clone() for k, v in flatten_params(tstate.lora)}))
    return grads, steps, (jstate, tstate)


def test_lora_loss_and_adapter_grads_match_jax(lora_runs):
    (jl, jg, tl, tg), _, _ = lora_runs
    assert tl == pytest.approx(jl, rel=1e-5)
    for k, g in tg.items():
        want = jg[k]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
        assert np.abs(want).max() > 0, k


@pytest.mark.parametrize("after", [0, 2])
def test_lora_steps_match_jax(lora_runs, after):
    _, steps, _ = lora_runs
    jlora_np, jm, tm, tl = steps[after]
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    want = dict(flatten_params(jlora_np))
    assert sorted(want) == sorted(tl)
    for k, v in tl.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)


def test_lora_moments_match_optax(lora_runs):
    _, _, (jstate, tstate) = lora_runs
    adam = [s for s in jstate.opt_state if hasattr(s, "mu")][0]
    assert tstate.opt_state.count == int(adam.count) == 3
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = dict(flatten_params(_np_tree(tree)))
        for k, v in flatten_params(getattr(tstate.opt_state, name)):
            # Relative norm per leaf, as test_torch_train.py holds the full
            # step's moments (f32: 1e-5).
            assert v.dtype == torch.float32
            err = np.linalg.norm(_np(v) - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
            assert err < 1e-5, (name, k, err)


def test_lora_step_over_the_ring_matches_jax_seq_mesh(bases):
    """One LoRA step of tiny over a 4-shard seq mesh (S 64, shards of 16)
    in both packages, from a JAX state whose B is nonzero (so both
    adapters get a gradient): loss, grad norm and each adapter's update."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = bases["float32"]
    jmesh = jmake_mesh(jax.devices()[:4], seq=4)
    jl, _ = _random_lora(tcfg, 13, jnp.float32)
    jl = {"layers": {k: v[..., :RANK] if k.endswith("_a") else v[:, :RANK]
                     for k, v in jl["layers"].items()}}
    jstate = jlora.LoraState(jnp.zeros((), jnp.int32), jl,
                             jtrain.make_optimizer(1e-4).init(jl))
    jstate = shard_tree(jmesh, jstate)
    tstate = lora_state_from_numpy(_np_tree(jstate), "cpu")
    jb, tb = _batch(7, s=64)
    jstate2, jm = jlora.make_lora_train_step(jcfg, jmesh, rank=RANK)(
        jstate, shard_tree(jmesh, jp), jb)
    tmesh = make_mesh(["cpu"], seq=4)
    before = {k: v.detach().clone() for k, v in flatten_params(tstate.lora)}
    tstate2, tm = tlora.make_lora_train_step(tcfg, tmesh, rank=RANK)(tstate, tp, tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = dict(flatten_params(_np_tree(jstate2.lora)))
    for k, v in flatten_params(tstate2.lora):
        upd, upd_want = _np(v) - _np(before[k]), want[k] - _np(before[k])
        rel = np.linalg.norm(upd - upd_want) / np.linalg.norm(upd_want)
        assert rel <= 1e-3, (k, rel)


def test_lora_state_from_numpy_refuses_a_state_without_adam():
    fake = jlora.LoraState(np.int32(0), {"layers": {"wq_a": np.zeros((1, 2, 1))}}, ())
    with pytest.raises(ValueError, match="AdamW"):
        lora_state_from_numpy(fake, "cpu")


# -- the LoRA checkpoint ----------------------------------------------------------


def _lora_run(base, cfg, n, directory=None, start_state=None):
    state = start_state or tlora.init_lora_state(cfg, base, 1, rank=RANK)
    step = tlora.make_lora_train_step(cfg, rank=RANK)
    for i in range(state.step, n):
        _, tb = _batch(30 + i)
        state, _ = step(state, base, tb)
        if directory is not None and state.step == 2:
            ckpt.save(directory, state, wait=True)
    return state


def _bits(state):
    return {k: v.detach().clone() for k, v in ckpt._leaves(state)}


def test_lora_checkpoint_round_trip_and_resume_bit_for_bit(bases, tmp_path):
    _, tcfg = _cfgs("bfloat16")
    _, base = bases["bfloat16"]
    vol = tmp_path / "ckpt"
    unbroken = _lora_run(base, tcfg, 5, directory=vol)
    names = {s["name"].split("/")[0] for s in ckpt.read_manifest(vol / "2")}
    assert names == {"lora", "mu", "nu"}
    fresh = tlora.init_lora_state(tcfg, base, 99, rank=RANK)
    restored = ckpt.restore_latest(vol, fresh)
    assert isinstance(restored, tlora.LoraState)
    assert restored.step == 2 and restored.opt_state.count == 2
    assert restored.lora is fresh.lora  # read into the template in place
    resumed = _lora_run(base, tcfg, 5, start_state=restored)
    want, got = _bits(unbroken), _bits(resumed)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed.step == unbroken.step == 5
    ckpt.close_all()


def test_a_checkpoint_restores_only_into_its_own_kind(bases, tmp_path):
    _, tcfg = _cfgs("bfloat16")
    _, base = bases["bfloat16"]
    lora_dir, full_dir = tmp_path / "lora", tmp_path / "full"
    lstate = tlora.init_lora_state(tcfg, base, 1, rank=RANK)
    ckpt.save(lora_dir, lstate, wait=True)
    fstate = ttrain.init_train_state(tcfg, 0, "cpu")
    ckpt.save(full_dir, fstate, wait=True)
    with pytest.raises(ValueError, match="does not match the template"):
        ckpt.restore_latest(lora_dir, ttrain.init_train_state(tcfg, 0, "cpu"))
    with pytest.raises(ValueError, match="does not match the template"):
        ckpt.restore_latest(full_dir, tlora.init_lora_state(tcfg, base, 1, rank=RANK))
    # A serving host finds no params in an adapter checkpoint.
    assert ckpt.restore_latest_params(lora_dir, "cpu") is None
    ckpt.close_all()


# -- fine_tune --lora-rank ----------------------------------------------------------


def test_fine_tune_lora_resumes_and_its_merged_export_serves(tmp_path, capsys):
    """Base from seed 0, adapters from a generator seeded at 1: the run
    saves adapter checkpoints, a second run resumes, and the export is
    merge_lora(base, adapters), which native_server serves."""
    from dstack_tpu_torch import fine_tune
    from dstack_tpu_torch.native_server import Engine
    from dstack_tpu_torch.workloads.weights import load_packed

    vol = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--preset", "tiny", "--batch-size", "2", "--seq-len", "32",
            "--lora-rank", str(RANK), "--checkpoint-dir", vol]
    fine_tune.main(argv + ["--steps", "2"])
    fine_tune.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "LoRA rank 4 on wq/wv" in out and "resumed from step 2" in out
    assert "step 3: loss" in out and out.count("training complete") == 2
    cfg = PRESETS["tiny"]
    base = ttr.init_params(cfg, 0, "cpu")
    state = ckpt.restore_latest(vol, tlora.init_lora_state(cfg, base, 5, rank=RANK))
    assert state.step == 4
    with torch.no_grad():
        merged = tlora.merge_lora(base, state.lora, rank=RANK)
    exported = load_packed(vol, "cpu")
    for k, v in flatten_params(merged):
        assert torch.equal(dict(flatten_params(exported))[k], v), k
    assert not torch.equal(exported["layers"]["wq"], base["layers"]["wq"])
    eng = Engine("tiny", 4, checkpoint_dir=vol, device="cpu")
    try:
        assert eng.weights_via == "packed"
        usage = {}
        eng.chat([{"role": "user", "content": "hi"}], max_tokens=3, temperature=0.0,
                 usage_out=usage)
        assert usage["completion_tokens"] == 3
    finally:
        eng.serving.close()
    ckpt.close_all()


def test_fine_tune_lora_refuses_gradient_accumulation():
    from dstack_tpu_torch import fine_tune

    with pytest.raises(NotImplementedError, match="accum-steps 2 with --lora-rank"):
        fine_tune.main(["--device", "cpu", "--preset", "tiny", "--lora-rank", "4",
                        "--accum-steps", "2"])


def test_fine_tune_lora_drains_on_sigterm_and_resumes(tmp_path):
    """A subprocess `fine_tune --lora-rank 4` SIGTERMed after its first
    step exits 113 with an adapter checkpoint at the step it finished; a
    relaunch resumes there."""
    vol = str(tmp_path / "ckpt")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
           "--preset", "tiny", "--batch-size", "2", "--seq-len", "32",
           "--lora-rank", str(RANK), "--checkpoint-dir", vol]
    proc = subprocess.Popen(cmd + ["--steps", "100000"], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("step 0:"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += rest.splitlines()
    assert proc.returncode == 113, lines
    drained = [x for x in lines if x.startswith("drain: checkpoint saved at step")]
    assert drained, lines
    at = int(drained[0].split()[5])
    assert at >= 1
    names = {s["name"].split("/")[0] for s in ckpt.read_manifest(Path(vol) / str(at))}
    assert names == {"lora", "mu", "nu"}
    out = subprocess.run(cmd + ["--steps", str(at + 2)], cwd=ROOT, env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"resumed from step {at}" in out.stdout and "training complete" in out.stdout
