"""The port's train-state checkpoint (workloads/checkpoint.py) on the CPU,
on tiny, and against the JAX package where it has a counterpart: the round
trip bit for bit, retention, what restore ignores, an async save followed
at once by an in-place step, resume against the unbroken run (bit for bit
in the port; within tests/test_torch_train.py's AdamW tolerances against
the JAX run restored at the same step), a JAX TrainState carried across by
`train_state_from_numpy`, the fine_tune entry point run twice, the params
export, and native_server's cold-start order.

Tolerances against JAX, as tests/test_torch_train.py: f32 loss 1e-5
relative, params 1e-5 absolute (about 3% of one AdamW step of lr 3e-4),
moments 1e-5 by the relative norm of the difference per leaf."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import checkpoint as jckpt
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads import transformer as jtr
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu_torch.workloads import checkpoint as ckpt
from dstack_tpu_torch.workloads import data as tdata
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import (
    flatten_params,
    params_from_numpy,
    train_state_from_numpy,
)

B, S = 2, 32
# Warmup-cosine: the step size moves with the optimizer count, so a resume
# that lost the count would take other steps.
SCHED = {"warmup_steps": 2, "decay_steps": 6}
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _close_writers():
    yield
    ckpt.close_all()
    jckpt.close_all()


def _cfg(dtype="float32"):
    return PRESETS["tiny"].with_(dtype=dtype)


def _batches(n, vocab=512, start=0):
    out = []
    for i in range(start, start + n):
        tok = np.random.default_rng(100 + i).integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append((tok[:, :-1].copy(), tok[:, 1:].copy()))
    return out


def _tb(b):
    return {"inputs": torch.from_numpy(b[0]), "targets": torch.from_numpy(b[1])}


def _jb(b):
    return {"inputs": jnp.asarray(b[0]), "targets": jnp.asarray(b[1])}


def _bits(state):
    """Every leaf's dtype, shape and bytes, and step and count."""
    out = {"step": state.step, "count": state.opt_state.count}
    for name, t in ckpt._leaves(state):
        t = t.detach()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[name] = (t.dtype, tuple(t.shape), raw.numpy().tobytes())
    return out


def _trained(n, dtype="float32", seed=0):
    cfg = _cfg(dtype)
    state = ttrain.init_train_state(cfg, seed, "cpu", **SCHED)
    step = ttrain.make_train_step(cfg, **SCHED)
    for b in _batches(n):
        state, _ = step(state, _tb(b))
    return cfg, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact_with_step_and_count(tmp_path, dtype):
    cfg, state = _trained(2, dtype)
    assert ckpt.save(tmp_path, state, wait=True) == 2
    want = _bits(state)
    template = ttrain.init_train_state(cfg, 7, "cpu")
    restored = ckpt.restore_latest(tmp_path, template)
    assert restored.step == 2 and restored.opt_state.count == 2
    assert _bits(restored) == want
    # Read into the template's tensors (no second state), still trainable.
    assert restored.params["embed"] is template.params["embed"]
    assert all(p.requires_grad for _, p in flatten_params(restored.params))
    meta = json.loads((tmp_path / "2" / "state.json").read_text())
    assert meta == {"format": ckpt.FORMAT, "step": 2, "count": 2}


def test_missing_or_empty_volume_gives_none(tmp_path):
    template = ttrain.init_train_state(_cfg(), 0, "cpu")
    assert ckpt.restore_latest(tmp_path / "nothing-here", template) is None
    assert ckpt.restore_latest(tmp_path, template) is None
    (tmp_path / "packed").mkdir()
    (tmp_path / ".3.abc.tmp").mkdir()
    assert ckpt.restore_latest(tmp_path, template) is None
    assert ckpt.restore_latest_params(tmp_path, "cpu") is None


def test_keeps_only_the_newest_max_to_keep(tmp_path):
    """As tests/test_checkpoint.py holds Orbax's max_to_keep=3."""
    cfg = _cfg()
    state = ttrain.init_train_state(cfg, 0, "cpu")
    step = ttrain.make_train_step(cfg)
    for b in _batches(5):
        state, _ = step(state, _tb(b))
        ckpt.save(tmp_path, state, wait=True)
    kept = {p.name for p in tmp_path.iterdir() if p.name.isdigit()}
    assert ckpt.MAX_TO_KEEP == 3 and kept == {"3", "4", "5"}
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".")]
    restored = ckpt.restore_latest(tmp_path, ttrain.init_train_state(cfg, 1, "cpu"))
    assert restored.step == 5


def test_a_step_directory_without_its_json_is_ignored(tmp_path):
    """A killed writer's leftovers (a newer step directory holding the
    weights but not state.json) never read as the newest checkpoint."""
    cfg, state = _trained(2)
    ckpt.save(tmp_path, state, wait=True)
    want = _bits(state)
    half = tmp_path / "9"
    shutil.copytree(tmp_path / "2", half)
    (half / "state.json").unlink()
    restored = ckpt.restore_latest(tmp_path, ttrain.init_train_state(cfg, 1, "cpu"))
    assert restored.step == 2 and _bits(restored) == want


def test_resaving_a_step_replaces_it(tmp_path):
    cfg, state = _trained(1)
    ckpt.save(tmp_path, state, wait=True)
    with torch.no_grad():
        state.params["embed"].add_(1.0)
    ckpt.save(tmp_path, state, wait=True)
    want = _bits(state)
    restored = ckpt.restore_latest(tmp_path, ttrain.init_train_state(cfg, 1, "cpu"))
    assert _bits(restored) == want
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1"]


def test_async_save_then_an_in_place_step_restores_the_state_at_the_save(tmp_path):
    """The step updates params and moments in place, so save must have
    copied every leaf before it returned (on the CPU, .cpu() would alias
    the live storage)."""
    cfg, state = _trained(1)
    step = ttrain.make_train_step(cfg, **SCHED)
    want = _bits(state)
    ckpt.save(tmp_path, state)  # asynchronous
    state, _ = step(state, _tb(_batches(1, start=1)[0]))
    state, _ = step(state, _tb(_batches(1, start=2)[0]))
    assert _bits(state)["params/embed"] != want["params/embed"]
    ckpt.close_all()
    restored = ckpt.restore_latest(tmp_path, ttrain.init_train_state(cfg, 1, "cpu"))
    assert _bits(restored) == want


def test_restore_refuses_a_template_of_another_shape(tmp_path):
    _, state = _trained(1)
    ckpt.save(tmp_path, state, wait=True)
    other = ttrain.init_train_state(_cfg().with_(n_layers=1), 1, "cpu")
    before = _bits(other)
    with pytest.raises(ValueError, match="the template's float32"):
        ckpt.restore_latest(tmp_path, other)
    assert _bits(other) == before
    params = ttrain.init_train_state(_cfg(), 1, "cpu").params
    params["extra"] = torch.zeros(3)
    extra = ttrain.init_train_state(_cfg(), device="cpu", params=params)
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_latest(tmp_path, extra)


def _token_file(tmp_path, vocab=512):
    toks = np.random.default_rng(3).integers(0, vocab, 12 * (S + 1)).astype(np.int32)
    path = str(tmp_path / "toks.npy")
    tdata.write_token_file(path, toks)
    return path


@pytest.mark.parametrize("source", ["synthetic", "loader"])
def test_resume_at_step_2_of_5_equals_the_unbroken_run_bit_for_bit(tmp_path, source):
    """The resumed run restores into a template from another seed, and the
    loader restarts at `start_step` (the rows of steps 2, 3, 4 again)."""
    cfg = _cfg()
    step = ttrain.make_train_step(cfg, **SCHED)
    data = _token_file(tmp_path) if source == "loader" else None
    fixed = [_tb(b) for b in _batches(5)]

    def run(state, start, stop):
        loader = (tdata.BatchLoader(tdata.TokenDataset(data, S), B, device="cpu",
                                    start_step=start) if data else None)
        losses = []
        try:
            for i in range(start, stop):
                state, m = step(state, next(loader) if loader else fixed[i])
                losses.append(float(m["loss"]))
        finally:
            if loader:
                loader.close()
        return state, losses

    unbroken, want_losses = run(ttrain.init_train_state(cfg, 0, "cpu", **SCHED), 0, 5)
    first, losses = run(ttrain.init_train_state(cfg, 0, "cpu", **SCHED), 0, 2)
    ckpt.save(tmp_path / "ckpt", first, wait=True)
    del first
    template = ttrain.init_train_state(cfg, 5, "cpu", **SCHED)
    resumed = ckpt.restore_latest(tmp_path / "ckpt", template)
    assert resumed.step == 2
    resumed, more = run(resumed, resumed.step, 5)
    assert losses + more == want_losses
    assert _bits(resumed) == _bits(unbroken)


def _jax_run(n_before, n_after, jdir):
    """The JAX trainer: n_before steps, Orbax save, restore into a template
    from another key at the same step, n_after more steps."""
    jcfg = JPRESETS["tiny"].with_(dtype="float32")
    jstate = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0), **SCHED)
    jstep = jtrain.make_train_step(jcfg, **SCHED)
    batches = _batches(n_before + n_after)
    losses = []
    for b in batches[:n_before]:
        jstate, m = jstep(jstate, _jb(b))
        losses.append(float(m["loss"]))
    jckpt.save(jdir, jstate, wait=True)
    template = jtrain.init_train_state(jcfg, jax.random.PRNGKey(1), **SCHED)
    jstate = jckpt.restore_latest(jdir, template)
    assert int(jstate.step) == n_before
    for b in batches[n_before:]:
        jstate, m = jstep(jstate, _jb(b))
        losses.append(float(m["loss"]))
    return jstate, losses


def _assert_params_close(tparams, jparams):
    jl = dict(flatten_params(jax.tree_util.tree_map(np.asarray, jparams)))
    tl = dict(flatten_params(tparams))
    assert sorted(jl) == sorted(tl)
    for name, j in jl.items():
        np.testing.assert_allclose(tl[name].detach().numpy(), np.asarray(j, np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_moments_close(topt, jopt):
    adam = jopt[0]
    for tree_t, tree_j in ((topt.mu, adam.mu), (topt.nu, adam.nu)):
        jl = dict(flatten_params(jax.tree_util.tree_map(np.asarray, tree_j)))
        for path, t in flatten_params(tree_t):
            want = np.asarray(jl[path], np.float32)
            err = np.linalg.norm(t.numpy() - want) / max(np.linalg.norm(want), 1e-30)
            assert err < RTOL, (path, err)
    assert topt.count == int(adam.count)


def test_jax_and_port_resumed_runs_agree(tmp_path):
    """The same params, batches and schedule: the JAX run saved with
    checkpoint.save (Orbax) and restored at step 2, and the port's run
    saved and restored at step 2, both continued to step 5."""
    jstate, jlosses = _jax_run(2, 3, tmp_path / "jax")
    jparams0 = jtr.init_params(JPRESETS["tiny"].with_(dtype="float32"), jax.random.PRNGKey(0))
    cfg = _cfg()
    state = ttrain.init_train_state(
        cfg, device="cpu", params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams0),
                                                    "cpu"), **SCHED)
    step = ttrain.make_train_step(cfg, **SCHED)
    batches = _batches(5)
    losses = []
    for b in batches[:2]:
        state, m = step(state, _tb(b))
        losses.append(float(m["loss"]))
    ckpt.save(tmp_path / "port", state, wait=True)
    state = ckpt.restore_latest(tmp_path / "port", ttrain.init_train_state(cfg, 3, "cpu"))
    for b in batches[2:]:
        state, m = step(state, _tb(b))
        losses.append(float(m["loss"]))
    assert state.step == int(jstate.step) == 5
    assert losses == pytest.approx(jlosses, rel=RTOL)
    _assert_params_close(state.params, jstate.params)
    _assert_moments_close(state.opt_state, jstate.opt_state)


def test_train_state_from_numpy_continues_a_jax_state():
    """A JAX TrainState after 2 steps (schedule on), carried across whole
    (step, params, count, mu, nu), takes one port step that matches the
    JAX continuation."""
    jcfg = JPRESETS["tiny"].with_(dtype="float32")
    jstate = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0), **SCHED)
    jstep = jtrain.make_train_step(jcfg, **SCHED)
    batches = _batches(3)
    for b in batches[:2]:
        jstate, _ = jstep(jstate, _jb(b))
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    assert state.step == 2 and state.opt_state.count == 2
    assert state.opt_state.mu["embed"].dtype == torch.float32
    assert all(p.requires_grad for _, p in flatten_params(state.params))
    _assert_params_close(state.params, jstate.params)
    jstate, jm = jstep(jstate, _jb(batches[2]))
    state, m = ttrain.make_train_step(_cfg(), **SCHED)(state, _tb(batches[2]))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    assert state.step == 3
    _assert_params_close(state.params, jstate.params)
    _assert_moments_close(state.opt_state, jstate.opt_state)


def test_train_state_from_numpy_refuses_a_state_without_adam():
    with pytest.raises(ValueError, match="AdamW"):
        train_state_from_numpy(jtrain.TrainState(np.int32(0), {}, ()), "cpu")


def test_fine_tune_run_twice_resumes_at_the_saved_step(tmp_path, capsys, monkeypatch):
    from dstack_tpu_torch import fine_tune

    d = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--preset", "tiny", "--batch-size", "2", "--seq-len", "32"]
    fine_tune.main(common + ["--steps", "3", "--checkpoint-dir", d])
    out = capsys.readouterr().out
    assert "resumed" not in out and "step 2: loss" in out and "training complete" in out
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "packed"]
    fine_tune.main(common + ["--steps", "5", "--checkpoint-dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step 4: loss" in out
    assert "step 0:" not in out
    # $CHECKPOINT_DIR is the default, as in the JAX example trainer.
    monkeypatch.setenv("CHECKPOINT_DIR", d)
    fine_tune.main(common + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and ": loss" not in out
    state = ckpt.restore_latest(d, ttrain.init_train_state(PRESETS["tiny"], 1, "cpu"))
    assert state.step == 5


def test_export_params_round_trip_and_the_latest_params(tmp_path):
    cfg, state = _trained(2)
    path = ckpt.export_params(tmp_path, state)
    assert path == tmp_path / "packed"
    template = ttrain.init_train_state(cfg, 4, "cpu").params
    got = ckpt.restore_exported_params(tmp_path, template)
    assert got is template
    for (k, a), (_, b) in zip(flatten_params(got), flatten_params(state.params)):
        assert torch.equal(a, b), k
    assert ckpt.restore_exported_params(tmp_path / "none", template) is None
    ckpt.save(tmp_path, state, wait=True)
    latest = ckpt.restore_latest_params(tmp_path, "cpu")
    assert [k for k, _ in flatten_params(latest)] == [k for k, _ in flatten_params(state.params)]
    for (k, a), (_, b) in zip(flatten_params(latest), flatten_params(state.params)):
        assert torch.equal(a, b), k
    # The packed export is the module the JAX package keeps it in.
    assert ckpt.load_packed is not None and ckpt.save_packed is not None


@pytest.mark.parametrize("have_packed", [True, False])
def test_native_server_cold_start_order(tmp_path, capsys, monkeypatch, have_packed):
    """The packed export first, then the params of the newest train-state
    checkpoint; the load is bracketed by weights_start / weights_end."""
    from dstack_tpu_torch.native_server import Engine

    _, state = _trained(2)
    ckpt.save(tmp_path, state, wait=True)
    want = state.params
    if have_packed:
        _, other = _trained(1)
        ckpt.export_params(tmp_path, other)
        want = other.params
    monkeypatch.setenv("DSTACK_RUN_NAME", "cold-start-test")
    capsys.readouterr()
    eng = Engine("tiny", 4, checkpoint_dir=str(tmp_path), device="cpu")
    try:
        out = capsys.readouterr().out
        assert out.index("::dstack-tpu-stage::weights_start") < \
            out.index("::dstack-tpu-stage::weights_end")
        assert eng.weights_via == ("packed" if have_packed else "checkpoint")
        for (k, a), (_, b) in zip(flatten_params(eng.params), flatten_params(want)):
            assert torch.equal(a, b), k
    finally:
        eng.serving.close()
    with pytest.raises(ValueError, match="no packed export"):
        Engine("tiny", 4, checkpoint_dir=str(tmp_path / "empty"), device="cpu")
