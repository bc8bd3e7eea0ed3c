"""Podracer RL in the PyTorch port against the JAX package, on the CPU (f32,
tiny RL policy, weights from one JAX init bridged through weights.py):
the environment and advantages exactly equal; the scorer's log-probs and
one PPO step (loss, pg_loss, entropy, clip_fraction, grad_norm and the
updated params) within test_torch_train.py's f32 tolerances (rtol 1e-5,
atol 1e-5); the weights frame and the trajectory frame byte for byte and
across the packages in both directions; the metrics text equal; epoch
fencing, reconnect, the checkpoint and in-process channels, the gang
rescale and the gather timeout; the engine's refresh_params (swap,
mismatch, busy, LoRA, both KV tiers dropped); snapshot isolation under
in-place learner updates; and tests/test_rl.py's Anakin asserts at its
own settings."""

import json
import math
import os
import socket
import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.parallel.mesh import rescale_accum_steps as jrescale
from dstack_tpu.server.metrics_registry import METRICS
from dstack_tpu.workloads import kv_blocks as jkb
from dstack_tpu.workloads import kv_transfer as jkt
from dstack_tpu.workloads import rl as jrl
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.utils.accum import rescale_accum_steps
from dstack_tpu_torch.workloads import kv_blocks as tkb
from dstack_tpu_torch.workloads import kv_transfer as tkt
from dstack_tpu_torch.workloads import rl as trl
from dstack_tpu_torch.workloads.serving import ServingEngine
from dstack_tpu_torch.workloads.transformer import init_params as tinit
from dstack_tpu_torch.workloads.weights import (
    flatten_params,
    params_from_numpy,
    train_state_from_numpy,
)

JCFG = jrl.tiny_rl_config()
TCFG = trl.tiny_rl_config()
RTOL = ATOL = 1e-5
METRIC_KEYS = ("loss", "pg_loss", "entropy", "clip_fraction", "grad_norm")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jparams(seed=0, cfg=JCFG):
    return jinit(cfg, jax.random.PRNGKey(seed))


def _tparams(seed=0, cfg=JCFG):
    """The port's params bridged from the JAX init of `seed` (fresh tensors
    on every call: a learner updates them in place)."""
    return params_from_numpy(_np_tree(_jparams(seed, cfg)), "cpu")


def _t(a):
    return a.detach().to(torch.float32).numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))


def _epoch_params(value: float):
    """Every leaf filled with `value`: a torn mix of epochs shows."""
    return _fill(tinit(TCFG, 0, "cpu"), value)


def _fill(tree, value):
    if isinstance(tree, dict):
        return {k: _fill(v, value) for k, v in tree.items()}
    return torch.full_like(tree, value)


def _assert_epoch(by_name, value):
    for name, arr in by_name.items():
        assert torch.equal(arr, torch.full_like(arr, value)), f"leaf {name}: torn mix"


# -- environment, advantages, accumulation --------------------------------------


@pytest.mark.parametrize("seed,rnd", [(0, 0), (3, 7), (5, 123)])
def test_env_prompts_and_rewards_equal_jax(seed, rnd):
    je = jrl.TargetTokenEnv(64, prompt_len=5, horizon=6, target=7, seed=seed)
    te = trl.TargetTokenEnv(64, prompt_len=5, horizon=6, target=7, seed=seed)
    assert te.prompts(4, rnd) == je.prompts(4, rnd)
    acts = np.random.default_rng(seed).integers(0, 64, (4, 6)).astype(np.int32)
    acts[0, :3] = 7
    np.testing.assert_array_equal(te.token_rewards(acts), je.token_rewards(acts))
    with pytest.raises(ValueError, match="outside vocab"):
        trl.TargetTokenEnv(8, target=9)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_advantages_equal_jax_exactly(seed, normalize):
    rng = np.random.default_rng(seed)
    rewards = (rng.random((5, 7)) < 0.3).astype(np.float32) * rng.random((5, 7)).astype(
        np.float32)
    mask = np.ones((5, 7), np.float32)
    mask[seed % 5, 3 + seed:] = 0.0
    got = trl.compute_advantages(rewards, mask, gamma=0.7, normalize=normalize)
    want = jrl.compute_advantages(rewards, mask, gamma=0.7, normalize=normalize)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_compute_advantages_on_a_zero_variance_batch_equal_jax():
    rewards = np.zeros((2, 4), np.float32)
    mask = np.ones((2, 4), np.float32)
    np.testing.assert_array_equal(trl.compute_advantages(rewards, mask),
                                  jrl.compute_advantages(rewards, mask))


@pytest.mark.parametrize("accum,old,new", [(1, 2, 1), (2, 1, 2), (3, 4, 6), (1, 2, 4),
                                           (1, 0, 1), (5, 3, 3)])
def test_rescale_accum_steps_equals_the_reference(accum, old, new):
    try:
        want = jrescale(accum, old, new)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            rescale_accum_steps(accum, old, new)
        assert str(got.value) == str(e)
        return
    assert rescale_accum_steps(accum, old, new) == want


def test_refresh_addr_from_env():
    assert trl.refresh_addr_from_env({}) is None
    env = {"DSTACK_TPU_RL_REFRESH_ADDR": "10.0.0.2:7001"}
    assert trl.refresh_addr_from_env(env) == jrl.refresh_addr_from_env(env) == ("10.0.0.2", 7001)


# -- scorer and PPO step ----------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_sequence_scorer_matches_jax(temperature):
    tokens = np.random.default_rng(1).integers(1, 64, (2, 9)).astype(np.int32)
    want = np.asarray(jrl.make_sequence_scorer(JCFG)(
        _jparams(), jnp.asarray(tokens), jnp.float32(temperature)))
    got = trl.make_sequence_scorer(TCFG)(_tparams(), torch.from_numpy(tokens), temperature)
    assert got.shape == (2, 8) and got.dtype == torch.float32 and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert bool((got <= 0).all())


def _ppo_batch(h=6, n=4, seed=2, noise=0.3):
    """A fixed batch: tokens, behavior log-probs = the JAX scorer's plus a
    seeded perturbation (so some ratios clip), advantages, a mask with a
    masked tail."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 64, (n, 4 + h)).astype(np.int32)
    behavior = np.asarray(jrl.make_sequence_scorer(JCFG)(
        _jparams(), jnp.asarray(tokens), jnp.float32(1.0)))[:, 3:]
    behavior = (behavior + noise * rng.standard_normal(behavior.shape)).astype(np.float32)
    adv = rng.standard_normal((n, h)).astype(np.float32)
    mask = np.ones((n, h), np.float32)
    mask[-1, h - 2:] = 0.0
    return {"tokens": tokens, "behavior_logprob": behavior, "advantage": adv,
            "mask": mask}


# Adam's eps regime: a step moves a param by lr x mu_hat / (sqrt(nu_hat) + eps),
# which for |g| within 100 x eps (1e-6) turns the f32 noise of a grad that
# cancels to ~0 into a different step (seen: g -3.10e-7 in JAX and -3.24e-7
# here, 4e-6 of its leaf's largest, move the param 1.4e-5 apart at lr 1e-2;
# 1.7e-9 against 5.4e-9, 6.3e-5 apart). Those elements are held to within
# one step per update; every other element (zero grads included) to the
# f32 tolerances.
EPS_REGIME = 1e-6


def _assert_params_close(tparams, jparams, noisy, lr, steps):
    jl = dict(flatten_params(_np_tree(jparams)))
    for name, t in flatten_params(tparams):
        t, j, quiet = _t(t), jl[name], ~noisy[name]
        np.testing.assert_allclose(t[quiet], j[quiet], rtol=RTOL, atol=ATOL, err_msg=name)
        assert np.all(np.abs(t - j)[~quiet] <= lr * steps), name
        assert noisy[name].mean() < 1e-2, (name, noisy[name].mean())


def _eps_regime(g):
    """Nonzero grads within EPS_REGIME (a zero grad is a zero step on both
    sides, held exactly)."""
    return (g != 0) & (np.abs(g) < EPS_REGIME)


@pytest.mark.parametrize("entropy_coef", [0.0, 0.05])
def test_ppo_step_matches_jax(entropy_coef):
    """One PPO step at the RL rate on a fixed batch from one JAX init: the
    metrics and the first moments (0.1 x the grads) within the f32
    tolerances, and the updated params too outside Adam's eps regime
    (EPS_REGIME; a second step would start from params that differ there
    by up to a step)."""
    lr = 1e-2
    batch = _ppo_batch()
    jstate = jrl.init_rl_state(JCFG, jax.random.PRNGKey(0), learning_rate=lr)
    tstate = train_state_from_numpy(_np_tree(jstate), "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["temperature"] = jnp.float32(1.0)
    jstate, jm = jrl.make_rl_train_step(JCFG, learning_rate=lr,
                                        entropy_coef=entropy_coef)(jstate, jb)
    tstate, tm = trl.make_rl_train_step(TCFG, learning_rate=lr, entropy_coef=entropy_coef)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in METRIC_KEYS:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=RTOL, abs=ATOL), k
    assert 0.0 < float(tm["clip_fraction"]) < 1.0
    mu = dict(flatten_params(_np_tree(jstate.opt_state[0].mu)))
    for name, t in flatten_params(tstate.opt_state.mu):
        np.testing.assert_allclose(_t(t), mu[name], rtol=RTOL, atol=ATOL, err_msg=name)
    _assert_params_close(tstate.params, jstate.params,
                         {k: _eps_regime(v / 0.1) for k, v in mu.items()}, lr, 1)
    assert tstate.step == 1 and tstate.opt_state.count == 1


def test_clip_fraction_is_zero_on_policy():
    """Behavior == the current policy: every ratio is exactly 1."""
    state = trl.init_rl_state(TCFG, params=_tparams(1), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(1, 64, (2, 10)).astype(np.int32))
    behavior = trl.make_sequence_scorer(TCFG)(state.params, tokens, 1.0)[:, 3:]
    batch = {"tokens": tokens, "behavior_logprob": behavior,
             "advantage": torch.randn(2, 6, generator=torch.Generator().manual_seed(0)),
             "mask": torch.ones(2, 6)}
    _, m = trl.make_rl_train_step(TCFG)(state, batch)
    assert float(m["clip_fraction"]) == 0.0


def test_rl_step_raises_logprob_of_advantaged_actions():
    score = trl.make_sequence_scorer(TCFG)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, 64, (4, 10)).astype(np.int32))
    for sign in (1.0, -1.0):
        state = trl.init_rl_state(TCFG, params=_tparams(), learning_rate=5e-2, device="cpu")
        before = float(score(state.params, tokens, 1.0)[:, 3:].sum())
        batch = {"tokens": tokens, "behavior_logprob": score(state.params, tokens, 1.0)[:, 3:],
                 "advantage": torch.full((4, 6), sign), "mask": torch.ones(4, 6)}
        state, m = trl.make_rl_train_step(TCFG, learning_rate=5e-2)(state, batch)
        after = float(score(state.params, tokens, 1.0)[:, 3:].sum())
        assert (after > before) if sign > 0 else (after < before)
        assert all(math.isfinite(float(m[k])) for k in METRIC_KEYS)


def test_a_mesh_beyond_one_device_is_refused():
    from dstack_tpu_torch.workloads.sharding import make_mesh

    mesh = make_mesh(["cpu"], seq=2)
    for fn in (lambda: trl.init_rl_state(TCFG, mesh=mesh, device="cpu"),
               lambda: trl.make_rl_train_step(TCFG, mesh),
               lambda: trl.make_sequence_scorer(TCFG, mesh)):
        with pytest.raises(NotImplementedError, match="mesh"):
            fn()


# -- named params -----------------------------------------------------------------


def test_named_params_are_the_reference_keystr_names_in_its_order():
    jn = jrl.named_params(_jparams())
    tn = trl.named_params(_tparams())
    assert [n for n, _ in tn] == [n for n, _ in jn]
    assert "['layers']['wq']" in dict(tn)
    for (_, t), (_, j) in zip(tn, jn):
        np.testing.assert_array_equal(t.numpy(), j)


def test_params_from_named_roundtrip_and_validation():
    params = _tparams()
    named = dict(trl.named_params(params))
    rebuilt = trl.params_from_named(params, named)
    for (ka, a), (kb, b) in zip(flatten_params(params), flatten_params(rebuilt)):
        assert ka == kb and torch.equal(a, b)
    missing = dict(named)
    del missing[next(iter(missing))]
    with pytest.raises(ValueError, match="missing"):
        trl.params_from_named(params, missing)
    with pytest.raises(ValueError, match="unknown"):
        trl.params_from_named(params, {**named, "bogus_leaf": torch.zeros(3)})
    bad = dict(named)
    bad[next(iter(bad))] = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="shape"):
        trl.params_from_named(params, bad)


# -- frames -----------------------------------------------------------------------

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4}


def _read(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "peer closed"
        buf += chunk
    return buf


def _raw_frame(sock) -> bytes:
    """One framed message's bytes exactly as they came off the wire."""
    head = _read(sock, 8)
    raw = _read(sock, struct.unpack(">Q", head)[0])
    body = b"".join(_read(sock, math.prod(s["shape"]) * _ITEMSIZE[s["dtype"]])
                    for s in json.loads(raw).get("arrays", ()))
    return head + raw + body


def _pull_raw(port) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        hello = _raw_frame(s)
        jkt.send_msg(s, {"kind": "weight_pull", "have_epoch": 0})
        return hello + _raw_frame(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_frame_is_the_reference_frame_byte_for_byte(dtype):
    jcfg = JCFG.with_(dtype=dtype)
    jp = _jparams(0, jcfg)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    js, ts = jrl.WeightRefreshServer(), trl.WeightRefreshServer()
    try:
        js.publish(jp)
        ts.publish(tp)
        want = _pull_raw(js.port)
        got = _pull_raw(ts.port)
        assert got == want
        assert b'"dtype":"bfloat16"' in got if dtype == "bfloat16" else True
        # The reference counts a pull after its send returns, so the client
        # may hold the frame before the count lands.
        deadline = time.monotonic() + 30
        while js.pulls_served < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ts.pulls_served == 1 and ts.bytes_sent == js.bytes_sent
    finally:
        js.close()
        ts.close()


def test_jax_learner_feeds_a_port_actor_and_the_reverse():
    jp = _jparams(4)
    js = jrl.WeightRefreshServer()
    tc = trl.WeightRefreshClient("127.0.0.1", js.port)
    ts = trl.WeightRefreshServer()
    jc = jrl.WeightRefreshClient("127.0.0.1", ts.port)
    env = trl.TargetTokenEnv(64, prompt_len=4, horizon=4)
    actor = trl.Actor(TCFG, _tparams(0), env, batch_size=2, refresh=tc, device="cpu")
    try:
        js.publish(jp)
        assert actor.maybe_refresh() and actor.weight_epoch == 1
        want = dict(flatten_params(_np_tree(jp)))
        for name, t in flatten_params(actor.engine.params):
            np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
        ts.publish(actor.engine.params)
        epoch, by_name = jc.poll(0)
        assert epoch == 1
        for name, a in jrl.named_params(jp):
            np.testing.assert_array_equal(np.asarray(by_name[name]), a)
    finally:
        actor.close()
        jc.close()
        js.close()
        ts.close()


def test_socket_refresh_fences_epochs_and_never_tears():
    server = trl.WeightRefreshServer()
    client = trl.WeightRefreshClient("127.0.0.1", server.port)
    try:
        assert client.poll(0) is None
        assert server.publish(_epoch_params(1.0)) == 1
        epoch, by_name = client.poll(0)
        assert epoch == 1
        _assert_epoch(by_name, 1.0)
        assert client.poll(1) is None
        assert client.poll(5) is None
        assert server.publish(_epoch_params(2.0)) == 2
        epoch, by_name = client.poll(1)
        assert epoch == 2
        _assert_epoch(by_name, 2.0)
        assert server.pulls_served >= 2 and client.pulls == 2
        assert client.bytes_received == 2 * sum(t.numel() * 4 for t in by_name.values())
    finally:
        client.close()
        server.close()


def test_socket_refresh_client_reconnects_after_drop():
    server = trl.WeightRefreshServer()
    client = trl.WeightRefreshClient("127.0.0.1", server.port)
    try:
        server.publish(_epoch_params(1.0))
        assert client.poll(0)[0] == 1
        client._sock.close()
        time.sleep(0.05)
        server.publish(_epoch_params(2.0))
        assert client.poll(1)[0] == 2
    finally:
        client.close()
        server.close()


def test_weight_frame_budget_is_checked_per_array():
    server = trl.WeightRefreshServer()
    largest = max(t.numel() * 4 for _, t in trl.named_params(_epoch_params(1.0)))
    small = trl.WeightRefreshClient("127.0.0.1", server.port, max_bytes=largest - 1)
    fits = trl.WeightRefreshClient("127.0.0.1", server.port, max_bytes=largest)
    try:
        server.publish(_epoch_params(1.0))
        with pytest.raises(tkt.FrameTooLargeError):
            small.poll(0)
        assert fits.poll(0)[0] == 1
    finally:
        small.close()
        fits.close()
        server.close()


def test_a_version_mismatch_is_a_protocol_error(monkeypatch):
    server = jrl.WeightRefreshServer()  # speaks version 1
    client = trl.WeightRefreshClient("127.0.0.1", server.port)
    try:
        monkeypatch.setattr(trl, "WEIGHT_REFRESH_VERSION", 2)
        with pytest.raises(ConnectionError, match="version"):
            client.poll(0)
    finally:
        client.close()
        server.close()


def test_checkpoint_refresh_roundtrip_and_reference_files(tmp_path):
    refr = trl.CheckpointWeightRefresh(str(tmp_path / "port"))
    assert refr.poll(0) is None
    assert refr.publish(_epoch_params(1.0)) == 1
    epoch, by_name = refr.poll(0)
    assert epoch == 1
    _assert_epoch(by_name, 1.0)
    assert refr.poll(1) is None
    assert refr.publish(_epoch_params(2.0)) == 2
    epoch, by_name = refr.poll(1)
    _assert_epoch(by_name, 2.0)
    assert not [p for p in os.listdir(tmp_path / "port") if "tmp" in p]
    # The reference reads the port's files, and the port the reference's.
    jp = _jparams(2)
    epoch, by_name = jrl.CheckpointWeightRefresh(str(tmp_path / "port")).poll(1)
    assert epoch == 2
    assert set(by_name) == {n for n, _ in trl.named_params(_epoch_params(2.0))}
    jref = jrl.CheckpointWeightRefresh(str(tmp_path / "jax"))
    jref.publish(jp)
    epoch, by_name = trl.CheckpointWeightRefresh(str(tmp_path / "jax")).poll(0)
    assert epoch == 1
    for name, a in jrl.named_params(jp):
        np.testing.assert_array_equal(by_name[name].numpy(), a)


def test_checkpoint_refresh_keeps_bf16_bits(tmp_path):
    params = tinit(TCFG.with_(dtype="bfloat16"), 3, "cpu")
    refr = trl.CheckpointWeightRefresh(str(tmp_path))
    refr.publish(params)
    with open(tmp_path / "weights.json") as f:
        head = json.load(f)
    assert "['embed']" in head["bfloat16"] and "['final_norm']" not in head["bfloat16"]
    with np.load(tmp_path / "weights.npz") as z:
        assert z["['embed']"].dtype == np.uint16 and z["['final_norm']"].dtype == np.float32
    _, by_name = refr.poll(0)
    for name, t in trl.named_params(params):
        assert by_name[name].dtype == t.dtype and torch.equal(by_name[name], t), name


def test_inprocess_refresh_fences_like_the_others():
    refr = trl.InProcessWeightRefresh()
    assert refr.poll(0) is None
    refr.publish(_epoch_params(1.0))
    epoch, by_name = refr.poll(0)
    assert epoch == 1
    _assert_epoch(by_name, 1.0)
    assert refr.poll(1) is None


def _traj(actor_id=0, epoch=3, b=2, p=4, h=5, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 64, (b, p + h)).astype(np.int32)
    return dict(tokens=tokens, actions=tokens[:, p:].copy(),
                behavior_logprob=rng.standard_normal((b, h)).astype(np.float32),
                rewards=rng.random((b, h)).astype(np.float32),
                mask=np.ones((b, h), np.float32), prompt_len=p, actor_id=actor_id,
                weight_epoch=epoch)


def _frame_bytes(send_msg, header, payloads) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send_msg(a, header, payloads)
        return _raw_frame(b)


def test_trajectory_frame_is_the_reference_frame_byte_for_byte():
    t = _traj(actor_id=2, epoch=5, seed=4)
    want = _frame_bytes(jkt.send_msg, *jrl.pack_trajectories(jrl.TrajectoryBatch(**t)))
    got = _frame_bytes(tkt.send_msg, *trl.pack_trajectories(trl.TrajectoryBatch(**t)))
    assert got == want
    header, payloads = trl.pack_trajectories(trl.TrajectoryBatch(**t))
    header["_arrays"] = list(payloads)
    back = trl.unpack_trajectories(header)
    for k in ("tokens", "actions", "behavior_logprob", "rewards", "mask"):
        np.testing.assert_array_equal(getattr(back, k), t[k])
    assert (back.prompt_len, back.actor_id, back.weight_epoch) == (4, 2, 5)
    assert back.env_steps == 10


@pytest.mark.parametrize("sender,receiver", [("port", "jax"), ("jax", "port"),
                                             ("port", "port")])
def test_trajectories_cross_the_packages(sender, receiver):
    mod = {"port": trl, "jax": jrl}
    received = []
    sink = mod[receiver].TrajectorySink(on_batch=received.append)
    client = mod[sender].TrajectoryClient("127.0.0.1", sink.port)
    try:
        sent = [_traj(actor_id=1, epoch=2, seed=1), _traj(actor_id=1, epoch=3, seed=2)]
        for t in sent:
            client.send(mod[sender].TrajectoryBatch(**t))
        assert [r.weight_epoch for r in received] == [2, 3]
        for got, t in zip(received, sent):
            for k in ("tokens", "actions", "behavior_logprob", "rewards", "mask"):
                np.testing.assert_array_equal(np.asarray(getattr(got, k)), t[k])
        assert sink.batches_received == 2
    finally:
        client.close()
        sink.close()


# -- stats and metrics --------------------------------------------------------------


def _drive(stats):
    stats.count_rollout(env_steps=32, episodes=4, seconds=0.5, reward_mean=0.25)
    stats.count_rollout(env_steps=16, episodes=2, reward_mean=0.5)
    stats.count_learn_step(0.1)
    stats.count_publish(1)
    stats.count_publish(2)
    stats.count_adoption(0, 1, 0.01)
    stats.count_adoption(7, 2, 0.02)
    stats.note_actor_epoch(7, 1)
    stats.note_actor_epoch(3, 4)
    stats.observe_staleness(7, 3)
    stats.observe_staleness(0, 1)
    stats.count_gang_resize()
    stats.note_learner_epoch(5)
    return stats.snapshot()


def test_rl_metrics_text_equals_the_reference():
    got = trl.rl_prometheus_metrics(_drive(trl.RLStats()))
    assert got == jrl.rl_prometheus_metrics(_drive(jrl.RLStats()))
    assert 'dstack_tpu_rl_weight_epoch{role="actor"} 1' in got
    assert 'dstack_tpu_rl_refresh_staleness_epochs{actor="7"} 3' in got
    assert trl.rl_prometheus_metrics(trl.RLStats().snapshot()) == \
        jrl.rl_prometheus_metrics(jrl.RLStats().snapshot())


def test_rl_metric_series_all_registered():
    text = trl.rl_prometheus_metrics(_drive(trl.RLStats()))
    declared = set(METRICS)
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name = line.split("{")[0].split(" ")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in declared:
                name = name[: -len(suffix)]
                break
        assert name in declared, f"unregistered series {name}"


def test_rl_stats_actor_epoch_monotone_and_staleness():
    stats = trl.RLStats()
    stats.note_actor_epoch(0, 3)
    stats.note_actor_epoch(0, 2)
    stats.note_actor_epoch(1, 5)
    stats.observe_staleness(0, 2)
    snap = stats.snapshot()
    assert snap["actor_epochs"] == {0: 3, 1: 5}
    assert snap["staleness_epochs"] == {0: 2}


# -- gang resize and gather ----------------------------------------------------------


def test_learner_rescale_gang_preserves_batches_per_update():
    learner = trl.Learner(TCFG, accum_per_actor=1, gang_width=2, device="cpu")
    assert learner.batches_per_update == 2
    learner.rescale_gang(1)
    assert (learner.accum_per_actor, learner.batches_per_update) == (2, 2)
    learner.rescale_gang(2)
    assert (learner.accum_per_actor, learner.batches_per_update) == (1, 2)
    assert learner.stats.gang_resizes_total == 2


def test_learner_rescale_gang_rejects_indivisible_width():
    learner = trl.Learner(TCFG, accum_per_actor=1, gang_width=2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        learner.rescale_gang(4)
    assert learner.gang_width == 2


def test_learner_gather_timeout_is_loud_and_poll_runs():
    learner = trl.Learner(TCFG, accum_per_actor=1, gang_width=2, device="cpu")
    learner.ingest(trl.TrajectoryBatch(**_traj()))
    polls = []
    with pytest.raises(TimeoutError, match="1/2"):
        learner.gather(timeout=0.3, poll=lambda: polls.append(1))
    assert polls
    with pytest.raises(RuntimeError, match="refresh channel"):
        learner.publish()


def test_learner_update_equals_the_reference_update():
    """The learner's stacked update over two actor batches (advantages,
    staleness, reward mean and the step) against the JAX learner's from
    one init."""
    jl = jrl.Learner(JCFG, accum_per_actor=1, gang_width=2)
    tl = trl.Learner(TCFG, accum_per_actor=1, gang_width=2,
                     params=params_from_numpy(_np_tree(jl.state.params), "cpu"),
                     device="cpu")
    batches = [_traj(actor_id=i, epoch=0, b=3, seed=10 + i) for i in range(2)]
    for t in batches:
        t["rewards"] = (t["rewards"] > 0.6).astype(np.float32)
        t["behavior_logprob"] = -np.abs(t["behavior_logprob"]) - 3.0
    jm = jl.update_from([jrl.TrajectoryBatch(**t) for t in batches])
    tm = tl.update_from([trl.TrajectoryBatch(**t) for t in batches])
    for k in METRIC_KEYS + ("reward_mean",):
        assert tm[k] == pytest.approx(jm[k], rel=RTOL, abs=ATOL), k
    assert tl.stats.snapshot()["staleness_epochs"] == jl.stats.snapshot()["staleness_epochs"]
    mu = dict(flatten_params(_np_tree(jl.state.opt_state[0].mu)))
    _assert_params_close(tl.state.params, jl.state.params,
                         {k: _eps_regime(v / 0.1) for k, v in mu.items()}, 1e-2, 1)


# -- the engine's refresh seam ----------------------------------------------------------


def test_engine_refresh_params_copies_into_its_own_tensors():
    params = _epoch_params(1.0)
    engine = ServingEngine(TCFG, params, slots=2, max_len=32, device="cpu")
    try:
        before = {k: t.data_ptr() for k, t in flatten_params(engine.params)}
        assert all(t.data_ptr() != before[k] for k, t in flatten_params(params))
        new = _epoch_params(2.0)
        assert engine.refresh_params(new) == 0
        for k, t in flatten_params(engine.params):
            assert t.data_ptr() == before[k]
            assert torch.equal(t, torch.full_like(t, 2.0)), k
        _fill_(new, 3.0)  # the caller's tensors are not aliased
        assert torch.equal(engine.params["embed"], torch.full_like(new["embed"], 2.0))
    finally:
        engine.close()


def _fill_(tree, value):
    with torch.no_grad():
        for _, t in flatten_params(tree):
            t.fill_(value)


@pytest.mark.parametrize("wrong", ["shape", "dtype", "tree"])
def test_engine_refresh_params_rejects_mismatched_params(wrong):
    engine = ServingEngine(TCFG, _tparams(), slots=2, max_len=32, device="cpu")
    try:
        if wrong == "shape":
            bad = tinit(trl.tiny_rl_config(d_model=32, n_heads=2), 0, "cpu")
        elif wrong == "dtype":
            bad = tinit(TCFG.with_(dtype="bfloat16"), 0, "cpu")
        else:
            bad = _tparams()
            del bad["lm_head"]
        with pytest.raises(ValueError, match="match"):
            engine.refresh_params(bad)
    finally:
        engine.close()


def test_engine_refresh_params_refuses_while_busy():
    engine = ServingEngine(TCFG, _tparams(), slots=2, max_len=32, device="cpu")
    try:
        engine._next_req = object()
        with pytest.raises(RuntimeError, match="idle"):
            engine.refresh_params(_tparams())
    finally:
        engine._next_req = None
        engine.close()


def test_engine_refresh_params_refuses_a_lora_engine():
    engine = ServingEngine(TCFG, _tparams(), slots=2, max_len=32, device="cpu",
                           lora_max_adapters=1, lora_rank=2)
    try:
        with pytest.raises(RuntimeError, match="LoRA"):
            engine.refresh_params(_tparams())
    finally:
        engine.close()


def _drain(q):
    out = []
    while (tok := q.get(timeout=60)) is not None:
        assert not isinstance(tok, BaseException), tok
        out.append(tok)
    return out


def test_engine_refresh_params_drops_both_kv_tiers():
    engine = ServingEngine(TCFG, _tparams(), slots=2, max_len=64, kv_block_size=8,
                           kv_pool_blocks=16, prefill_chunk_tokens=16,
                           kv_host_budget_bytes=32 << 20, device="cpu")
    try:
        for s in range(8):
            _drain(engine.submit([(i * 7 + s * 5) % 63 + 1 for i in range(24)], 8,
                                 temperature=0.0))
        st = engine.stats()
        cached, host = st["kv_blocks_cached"], st["kv_host_blocks"]
        assert cached > 0 and host > 0, st
        assert engine.refresh_params(_tparams(1)) == cached + host
        st = engine.stats()
        assert st["kv_blocks_cached"] == 0 and st["kv_blocks_in_use"] == 0, st
        assert st["kv_host_blocks"] == 0, st
    finally:
        engine.close()


def test_drop_cache_in_step_with_the_reference_allocator():
    tokens = list(range(1, 40))
    allocs = []
    for mod in (jkb, tkb):
        a = mod.BlockAllocator(12, 8)
        table = [a.alloc() for _ in range(5)]
        a.insert_full(tokens, table)
        a.insert_tail(tokens, table)
        for b in table[:3]:
            a.release(b)
        allocs.append((a, a.drop_cache(), table))
    (ja, jn, jt), (ta, tn, tt) = allocs
    assert tn == jn == 5
    assert ta.cached == ja.cached == 0
    assert ta.in_use == ja.in_use == 2
    assert sorted(ta._free) == sorted(ja._free)
    for b in tt[3:]:
        ta.release(b)
    assert ta.in_use == 0


def test_admission_hold_gates_a_round_into_one_wave():
    engine = ServingEngine(TCFG, _tparams(), slots=4, max_len=32, device="cpu")
    try:
        engine.hold_admission()
        outs = [engine.submit([1, 2, 3, i + 4], 4, temperature=0.0) for i in range(4)]
        time.sleep(0.2)
        assert engine._pending.qsize() == 4 and not any(engine._live)
        engine.release_admission()
        assert all(len(_drain(q)) == 4 for q in outs)
    finally:
        engine.close()


# -- actor, snapshot isolation, Anakin --------------------------------------------


def test_actor_rollout_is_scored_under_its_own_weights():
    env = trl.TargetTokenEnv(64, prompt_len=4, horizon=6, seed=1)
    with pytest.raises(ValueError, match="temperature"):
        trl.Actor(TCFG, _tparams(), env, temperature=0.0, device="cpu")
    actor = trl.Actor(TCFG, _tparams(), env, batch_size=3, device="cpu")
    try:
        tb = actor.rollout()
        assert tb.tokens.shape == (3, 10) and tb.actions.shape == (3, 6)
        assert tb.mask.sum() == 18 and actor.rounds == 1
        assert tb.tokens[:, :4].tolist() == env.prompts(3, 0)
        want = trl.make_sequence_scorer(TCFG)(actor.engine.params,
                                              torch.from_numpy(tb.tokens), 1.0)[:, 3:]
        np.testing.assert_array_equal(tb.behavior_logprob, want.numpy())
        np.testing.assert_array_equal(tb.rewards, env.token_rewards(tb.actions))
        assert actor.stats.snapshot()["env_steps_total"] == 18
    finally:
        actor.close()


@pytest.mark.parametrize("mode", ["direct", "socket", "checkpoint"])
def test_a_learner_update_after_a_publish_changes_neither_snapshot_nor_actor(mode, tmp_path):
    """Step 0 of the port: the optimizer updates params in place, so a
    publish must store a copy and the engine must own its tensors."""
    publisher, client, server = trl.make_refresh_channel(mode, str(tmp_path))
    learner = trl.Learner(TCFG, params=_tparams(), refresh=publisher, device="cpu",
                          learning_rate=5e-2)
    env = trl.TargetTokenEnv(64, prompt_len=4, horizon=6)
    actor = trl.Actor(TCFG, learner.state.params, env, batch_size=4, refresh=client,
                      device="cpu")
    try:
        w0 = dict((k, t.clone()) for k, t in trl.named_params(actor.engine.params))
        learner.update_from([trl.TrajectoryBatch(**_traj(b=4, p=4, h=6, seed=1))])
        engine_now = dict(trl.named_params(actor.engine.params))
        assert all(torch.equal(engine_now[k], w0[k]) for k in w0)
        learner.publish()
        w1 = dict((k, t.clone()) for k, t in trl.named_params(learner.state.params))
        assert any(not torch.equal(w1[k], w0[k]) for k in w0)
        learner.update_from([trl.TrajectoryBatch(**_traj(b=4, p=4, h=6, seed=2))])
        w2 = dict(trl.named_params(learner.state.params))
        assert any(not torch.equal(w2[k], w1[k]) for k in w1)
        # The published snapshot is still w1, the engine still w0.
        _, published = client.poll(0)
        assert all(torch.equal(published[k], w1[k]) for k in w1)
        engine_now = dict(trl.named_params(actor.engine.params))
        assert all(torch.equal(engine_now[k], w0[k]) for k in w0)
        # Adoption brings the engine to w1 exactly (not w2).
        assert actor.maybe_refresh() and actor.weight_epoch == 1
        engine_now = dict(trl.named_params(actor.engine.params))
        assert all(torch.equal(engine_now[k], w1[k]) for k in w1)
    finally:
        actor.close()
        if server is not None:
            server.close()


ANAKIN = dict(updates=8, batch_size=8, horizon=8, seed=0, learning_rate=2e-2)


def _anakin(refresh, tmp_path=None, **kw):
    return trl.run_anakin(TCFG, refresh=refresh, params=_tparams(),
                          checkpoint_dir=str(tmp_path) if tmp_path else None,
                          device="cpu", **{**ANAKIN, **kw})


def test_anakin_seeded_learning_smoke():
    """tests/test_rl.py's asserts at its settings: the reward/loss
    trajectory repeats exactly, the smoothed reward improves past 0.3, 512
    env steps, the actor one epoch behind the learner's final publish."""
    a = _anakin("direct")
    b = _anakin("direct")
    assert a["rewards"] == b["rewards"], "trajectory not deterministic"
    assert a["losses"] == b["losses"]
    head = sum(a["rewards"][:3]) / 3
    tail = sum(a["rewards"][-3:]) / 3
    assert tail > head, (a["rewards"], "no smoothed-window improvement")
    assert tail > 0.3, a["rewards"]
    assert a["env_steps_total"] == 8 * 8 * 8
    assert a["learner_epoch"] == 8
    assert a["final_weight_epoch"] == 7
    assert a["metrics"][0]["clip_fraction"] == 0.0  # the first batch is on policy


@pytest.mark.parametrize("refresh", ["socket", "checkpoint"])
def test_anakin_channels_are_invisible_to_the_math(refresh, tmp_path):
    direct = _anakin("direct", updates=4)
    other = _anakin(refresh, tmp_path, updates=4)
    assert direct["rewards"] == other["rewards"]
    assert direct["losses"] == other["losses"]
    assert other["final_weight_epoch"] == 3 and len(other["refresh_s"]) == 3


def test_anakin_refuses_an_unknown_channel():
    with pytest.raises(ValueError, match="unknown refresh"):
        trl.make_refresh_channel("carrier-pigeon")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        trl.make_refresh_channel("checkpoint")
