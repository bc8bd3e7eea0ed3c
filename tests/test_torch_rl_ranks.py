"""RL over meshes of ranks on the port against the JAX package (the tiny
RL policy, f32, on the CPU).

Three groups of gloo rank processes, each a module fixture with its own
deadline (JOIN_S), fresh interpreters that import no JAX:

- the learner: four ranks run the PPO step (`make_rl_train_step(mesh)`,
  `init_rl_state(mesh=)`) on (data 2, fsdp 2) and (fsdp 2, model 2) of
  `tiny_rl_config()`, and on (expert 2, fsdp 2) and (expert 2, model 2) of
  it with 4 experts top-2, 2 steps each, while this process runs JAX's
  `make_rl_train_step(config, mesh)` on `jax.devices()[:4]` from the same
  params (rank r of a port mesh holds what JAX device r holds). Gates:
  loss, pg_loss, entropy, clip_fraction and grad_norm within 5e-7
  relative at each step, each rank's slices of params and Adam moments
  within rel_l2 2e-5 of JAX's device shards, the mesh scorer's rows within
  1e-6 of JAX's. Three mutants must each fail their gate: the entropy
  from the rank's vocab columns alone, the mask count per rank instead of
  the global one, grads not summed over data.
- the actor: two ranks serve the actor's engine on a model-2 mesh; its
  round's tokens equal the unsharded port actor's, its behavior log-probs
  are within 1e-6 of them and within 1e-5 of JAX's scorer on the same
  tokens, a second actor repeats the round exactly, and an adopted frame
  leaves every rank's slices equal to the frame's (a refresh that updates
  the leader's slices alone must fail that check).
- the Sebulba pair: a learner group (fsdp 2) and an actor group (model 2),
  two worlds of two ranks joined by the socket channels, run 3 updates;
  every frame the actor group adopts equals the learner group's whole
  params at that epoch, by sha1 of every rank's slices. (No gate on
  losses: a Sebulba run's staleness depends on timing.)
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dstack_tpu.workloads import rl as jrl
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu_torch.workloads import rl as trl
from dstack_tpu_torch.workloads import sharding as tsh
from dstack_tpu_torch.workloads.weights import flatten_params

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 150
# lr 1e-3: at the RL rate 1e-2 the second step's grad_norm reads 6.6e-7
# (dense) and 1.35e-6 (MoE) against JAX on one device already, the same
# readings as over ranks: a grad that cancels to f32 noise is in Adam's eps
# regime, and the first step moves its param by up to lr in either package
# (tests/test_torch_rl.py, EPS_REGIME). At 1e-3 both read <= 1.4e-7.
LR, CLIP, ENT = 1e-3, 0.2, 0.01
N, PROMPT, HORIZON = 8, 5, 16
LAYOUTS = {"d2f2": dict(data=2, fsdp=2), "f2m2": dict(fsdp=2, model=2),
           "e2f2": dict(expert=2, fsdp=2), "e2m2": dict(expert=2, model=2)}
MOE = {"e2f2", "e2m2"}
MOE_KW = dict(n_experts=4, experts_per_token=2)
STEPS = 2
METRIC_RTOL = 5e-7
SLICE_REL = 2e-5
SCORE_ATOL = 1e-5
# (mutant, layout, the metric whose gate it must fail)
MUTANTS = (("entropy_local", "f2m2", "entropy"), ("count_local", "d2f2", "loss"),
           ("grads_unsummed", "d2f2", "grad_norm"))

COMMON = r'''
import hashlib, json, os, sys, time
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import rl, serving, sharding, train
from dstack_tpu_torch.workloads.weights import flatten_params

torch.set_num_threads(1)


def load(path):
    z, tree = np.load(path), {}
    for k in z.files:
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(z[k].copy())
    return tree


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def digests(tree):
    return {k: hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, t in flatten_params(tree)}


def leave(mesh):
    sharding.leave_ranks(mesh)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
'''

LEARNER = COMMON + r'''
rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
CFG = rl.tiny_rl_config()
MCFG = rl.tiny_rl_config(**ARGS["moe_kw"])
DENSE, MOE_P = load(f"{wdir}/dense.npz"), load(f"{wdir}/moe.npz")
BATCHES = {name: {k: torch.from_numpy(v) for k, v in np.load(f"{wdir}/batch_{name}.npz").items()}
           for name in ("dense", "moe")}
sharding.init_ranks(4, rank, init, backend="gloo", device="cpu")
MESHES = {name: sharding.make_mesh(["cpu"], layout="training", **axes)
          for name, axes in ARGS["layouts"].items()}
results = {}


def run(name, layout, steps, save=True):
    moe = layout in ARGS["moe"]
    cfg, params, mesh = (MCFG, MOE_P, MESHES[layout]) if moe else (CFG, DENSE, MESHES[layout])
    batch = BATCHES["moe" if moe else "dense"]
    st = rl.init_rl_state(cfg, mesh=mesh, learning_rate=ARGS["lr"], params=clone(params),
                          device="cpu")
    step = rl.make_rl_train_step(cfg, mesh, ARGS["lr"], clip_eps=ARGS["clip"],
                                 entropy_coef=ARGS["ent"])
    rows = {**sharding.shard_batch(batch, mesh), "temperature": 1.0}
    logp = rl.make_sequence_scorer(cfg, mesh)(st.params, rows["tokens"], 1.0)
    out = []
    for _ in range(steps):
        st, m = step(st, rows)
        out.append({k: float(v) for k, v in m.items()})
    if save:
        adam = {f"{g}/{k}": t.detach().numpy().copy()
                for g, tree in (("params", st.params), ("mu", st.opt_state.mu),
                                ("nu", st.opt_state.nu))
                for k, t in flatten_params(tree)}
        np.savez(f"{wdir}/{name}_rank{rank}.npz", logp=logp.numpy(), **adam)
    every = [None] * 4
    dist.all_gather_object(every, out)
    results[name] = every


for layout in ARGS["layouts"]:
    run(layout, layout, ARGS["steps"])

# The mutants, one step each.
real_entropy, real_count, real_reduce = rl.token_entropy, rl.mask_count, rl.reduce_grads
for name, layout, _ in ARGS["mutants"]:
    if name == "entropy_local":
        rl.token_entropy = lambda logits, mesh=None: train.token_entropy(logits, None)
    elif name == "count_local":
        rl.mask_count = lambda mask, mesh=None: real_count(mask, None)
    else:
        rl.reduce_grads = lambda grads, mesh, axes_of: real_reduce(
            grads, mesh, lambda k: tuple(a for a in axes_of(k) if a != "data"))
    run(name, layout, 1, save=False)
    rl.token_entropy, rl.mask_count, rl.reduce_grads = real_entropy, real_count, real_reduce

if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
leave(None)
'''

ACTOR = COMMON + r'''
rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
CFG = rl.tiny_rl_config()
P, FRAME = load(f"{wdir}/dense.npz"), load(f"{wdir}/frame.npz")
ENV = rl.TargetTokenEnv(CFG.vocab_size, prompt_len=ARGS["prompt"], horizon=ARGS["horizon"],
                        seed=0)
KW = dict(batch_size=ARGS["n"], temperature=1.0, seed=0)
sharding.init_ranks(2, rank, init, backend="gloo", device="cpu")
mesh = sharding.make_mesh(["cpu"], model=2)
results = {}


def adopted_ok(engine):
    want = sharding.rank_params(mesh, FRAME)
    return all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten_params(engine.params), flatten_params(want)))


def one(name, refresh, leader_only=False):
    real = serving.ServingEngine._op_refresh
    if leader_only and rank:
        serving.ServingEngine._op_refresh = lambda self, params: None
    try:
        if rank:
            eng = rl.run_actor_follower(CFG, P, ENV, mesh=mesh, **KW)
            ok = adopted_ok(eng) if refresh else None
        else:
            pub = rl.InProcessWeightRefresh()
            actor = rl.Actor(CFG, P, ENV, refresh=pub, engine_kwargs={"mesh": mesh}, **KW)
            try:
                b = actor.rollout(0)
                if refresh:
                    pub.publish(FRAME)
                    assert actor.maybe_refresh() and actor.weight_epoch == 1
            finally:
                actor.close()
            ok = adopted_ok(actor.engine) if refresh else None
            results[name] = {"tokens": b.tokens.tolist(), "logp": b.behavior_logprob.tolist(),
                             "mask": b.mask.tolist()}
    finally:
        serving.ServingEngine._op_refresh = real
    every = [None] * 2
    dist.all_gather_object(every, ok)
    if rank == 0:
        results[name]["adopted"] = every


one("first", refresh=False)
one("again", refresh=True)
one("leader_only", refresh=True, leader_only=True)
if rank == 0:
    actor = rl.Actor(CFG, P, ENV, device="cpu", **KW)
    try:
        b = actor.rollout(0)
    finally:
        actor.close()
    results["unsharded"] = {"tokens": b.tokens.tolist(), "logp": b.behavior_logprob.tolist()}
    print("RESULT " + json.dumps(results), flush=True)
leave(mesh)
'''

SEBULBA_LEARNER = COMMON + r'''
rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
CFG = rl.tiny_rl_config()
sharding.init_ranks(2, rank, init, backend="gloo", device="cpu")
mesh = sharding.make_mesh(["cpu"], layout="training", fsdp=2)
server = rl.WeightRefreshServer() if rank == 0 else None
learner = rl.Learner(CFG, mesh=mesh, params=load(f"{wdir}/dense.npz"), device="cpu",
                     learning_rate=ARGS["lr"], refresh=server)
if rank == 0:
    sink = rl.TrajectorySink(on_batch=learner.ingest)
    with open(f"{wdir}/ports.tmp", "w") as f:
        json.dump([server.port, sink.port], f)
    os.replace(f"{wdir}/ports.tmp", f"{wdir}/ports.json")
metrics = []
for _ in range(ARGS["updates"]):
    metrics.append(learner.update_once(timeout=60))
    epoch = learner.publish()
    if rank == 0:
        _, manifest, arrays = server._snap
        np.savez(f"{wdir}/frame_epoch{epoch}.npz",
                 **{spec["name"]: a.numpy() for spec, a in zip(manifest, arrays)})
if rank == 0:
    deadline = time.monotonic() + 60
    while not os.path.exists(f"{wdir}/actor_done") and time.monotonic() < deadline:
        time.sleep(0.05)
    sink.close()
    server.close()
    print("RESULT " + json.dumps({"epoch": learner.weight_epoch, "updates": learner.updates,
                                  "metrics": metrics}), flush=True)
leave(mesh)
'''

SEBULBA_ACTOR = COMMON + r'''
rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
CFG = rl.tiny_rl_config()
P = load(f"{wdir}/dense.npz")
ENV = rl.TargetTokenEnv(CFG.vocab_size, prompt_len=ARGS["prompt"], horizon=ARGS["horizon"],
                        seed=0)
KW = dict(batch_size=ARGS["n"], temperature=1.0, seed=0)
sharding.init_ranks(2, rank, init, backend="gloo", device="cpu")
mesh = sharding.make_mesh(["cpu"], model=2)
# Every rank's slices after each refresh op, in op order.
adoptions = []
real = serving.ServingEngine._op_refresh


def recorded(self, params):
    real(self, params)
    adoptions.append(digests(self.params))


serving.ServingEngine._op_refresh = recorded
if rank:
    rl.run_actor_follower(CFG, P, ENV, mesh=mesh, **KW)
    epochs = None
else:
    deadline = time.monotonic() + 60
    while not os.path.exists(f"{wdir}/ports.json") and time.monotonic() < deadline:
        time.sleep(0.05)
    wport, tport = json.load(open(f"{wdir}/ports.json"))
    traj = rl.TrajectoryClient("127.0.0.1", tport)
    actor = rl.Actor(CFG, P, ENV, refresh=rl.WeightRefreshClient("127.0.0.1", wport),
                     engine_kwargs={"mesh": mesh}, **KW)
    epochs, rounds = [], 0
    try:
        while actor.weight_epoch < ARGS["updates"] and rounds < 40:
            if actor.maybe_refresh():
                epochs.append(actor.weight_epoch)
            if actor.weight_epoch >= ARGS["updates"]:
                break
            traj.send(actor.rollout())
            rounds += 1
    finally:
        actor.close()
        traj.close()
        open(f"{wdir}/actor_done", "w").close()
every = [None] * 2
dist.all_gather_object(every, adoptions)
if rank == 0:
    print("RESULT " + json.dumps({"epochs": epochs, "adoptions": every}), flush=True)
leave(mesh)
'''


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_npz(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_params(_numpy(tree))})


def start_ranks(tmp: Path, source: str, tag: str, world: int, args: dict):
    """`world` fresh interpreters of `source` over gloo, with a rendezvous
    file of their own."""
    script = tmp / f"{tag}.py"
    script.write_text(source)
    rdv = tmp / f"rendezvous-{tag}-{time.monotonic_ns()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    return [subprocess.Popen([sys.executable, str(script), str(r), f"file://{rdv}",
                              str(tmp), json.dumps(args)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT), start_new_session=True)
            for r in range(world)]


def join_ranks(procs, deadline: float) -> dict:
    """Wait for every rank until `deadline` (monotonic), else kill them and
    fail with their stderr tails; returns rank 0's RESULT."""
    late = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                late = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    outs = [p.communicate() for p in procs]
    tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{err[-2000:]}"
                      for r, (p, (_, err)) in enumerate(zip(procs, outs)))
    assert not late, f"the ranks were not done within {JOIN_S}s\n{tails}"
    for p in procs:
        assert p.returncode == 0, tails
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _jconfig(moe: bool):
    return jrl.tiny_rl_config(**(MOE_KW if moe else {}))


def _batch(cfg, jparams) -> dict:
    """N episodes of PROMPT + HORIZON tokens from a seed: ends between
    HORIZON/2 and HORIZON, advantages of mean 0.5, behavior log-probs the
    policy's own (`cfg`, `jparams`) plus noise (so some ratios clip)."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 64, (N, PROMPT + HORIZON)).astype(np.int32)
    ends = rng.integers(HORIZON // 2, HORIZON + 1, (N, 1))
    mask = (np.arange(HORIZON)[None] < ends).astype(np.float32)
    adv = ((rng.standard_normal((N, HORIZON)) + 0.5) * mask).astype(np.float32)
    logp = np.asarray(jrl.make_sequence_scorer(cfg)(
        jparams, jnp.asarray(tokens), jnp.float32(1.0)))[:, PROMPT - 1:]
    behavior = (logp + 0.1 * rng.standard_normal(logp.shape)).astype(np.float32)
    return {"tokens": tokens, "behavior_logprob": behavior, "advantage": adv, "mask": mask}


def _device_slices(tree, prefix):
    return {f"{prefix}/{name}": {jax.devices().index(s.device): np.asarray(s.data)
                                 for s in leaf.addressable_shards}
            for name, leaf in flatten_params(tree)}


def _jax_run(layout, batches, steps):
    moe = layout in MOE
    cfg = _jconfig(moe)
    batch = batches["moe" if moe else "dense"]
    mesh = jmake_mesh(jax.devices()[:4], **LAYOUTS[layout])
    state = jrl.init_rl_state(cfg, jax.random.PRNGKey(0), mesh, LR)
    step = jrl.make_rl_train_step(cfg, mesh, LR, clip_eps=CLIP, entropy_coef=ENT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["temperature"] = jnp.float32(1.0)
    logp = jrl.make_sequence_scorer(cfg, mesh)(
        state.params, jax.device_put(jb["tokens"], NamedSharding(mesh, JBATCH_SPEC)),
        jnp.float32(1.0))
    out = {"logp": {jax.devices().index(s.device): np.asarray(s.data)
                    for s in logp.addressable_shards}}
    ms = []
    for _ in range(steps):
        state, m = step(state, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    out.update(metrics=ms, slices={**_device_slices(state.params, "params"),
                                   **_device_slices(adam.mu, "mu"),
                                   **_device_slices(adam.nu, "nu")})
    return out


@pytest.fixture(scope="module")
def ppo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rl_ranks")
    jdense = jrl.init_rl_state(_jconfig(False), jax.random.PRNGKey(0)).params
    jmoe = jrl.init_rl_state(_jconfig(True), jax.random.PRNGKey(0)).params
    _save_npz(tmp / "dense.npz", jdense)
    _save_npz(tmp / "moe.npz", jmoe)
    batches = {"dense": _batch(_jconfig(False), jdense), "moe": _batch(_jconfig(True), jmoe)}
    for name, batch in batches.items():
        np.savez(tmp / f"batch_{name}.npz", **batch)
    t0 = time.monotonic()
    procs = start_ranks(tmp, LEARNER, "learner", 4, {
        "layouts": LAYOUTS, "moe": sorted(MOE), "moe_kw": MOE_KW, "lr": LR, "clip": CLIP,
        "ent": ENT, "steps": STEPS, "mutants": MUTANTS})
    try:
        ref = {layout: _jax_run(layout, batches, STEPS) for layout in LAYOUTS}
    finally:
        res = join_ranks(procs, t0 + JOIN_S)
    print(f"four learner ranks, every case, with JAX's: {time.monotonic() - t0:.1f}s")
    return dict(res=res, ref=ref, tmp=tmp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ppo_step_over_ranks_matches_jax_mesh_step(ppo, layout):
    got, want = ppo["res"][layout], ppo["ref"][layout]["metrics"]
    for rank, ms in enumerate(got):
        assert ms == got[0], f"rank {rank}'s metrics differ from rank 0's"
    for step, (g, w) in enumerate(zip(got[0], want)):
        for k in trl.METRIC_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=f"{layout} {k} step {step}")
    assert 0.0 < got[0][0]["clip_fraction"] < 1.0  # the clip branch is exercised


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_rank_holds_jax_device_slices_after_two_steps(ppo, layout):
    ref = ppo["ref"][layout]["slices"]
    for rank in range(4):
        z = np.load(ppo["tmp"] / f"{layout}_rank{rank}.npz")
        for name, shards in ref.items():
            assert z[name].shape == shards[rank].shape, (layout, rank, name)
            rel = _rel_l2(z[name], shards[rank])
            assert rel <= SLICE_REL, f"{layout} rank {rank} {name}: rel_l2 {rel:.3e}"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_scorer_returns_each_rank_rows_of_jax_scores(ppo, layout):
    ref = ppo["ref"][layout]["logp"]
    for rank in range(4):
        got = np.load(ppo["tmp"] / f"{layout}_rank{rank}.npz")["logp"]
        np.testing.assert_allclose(got, ref[rank], atol=SCORE_ATOL, rtol=0,
                                   err_msg=f"{layout} rank {rank}")


@pytest.mark.parametrize("name,layout,guard", MUTANTS)
def test_each_mutant_fails_its_gate(ppo, name, layout, guard):
    got = ppo["res"][name][0][0]
    want = ppo["ref"][layout]["metrics"][0]
    rel = abs(got[guard] - want[guard]) / abs(want[guard])
    assert rel > 10 * METRIC_RTOL, f"{name}: {guard} reads {rel:.3e}, within the gate"


def test_a_seq_mesh_raises_in_both_packages():
    """JAX's own step cannot run a seq axis: BATCH_SPEC cuts both the
    tokens (N, T) and the forward's (N, T-1) over seq, and one of two
    consecutive lengths is odd."""
    cfg = _jconfig(False)
    batch = {k: jnp.asarray(v) for k, v in _batch(
        cfg, jrl.init_rl_state(cfg, jax.random.PRNGKey(0)).params).items()}
    batch["temperature"] = jnp.float32(1.0)
    for tokens in (batch["tokens"], batch["tokens"][:, 1:]):   # T odd, then T even
        for axes in (dict(seq=2), dict(model=2, seq=2)):
            mesh = jmake_mesh(jax.devices()[:2 * len(axes)], fsdp=1, **axes)
            state = jrl.init_rl_state(cfg, jax.random.PRNGKey(0), mesh, LR)
            with pytest.raises(ValueError):
                jrl.make_rl_train_step(cfg, mesh, LR)(state, dict(batch, tokens=tokens))
    shape = dict(zip(tsh.AXES, (1, 1, 2, 2, 1)))
    mesh = tsh.Mesh(torch.device("cpu"), shape, group=object(), backend="gloo",
                    layout="training")
    with pytest.raises(ValueError, match="cannot take a seq axis"):
        trl.make_rl_train_step(trl.tiny_rl_config(), mesh)


# -- the actor on a serving mesh ---------------------------------------------------


@pytest.fixture(scope="module")
def actor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rl_actor_ranks")
    jparams = jrl.init_rl_state(_jconfig(False), jax.random.PRNGKey(0)).params
    _save_npz(tmp / "dense.npz", jparams)
    frame = jrl.init_rl_state(_jconfig(False), jax.random.PRNGKey(1)).params
    _save_npz(tmp / "frame.npz", frame)
    t0 = time.monotonic()
    procs = start_ranks(tmp, ACTOR, "actor", 2, {"n": N, "prompt": PROMPT,
                                                 "horizon": HORIZON})
    res = join_ranks(procs, t0 + JOIN_S)
    print(f"two actor ranks: {time.monotonic() - t0:.1f}s")
    return dict(res=res, jparams=jparams)


def test_mesh_actor_rolls_out_the_unsharded_actor_round(actor):
    r = actor["res"]
    assert r["first"]["tokens"] == r["unsharded"]["tokens"]
    np.testing.assert_allclose(r["first"]["logp"], r["unsharded"]["logp"], atol=1e-6, rtol=0)
    assert all(all(row) for row in r["first"]["mask"])


def test_mesh_actor_scores_as_jax_on_its_tokens(actor):
    r = actor["res"]["first"]
    tokens = jnp.asarray(np.asarray(r["tokens"], np.int32))
    want = np.asarray(jrl.make_sequence_scorer(_jconfig(False))(
        actor["jparams"], tokens, jnp.float32(1.0)))[:, PROMPT - 1:]
    np.testing.assert_allclose(r["logp"], want, atol=1e-5, rtol=0)


def test_mesh_actor_round_repeats_exactly_under_hold_admission(actor):
    r = actor["res"]
    assert r["again"]["tokens"] == r["first"]["tokens"]
    assert r["again"]["logp"] == r["first"]["logp"]


def test_an_adopted_frame_is_every_rank_slices(actor):
    r = actor["res"]
    assert r["again"]["adopted"] == [True, True]
    # The mutant: the follower skips the refresh op, the leader adopts.
    assert r["leader_only"]["adopted"] == [True, False]


# -- the Sebulba pair across groups --------------------------------------------------


@pytest.fixture(scope="module")
def sebulba(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rl_sebulba_ranks")
    jparams = jrl.init_rl_state(_jconfig(False), jax.random.PRNGKey(0)).params
    _save_npz(tmp / "dense.npz", jparams)
    args = {"n": N, "prompt": PROMPT, "horizon": HORIZON, "lr": 2e-2, "updates": 3}
    t0 = time.monotonic()
    learners = start_ranks(tmp, SEBULBA_LEARNER, "sebulba_learner", 2, args)
    actors = start_ranks(tmp, SEBULBA_ACTOR, "sebulba_actor", 2, args)
    try:
        act = join_ranks(actors, t0 + JOIN_S)
    finally:
        learn = join_ranks(learners, t0 + JOIN_S)
    print(f"the learner and actor groups: {time.monotonic() - t0:.1f}s")
    return dict(learner=learn, actor=act, tmp=tmp)


def test_sebulba_pair_across_groups_adopts_the_learner_frames(sebulba):
    learn, act = sebulba["learner"], sebulba["actor"]
    assert learn["updates"] == 3 and learn["epoch"] == 3
    assert act["epochs"] and act["epochs"][-1] == 3
    assert act["epochs"] == sorted(set(act["epochs"]))
    for rank, adoptions in enumerate(act["adoptions"]):
        assert len(adoptions) == len(act["epochs"]), rank
        mesh = tsh.Mesh(torch.device("cpu"), dict(zip(tsh.AXES, (1, 1, 1, 2, 1))),
                        group=object(), rank=rank, backend="gloo")
        for epoch, got in zip(act["epochs"], adoptions):
            z = np.load(sebulba["tmp"] / f"frame_epoch{epoch}.npz")
            whole = trl.params_from_named(trl.param_template(trl.tiny_rl_config()),
                                          {k: torch.from_numpy(z[k]) for k in z.files})
            want = {k: hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest()
                    for k, t in flatten_params(tsh.rank_params(mesh, whole))}
            assert got == want, f"actor rank {rank} at epoch {epoch}"
    assert all(np.isfinite(m["loss"]) for m in learn["metrics"])
