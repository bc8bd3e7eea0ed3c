"""Mixture-of-experts over a seq axis of ranks on the port against the
JAX package's mesh step (tiny-moe, f32, on the CPU).

The reference routes a batch row over its whole sequence: the capacity
comes from the row's length and the slots from one cumsum over the row's
choice-major token axis (GSPMD runs both across the seq shards). A port
rank holds one stretch of the row and computes the same capacity and the
same slots (workloads/moe.py, `row_capacity`, `slot_offsets`).

Four gloo ranks run every case of `WORKER` in one process group: fresh
interpreters that import no JAX, load the bridged weights and batch from
`.npz` files, and write each rank's slices and metrics back. While they
run, this process computes the JAX references on
`make_mesh(jax.devices()[:4], ...)` from the same numpy weights (rank r of
a port mesh holds what JAX device r holds) and the port's unsharded steps.

The meshes: seq 2 (fsdp 2 takes the other factor, as the reference's
make_mesh does), seq 4, seq 2 x expert 2 and seq 2 x model 2, each with
the einsum and the gather dispatch, at the preset's capacity factor 1.25,
where the reference drops choices at B 8 x S 32 (the test counts them in
JAX's own routing). Tolerances are tests/test_torch_expert_parallel.py's:
loss, grad_norm and router_aux 5e-7 relative after each of 3 AdamW steps,
each rank's param, mu and nu slices by each leaf's rel_l2 1.2e-5. Three
mutants of the routing on seq 4 must fail the metric gate: the capacity
from the rank's own stretch, the slots without the earlier seq ranks'
picks, and the slots without the earlier choices' picks.
"""

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

from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import flatten_params, params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
JCFG = JPRESETS["tiny-moe"].with_(dtype="float32")
TCFG = PRESETS["tiny-moe"].with_(dtype="float32")
WORLD = 4
JOIN_S = 150
LR = 3e-4
B, S = 8, 32
LAYOUTS = {"s2": dict(seq=2), "s4": dict(seq=4), "s2e2": dict(seq=2, expert=2),
           "s2m2": dict(seq=2, model=2)}
IMPLS = ("einsum", "gather")
CASES = [(layout, impl) for layout in LAYOUTS for impl in IMPLS]
MUTANTS = ("local_capacity", "no_rank_prefix", "no_choice_offset")
METRICS = ("loss", "grad_norm", "router_aux")
METRIC_RTOL = 5e-7
SLICE_REL = 1.2e-5


WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import moe, sharding, train
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import flatten_params

rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
CFG = PRESETS["tiny-moe"].with_(dtype="float32")
torch.set_num_threads(1)


def load(name):
    z, tree = np.load(f"{wdir}/{name}.npz"), {}
    for k in z.files:
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(z[k].copy())
    return tree


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


PARAMS, BATCH = load("params"), load("batch")
sharding.init_ranks(4, rank, init, backend="gloo", device="cpu")
MESHES = {name: sharding.make_mesh(["cpu"], layout="training", **axes)
          for name, axes in ARGS["layouts"].items()}
results = {}


def slices(state):
    return {f"{g}/{k}": t.detach().numpy().copy()
            for g, tree in (("params", state.params), ("mu", state.opt_state.mu),
                            ("nu", state.opt_state.nu))
            for k, t in flatten_params(tree)}


def run(name, mesh, steps, impl, save=True):
    cfg = CFG.with_(moe_impl=impl)
    st = train.init_train_state(cfg, params=clone(PARAMS), device="cpu", mesh=mesh,
                                learning_rate=ARGS["lr"])
    step = train.make_train_step(cfg, mesh, learning_rate=ARGS["lr"])
    rows = sharding.shard_batch(BATCH, mesh)
    gathers0 = mesh.stats["all_gathers"]
    out = []
    for _ in range(steps):
        st, m = step(st, rows)
        out.append({k: float(v) for k, v in m.items()})
    if save:
        np.savez(f"{wdir}/{name}_rank{rank}.npz", **slices(st))
    every = [None] * 4
    dist.all_gather_object(every, {"metrics": out, "coords": mesh.coords,
                                   "all_gathers": mesh.stats["all_gathers"] - gathers0})
    results[name] = every


for layout, impl in ARGS["cases"]:
    run(f"{layout}_{impl}", MESHES[layout], 3, impl)

# The mutants of the whole row's routing, one step each on seq 4.
capacity, offsets = moe.row_capacity, moe.slot_offsets


def local_capacity(c, s_local, mesh=None):
    return moe.expert_capacity(c, s_local)


def no_rank_prefix(counts, mesh=None):
    ranks, choices = offsets(counts, mesh)
    return torch.zeros_like(ranks), choices


def no_choice_offset(counts, mesh=None):
    ranks, choices = offsets(counts, mesh)
    return ranks, torch.zeros_like(choices)


for name, patch in (("local_capacity", ("row_capacity", local_capacity)),
                    ("no_rank_prefix", ("slot_offsets", no_rank_prefix)),
                    ("no_choice_offset", ("slot_offsets", no_choice_offset))):
    setattr(moe, *patch)
    try:
        run(name, MESHES["s4"], 1, "einsum", save=False)
    finally:
        moe.row_capacity, moe.slot_offsets = capacity, offsets

if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)
'''


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_npz(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_params(_numpy(tree))})


def run_ranks(tmp: Path):
    """Start the four ranks of WORKER over gloo with a rendezvous file of
    their own; `join_ranks` collects them."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    rdv = tmp / f"rendezvous-{time.monotonic_ns()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    args = json.dumps({"layouts": LAYOUTS, "cases": CASES, "lr": LR})
    return [subprocess.Popen([sys.executable, str(script), str(r), f"file://{rdv}",
                              str(tmp), args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT), start_new_session=True)
            for r in range(WORLD)]


def join_ranks(procs, timeout: float = JOIN_S) -> dict:
    """Wait for every rank within `timeout` seconds, else kill them and
    fail with their stderr tails; returns rank 0's results."""
    deadline = time.monotonic() + timeout
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
    assert not late, f"the ranks were not done within {timeout:.0f}s\n{tails}"
    for p in procs:
        assert p.returncode == 0, tails
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _device_slices(tree, prefix):
    """{name: {device index: numpy slice}} of a sharded JAX tree."""
    return {f"{prefix}/{name}": {jax.devices().index(s.device): np.asarray(s.data)
                                 for s in leaf.addressable_shards}
            for name, leaf in flatten_params(tree)}


def _jax_run(batch, axes, steps, impl):
    mesh = jmake_mesh(jax.devices()[:WORLD], **axes)
    cfg = JCFG.with_(moe_impl=impl)
    state = jtrain.init_train_state(cfg, jax.random.PRNGKey(0), mesh=mesh, learning_rate=LR)
    step = jtrain.make_train_step(cfg, mesh, learning_rate=LR)
    sh = NamedSharding(mesh, JBATCH_SPEC)
    jb = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        state, m = step(state, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    return {"metrics": ms, "slices": {**_device_slices(state.params, "params"),
                                      **_device_slices(adam.mu, "mu"),
                                      **_device_slices(adam.nu, "nu")}}


def _jax_drops(jparams, batch, impl) -> list:
    """The choices JAX's own routing drops in each layer of the first
    step's forward (its route_assignments wrapped for one traced call)."""
    real, drops = jmoe.route_assignments, []

    def counted(c, h, router):
        out = real(c, h, router)
        n = jnp.sum(out[2] >= jmoe.expert_capacity(c, h.shape[1]))
        jax.debug.callback(lambda v: drops.append(int(v)), n)
        return out

    jmoe.route_assignments = counted
    try:
        jtrain.loss_fn(JCFG.with_(moe_impl=impl), jparams,
                       {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
    finally:
        jmoe.route_assignments = real
    return drops


def _port_run(jparams, batch, steps, impl):
    cfg = TCFG.with_(moe_impl=impl)
    st = ttrain.init_train_state(cfg, params=params_from_numpy(_numpy(jparams), "cpu"),
                                 device="cpu", learning_rate=LR)
    step = ttrain.make_train_step(cfg, None, learning_rate=LR)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        st, m = step(st, tb)
        ms.append({k: float(v) for k, v in m.items()})
    return {"metrics": ms}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_seq_ranks")
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    _save_npz(tmp / "params.npz", jparams)
    np.savez(tmp / "batch.npz", **batch)
    t0 = time.monotonic()
    procs = run_ranks(tmp)
    try:
        # The references, while the ranks run.
        ref = {f"{layout}_{impl}": _jax_run(batch, LAYOUTS[layout], 3, impl)
               for layout, impl in CASES}
        drops = {impl: _jax_drops(jparams, batch, impl) for impl in IMPLS}
        port = {impl: _port_run(jparams, batch, 3, impl) for impl in IMPLS}
    finally:
        res = join_ranks(procs)
    print(f"four ranks, every case, with the references: {time.monotonic() - t0:.1f}s")
    return dict(res=res, ref=ref, port=port, drops=drops, tmp=tmp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_metrics(got, want, keys=METRICS, what=""):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{what} {k} {step}")


def test_the_reference_drops_choices_at_this_length(runs):
    """Capacity and slots decide something only where choices drop: at cf
    1.25 JAX's own routing drops some in every layer, either dispatch."""
    for impl, drops in runs["drops"].items():
        assert len(drops) == TCFG.n_layers and all(d > 0 for d in drops), (impl, drops)
        assert runs["drops"][impl] == runs["drops"]["einsum"]


@pytest.mark.parametrize("layout,impl", CASES)
def test_step_metrics_equal_jax_mesh_step_and_unsharded_step(runs, layout, impl):
    """loss, grad_norm and router_aux after each of 3 steps, equal on
    every rank, against JAX's mesh step and the port's unsharded step; one
    all-gather of the routing counts a layer and forward on a seq line."""
    every = runs["res"][f"{layout}_{impl}"]
    got = every[0]["metrics"]
    for r in every:
        assert r["metrics"] == got  # equal on every rank
    _check_metrics(got, runs["ref"][f"{layout}_{impl}"]["metrics"], what="jax")
    _check_metrics(got, runs["port"][impl]["metrics"], what="unsharded")
    assert got[-1]["loss"] < got[0]["loss"] and got[0]["router_aux"] > 0
    if layout in ("s4", "s2m2"):  # fsdp gathers weights, expert the experts' outputs
        assert every[0]["all_gathers"] == 3 * TCFG.n_layers


@pytest.mark.parametrize("layout,impl", CASES)
def test_rank_slices_equal_jax_device_shards_after_three_steps(runs, layout, impl):
    ref = runs["ref"][f"{layout}_{impl}"]["slices"]
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"{layout}_{impl}_rank{rank}.npz")
        assert sorted(z.files) == sorted(ref)
        for name, per_device in ref.items():
            assert z[name].shape == per_device[rank].shape, name
            assert _rel_l2(z[name], per_device[rank]) <= SLICE_REL, (name, rank)


@pytest.mark.parametrize("mutant", MUTANTS)
def test_each_routing_mutant_fails_the_metric_gate(runs, mutant):
    """The capacity from a rank's stretch, the slots without the earlier
    seq ranks' picks, and the slots without the earlier choices' picks
    each route other tokens out (or into one slot) than the reference:
    the loss gate that passes the sound ranks fails each."""
    got = runs["res"][mutant][0]["metrics"][0]
    want = runs["ref"]["s4_einsum"]["metrics"][0]
    assert abs(got["loss"] - want["loss"]) > 100 * METRIC_RTOL * want["loss"]
    with pytest.raises(AssertionError):
        _check_metrics([got], [want], keys=("loss",))


def test_fine_tune_moe_over_seq_ranks_trains_exports_and_resumes(tmp_path):
    """`fine_tune --preset tiny-moe --seq-parallel 2 --ranks 2` on the CPU:
    rank 0 starts its follower and prints the global router aux, the
    export is whole, a rerun resumes."""
    from dstack_tpu_torch.workloads.weights import load_packed

    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny-moe", "--seq-len", "32", "--batch-size", "2",
            "--seq-parallel", "2", "--ranks", "2", "--checkpoint-dir", str(ck)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([*argv, "--steps", "2"], capture_output=True, text=True,
                         timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "2 ranks over gloo (seq 2)" in out.stdout
    assert "step 1: loss" in out.stdout and "router_aux" in out.stdout
    assert out.stdout.count("training complete") == 1  # rank 0 alone prints
    packed = load_packed(ck, "cpu")
    assert packed["layers"]["we_gate"].shape == (2, 4, 128, 256)
    again = subprocess.run([*argv, "--steps", "3"], capture_output=True, text=True,
                           timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout and "step 2: loss" in again.stdout
