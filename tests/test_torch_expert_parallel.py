"""Expert parallelism on the port against the JAX package's mesh step
(tiny-moe, f32, on the CPU).

Four gloo ranks run every case of `WORKER` in one process group: fresh
interpreters that import no JAX, load the bridged weights and batch from
`.npz` files, and write each rank's slices and metrics back. While they
run, this process computes the JAX references on
`make_mesh(jax.devices()[:4], ...)` from the same numpy weights (rank r of
a port mesh holds what JAX device r holds) and the port's unsharded steps.

The meshes: (expert 2, fsdp 2), (expert 2, model 2), (expert 2, data 2),
(expert 4), and (fsdp 2, model 2) without an expert axis, each with the
einsum and the gather dispatch. Tolerances are
tests/test_torch_train_sharded.py's: loss, grad_norm and router_aux 5e-7
relative after each of 3 AdamW steps (measured <= 3.3e-7 against JAX,
<= 1.8e-7 against the port's unsharded step), each rank's param, mu and
nu slices by each leaf's rel_l2 1.2e-5 (measured <= 2.3e-6); checkpoints
and data rows bit for bit. The router aux over ranks is a rank's share of
the global batch's; the mutant that takes a mean of the ranks' own auxes
(the trap of a mesh that splits the batch) must fail the router_aux gate
(it reads 5.8e-2 off).
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

from dstack_tpu.workloads import data as jdata
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import sharding as tsh
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
LAYOUTS = {"e2f2": dict(expert=2, fsdp=2), "e2m2": dict(expert=2, model=2),
           "e2d2": dict(expert=2, data=2), "e4": dict(expert=4),
           "f2m2": dict(fsdp=2, model=2)}
IMPLS = ("einsum", "gather")
CASES = [(layout, impl) for layout in LAYOUTS for impl in IMPLS]
METRICS = ("loss", "grad_norm", "router_aux")
METRIC_RTOL = 5e-7
SLICE_REL = 1.2e-5


WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import checkpoint, moe, sharding, train
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.data import BatchLoader, TokenDataset
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
MESHES["f4"] = sharding.make_mesh(["cpu"], layout="training", fsdp=4)
results = {}


def slices(state):
    return {f"{g}/{k}": t.detach().numpy().copy()
            for g, tree in (("params", state.params), ("mu", state.opt_state.mu),
                            ("nu", state.opt_state.nu))
            for k, t in flatten_params(tree)}


def metrics(m):
    return {k: float(v) for k, v in m.items()}


def run(name, mesh, steps, impl, accum=1, save=True):
    cfg = CFG.with_(moe_impl=impl)
    st = train.init_train_state(cfg, params=clone(PARAMS), device="cpu", mesh=mesh,
                                learning_rate=ARGS["lr"])
    step = train.make_train_step(cfg, mesh, learning_rate=ARGS["lr"], accum_steps=accum)
    rows = sharding.shard_batch(BATCH, mesh)
    stats0 = dict(mesh.stats)
    out = []
    for _ in range(steps):
        st, m = step(st, rows)
        out.append(metrics(m))
    if save:
        np.savez(f"{wdir}/{name}_rank{rank}.npz", **slices(st))
    every = [None] * 4
    dist.all_gather_object(every, {"metrics": out, "coords": mesh.coords, "stats": {
        k: mesh.stats[k] - stats0[k] for k in ("all_gathers", "all_reduces")}})
    results[name] = every
    return st, step, rows


for layout, impl in ARGS["cases"]:
    run(f"{layout}_{impl}", MESHES[layout], 3, impl)
run("accum", MESHES["e2d2"], 2, "einsum", accum=2)

# The mutant: each rank's aux from its own rows, the mean of those taken
# as the global one (a mean of per-rank auxes, not the global batch's).
real = moe.switch_aux


def local_aux(probs, sel, mesh=None):
    if mesh is None or not mesh.training:
        return real(probs, sel, mesh)
    return real(probs, sel) / sharding.batch_shards(mesh)


moe.switch_aux = local_aux
run("local_aux", MESHES["e2d2"], 1, "einsum", save=False)
moe.switch_aux = real

# Rows: the loader's on (expert 2, data 2), each expert line's the same.
loader = BatchLoader(TokenDataset(f"{wdir}/tokens.npy", ARGS["seq"]), 8,
                     mesh=MESHES["e2d2"], seed=11, prefetch=1)
got = [next(loader) for _ in range(2)]
loader.close()
np.savez(f"{wdir}/rows_rank{rank}.npz", **{f"{k}{i}": b[k].numpy() for i, b in
                                            enumerate(got) for k in b})

# Checkpoint: saved at (expert 2, fsdp 2) after one step, restored at
# (fsdp 4); the next steps against the uninterrupted run's.
ck = f"{wdir}/ckpt"
st, step, rows = run("ckpt", MESHES["e2f2"], 1, "einsum", save=False)
checkpoint.save(ck, st, wait=True, mesh=MESHES["e2f2"])
uninterrupted = []
for _ in range(2):
    st, m = step(st, rows)
    uninterrupted.append(metrics(m))
mesh = MESHES["f4"]
tmpl = train.init_train_state(CFG, params=clone(PARAMS), device="cpu", mesh=mesh,
                              learning_rate=ARGS["lr"])
st = checkpoint.restore_latest(ck, tmpl, mesh)
whole = {f"params/{k}": t.detach().numpy().copy()
         for k, t in flatten_params(sharding.unshard_tree(mesh, st.params))}
whole.update({f"mu/{k}": t.numpy().copy()
              for k, t in flatten_params(sharding.unshard_tree(mesh, st.opt_state.mu))})
if rank == 0:
    np.savez(f"{wdir}/restored_f4.npz", **whole)
step = train.make_train_step(CFG, mesh, learning_rate=ARGS["lr"])
rows = sharding.shard_batch(BATCH, mesh)
resumed = [st.step, st.opt_state.count]
for _ in range(2):
    st, m = step(st, rows)
    resumed.append(metrics(m))
results["ckpt_resume"] = {"uninterrupted": uninterrupted, "resumed": resumed}

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
    args = json.dumps({"layouts": LAYOUTS, "cases": CASES, "lr": LR, "seq": S})
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


def _jax_run(batch, axes, steps, impl, accum=1):
    mesh = jmake_mesh(jax.devices()[:WORLD], **axes)
    cfg = JCFG.with_(moe_impl=impl)
    state = jtrain.init_train_state(cfg, jax.random.PRNGKey(0), mesh=mesh, learning_rate=LR)
    step = jtrain.make_train_step(cfg, mesh, learning_rate=LR, accum_steps=accum)
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


def _port_run(jparams, batch, steps, impl, accum=1):
    cfg = TCFG.with_(moe_impl=impl)
    st = ttrain.init_train_state(cfg, params=params_from_numpy(_numpy(jparams), "cpu"),
                                 device="cpu", learning_rate=LR)
    step = ttrain.make_train_step(cfg, None, learning_rate=LR, accum_steps=accum)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        st, m = step(st, tb)
        ms.append({k: float(v) for k, v in m.items()})
    return {"metrics": ms, "state": st}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_parallel")
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    _save_npz(tmp / "params.npz", jparams)
    np.savez(tmp / "batch.npz", **batch)
    np.save(tmp / "tokens.npy", rng.integers(0, JCFG.vocab_size, 40 * (S + 1)).astype(np.int32))
    t0 = time.monotonic()
    procs = run_ranks(tmp)
    try:
        # The references, while the ranks run.
        ref = {f"{layout}_{impl}": _jax_run(batch, LAYOUTS[layout], 3, impl)
               for layout, impl in CASES}
        ref["accum"] = _jax_run(batch, LAYOUTS["e2d2"], 2, "einsum", accum=2)
        port = {impl: _port_run(jparams, batch, 3, impl) for impl in IMPLS}
        port["accum"] = _port_run(jparams, batch, 2, "einsum", accum=2)
        dmesh = jmake_mesh(jax.devices()[:WORLD], **LAYOUTS["e2d2"])
        jloader = jdata.BatchLoader(jdata.TokenDataset(str(tmp / "tokens.npy"), S), 8,
                                    mesh=dmesh, seed=11, prefetch=1)
        ref["rows"] = [next(jloader) for _ in range(2)]
        jloader.close()
    finally:
        res = join_ranks(procs)
    print(f"four ranks, every case, with the references: {time.monotonic() - t0:.1f}s")
    return dict(res=res, ref=ref, port=port, tmp=tmp, batch=batch, jparams=jparams)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rank_slices(runs, case, rank):
    z = np.load(runs["tmp"] / f"{case}_rank{rank}.npz")
    return {k: z[k] for k in z.files}


def _check_metrics(got, want, keys=METRICS, what=""):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{what} {k} {step}")


@pytest.mark.parametrize("layout,impl", CASES)
def test_step_metrics_equal_jax_mesh_step_and_unsharded_step(runs, layout, impl):
    """loss, grad_norm and router_aux after each of 3 steps, equal on
    every rank, against JAX's mesh step and the port's unsharded step."""
    every = runs["res"][f"{layout}_{impl}"]
    got = every[0]["metrics"]
    for r in every:
        assert r["metrics"] == got  # equal on every rank
    _check_metrics(got, runs["ref"][f"{layout}_{impl}"]["metrics"], what="jax")
    _check_metrics(got, runs["port"][impl]["metrics"], what="unsharded")
    assert got[-1]["loss"] < got[0]["loss"] and got[0]["router_aux"] > 0


@pytest.mark.parametrize("layout,impl", CASES)
def test_rank_slices_equal_jax_device_shards_after_three_steps(runs, layout, impl):
    ref = runs["ref"][f"{layout}_{impl}"]["slices"]
    for rank in range(WORLD):
        got = _rank_slices(runs, f"{layout}_{impl}", rank)
        assert sorted(got) == sorted(ref)
        for name, per_device in ref.items():
            assert got[name].shape == per_device[rank].shape, name
            assert _rel_l2(got[name], per_device[rank]) <= SLICE_REL, (name, rank)


def test_expert_banks_are_each_ranks_block_of_experts(runs):
    """On (expert 4) rank r holds expert r of every bank and the whole of
    every other leaf; on (expert 2, data 2) an expert line's two ranks
    hold the same block."""
    for rank in range(WORLD):
        got = _rank_slices(runs, "e4_einsum", rank)
        assert got["params/layers/we_gate"].shape == (TCFG.n_layers, 1, TCFG.d_model, TCFG.d_ff)
        assert got["params/layers/router"].shape == (TCFG.n_layers, TCFG.d_model, TCFG.n_experts)
    coords = [r["coords"] for r in runs["res"]["e2d2_einsum"]]
    assert [c["expert"] for c in coords] == [0, 1, 0, 1] and [c["data"] for c in coords] == [0, 0, 1, 1]
    a, b = (_rank_slices(runs, "e2d2_einsum", r) for r in (0, 2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_local_aux_mutant_fails_the_router_aux_gate(runs):
    """A mean of the data ranks' own auxes is not the global batch's: the
    router_aux gate that passes the port's share fails it."""
    got = runs["res"]["local_aux"][0]["metrics"][0]
    want = runs["ref"]["e2d2_einsum"]["metrics"][0]
    assert abs(got["router_aux"] - want["router_aux"]) > 100 * METRIC_RTOL * want["router_aux"]
    with pytest.raises(AssertionError):
        _check_metrics([got], [want], keys=("router_aux",))


def test_accum_steps_on_an_expert_mesh(runs):
    """accum_steps 2 on (expert 2, data 2): each microbatch the
    reference's rows of the global batch (each data rank its block of
    them), whose router aux is that microbatch's; 2 steps against JAX's
    lax.scan mean and the port's unsharded accumulation."""
    got = runs["res"]["accum"][0]["metrics"]
    _check_metrics(got, runs["ref"]["accum"]["metrics"], what="jax")
    _check_metrics(got, runs["port"]["accum"]["metrics"], what="unsharded")
    # Not the mean of the whole batch's aux: the microbatches' own.
    assert abs(got[0]["router_aux"] - runs["ref"]["e2d2_einsum"]["metrics"][0]["router_aux"]) > 1e-4
    ref = runs["ref"]["accum"]["slices"]
    for rank in range(WORLD):
        sl = _rank_slices(runs, "accum", rank)
        for name, per_device in ref.items():
            assert _rel_l2(sl[name], per_device[rank]) <= SLICE_REL, (name, rank)


def test_batch_loader_rows_equal_jax_addressable_shards_on_an_expert_mesh(runs):
    want = runs["ref"]["rows"]
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"rows_rank{rank}.npz")
        for i, jb in enumerate(want):
            for k in ("inputs", "targets"):
                shard = next(s for s in jb[k].addressable_shards
                             if s.device == jax.devices()[rank])
                np.testing.assert_array_equal(z[f"{k}{i}"], np.asarray(shard.data))


def test_checkpoint_from_an_expert_mesh_restores_bit_for_bit(runs):
    """Saved on (expert 2, fsdp 2), restored on (fsdp 4) and on one device:
    the same whole leaves bit for bit; the restored runs' next steps within
    the metric tolerance of the uninterrupted run's."""
    ck = runs["tmp"] / "ckpt"
    tmpl = ttrain.init_train_state(TCFG, params=params_from_numpy(_numpy(runs["jparams"]),
                                                                   "cpu"),
                                   device="cpu", learning_rate=LR)
    one = tckpt.restore_latest(ck, tmpl)
    assert one.step == 1 and one.opt_state.count == 1
    saved = {**{f"params/{k}": t.detach().numpy() for k, t in flatten_params(one.params)},
             **{f"mu/{k}": t.numpy() for k, t in flatten_params(one.opt_state.mu)}}
    z = np.load(runs["tmp"] / "restored_f4.npz")
    assert sorted(z.files) == sorted(saved)
    for k in z.files:
        np.testing.assert_array_equal(z[k], saved[k], err_msg=k)
    res = runs["res"]["ckpt_resume"]
    assert res["resumed"][:2] == [1, 1]
    step = ttrain.make_train_step(TCFG, None, learning_rate=LR)
    tb = {k: torch.from_numpy(v) for k, v in runs["batch"].items()}
    for i, want in enumerate(res["uninterrupted"]):
        one, m = step(one, tb)
        for got in (res["resumed"][2 + i], {k: float(v) for k, v in m.items()}):
            _check_metrics([got], [want])


def test_expert_collectives_ran_on_every_rank(runs):
    """The expert gathers forward and the tokens' grad all-reduces backward
    on every rank of an expert mesh; a mesh without one gathers the banks
    over fsdp only."""
    for r in runs["res"]["e4_einsum"]:
        # 3 steps x 2 layers: one output gather a layer, one all-reduce of
        # the tokens' grad a layer, and the aux's top-1 counts need none
        # (no axis splits the batch).
        assert r["stats"] == {"all_gathers": 6, "all_reduces": 6 + 3}
    for r in runs["res"]["e2d2_einsum"]:
        assert r["stats"]["all_gathers"] == 6 and r["stats"]["all_reduces"] > 6


def test_the_expert_axis_must_divide_the_experts():
    mesh = tsh.Mesh(torch.device("cpu"), dict(zip(tsh.AXES, (1, 1, 1, 1, 8))),
                    group=object(), backend="gloo", layout="training")
    for fn in (lambda: ttrain.make_train_step(TCFG, mesh),
               lambda: ttrain.init_train_state(TCFG, device="cpu", mesh=mesh)):
        with pytest.raises(ValueError, match="must divide"):
            fn()


# -- the entry point ----------------------------------------------------------------


def test_fine_tune_expert_parallel_over_four_ranks_trains_exports_and_resumes(tmp_path):
    """`fine_tune --preset tiny-moe --expert-parallel 2 --ranks 4` (expert 2
    x fsdp 2) on the CPU: rank 0 starts three followers and prints the
    global router aux, the export is whole, a rerun resumes."""
    from dstack_tpu_torch.workloads.weights import load_packed

    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny-moe", "--seq-len", "32", "--batch-size", "4",
            "--expert-parallel", "2", "--ranks", "4", "--checkpoint-dir", str(ck)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([*argv, "--steps", "2"], capture_output=True, text=True,
                         timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "4 ranks over gloo (fsdp 2 x expert 2)" in out.stdout
    assert "step 1: loss" in out.stdout and "router_aux" in out.stdout
    assert out.stdout.count("training complete") == 1  # rank 0 alone prints
    packed = load_packed(ck, "cpu")
    assert packed["layers"]["we_gate"].shape == (2, 4, 128, 256)  # every expert, whole
    again = subprocess.run([*argv, "--steps", "3"], capture_output=True, text=True,
                           timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout and "step 2: loss" in again.stdout


@pytest.mark.parametrize("flag,error,match", [
    (["--expert-parallel", "3", "--ranks", "3"], SystemExit,
     "--expert-parallel must divide the preset's n_experts"),
    # MoE over a seq axis of ranks and LoRA on an expert axis train (their
    # parity with JAX: tests/test_torch_moe_seq_ranks.py and
    # tests/test_torch_lora_ranks.py).
    pytest.param(["--expert-parallel", "2", "--seq-parallel", "2"], None,
                 "4 ranks over gloo (seq 2 x expert 2)",
                 id="flag1-NotImplementedError-ROADMAP Queue 1 item 3h"),
    pytest.param(["--expert-parallel", "2", "--lora-rank", "4"], None,
                 "2 ranks over gloo (expert 2), LoRA rank 4",
                 id="flag2-NotImplementedError-ROADMAP Queue 1 item 3j"),
])
def test_fine_tune_expert_parallel_refusals(flag, error, match, capsys):
    """An expert axis that does not divide the experts is refused before
    any rank starts; MoE over seq ranks beside the expert axis and LoRA on
    it train over gloo ranks (rank 0 in this process starts the others)."""
    from dstack_tpu_torch import fine_tune

    if error is not None:
        with pytest.raises(error, match=match):
            fine_tune.main(["--device", "cpu", "--preset", "tiny-moe", *flag])
        return
    fine_tune.main(["--device", "cpu", "--preset", "tiny-moe", "--steps", "2",
                    "--seq-len", "32", "--batch-size", "2", *flag])
    out = capsys.readouterr().out
    assert match in out and "step 1: loss" in out and "training complete" in out
