"""Training across ranks on the port against the JAX package's mesh step
(tiny, f32, on the CPU).

Four gloo ranks run every case of `WORKER` in one process group: fresh
interpreters that import no JAX, load the bridged weights and batches
from `.npz` files, and write each rank's slices and metrics back. While
they run, this process computes the JAX references on
`make_mesh(jax.devices()[:4], ...)` from the same numpy weights (rank r of
a port mesh holds what JAX device r holds) and the port's unsharded steps.

Tolerances, at about 3x the largest gap measured on the CPU (the
reference's own sharded/unsharded check, 5e-3 on the first loss, is the
ceiling): loss and grad_norm 5e-7 relative against JAX's mesh step and
the port's unsharded step (measured 1.6e-7); each rank's param, mu and nu
slices after 3 AdamW steps by each leaf's rel_l2 (||port - ref|| /
||ref||) 1.2e-5 against JAX device r's and the unsharded state's slices
(measured 3.8e-6; Adam's normalised step turns a summation-order
difference of a grad near eps into up to one step of ~lr, so an
elementwise bound would be set by a handful of such elements); LoRA
slices 2e-5 (measured 6.4e-6); data rows and checkpoints bit for bit.
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
from dstack_tpu.workloads import lora as jlora
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.sharding import param_shardings, shard_tree as jshard_tree
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import sharding as tsh
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import flatten_params, params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")
WORLD = 4
JOIN_S = 150
LR, LORA_LR = 3e-4, 1e-3
B, S = 8, 32
# The reference's test_sharded_train_step layouts, without seq.
LAYOUTS = {"d2f2": dict(data=2, fsdp=2), "f2m2": dict(fsdp=2, model=2), "f4": dict(fsdp=4)}
METRIC_RTOL = 5e-7
SLICE_REL = 1.2e-5
LORA_REL = 2e-5


WORKER = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import checkpoint, sharding, train
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.data import BatchLoader, TokenDataset
from dstack_tpu_torch.workloads.lora import init_lora_state, make_lora_train_step
from dstack_tpu_torch.workloads.weights import flatten_params

rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
CFG = PRESETS["tiny"].with_(dtype="float32")
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


PARAMS, LORA, BATCH = load("params"), load("lora"), load("batch")
sharding.init_ranks(4, rank, init, backend="gloo", device="cpu")
MESHES = {name: sharding.make_mesh(["cpu"], layout="training", **axes)
          for name, axes in ARGS["layouts"].items()}
results = {}


def slices(state, what="params"):
    first = state.params if what == "params" else state.lora
    return {f"{g}/{k}": t.detach().numpy().copy()
            for g, tree in ((what, first), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))
            for k, t in flatten_params(tree)}


def metrics(m):
    return {k: float(v) for k, v in m.items()}


def run(name, mesh, steps, batch, accum=1, cfg=CFG):
    st = train.init_train_state(cfg, params=clone(PARAMS), device="cpu", mesh=mesh,
                                learning_rate=ARGS["lr"])
    step = train.make_train_step(cfg, mesh, learning_rate=ARGS["lr"], accum_steps=accum)
    rows = sharding.shard_batch(batch, mesh)
    stats0 = dict(mesh.stats)
    out = []
    for _ in range(steps):
        st, m = step(st, rows)
        out.append(metrics(m))
    np.savez(f"{wdir}/{name}_rank{rank}.npz", **slices(st))
    every = [None] * 4
    dist.all_gather_object(every, out)
    results[name] = {"metrics": every, "coords": mesh.coords,
                     "all_gathers": mesh.stats["all_gathers"] - stats0["all_gathers"]}
    return st, step, rows


batch = {k: BATCH[k] for k in ("inputs", "targets")}
for name, mesh in MESHES.items():
    run(name, mesh, 3, batch)
run("accum", MESHES["f2m2"], 1, batch, accum=2)
run("mask", MESHES["f2m2"], 1, {**batch, "loss_mask": BATCH["loss_mask"]})
run("remat", MESHES["f4"], 3, batch, cfg=CFG.with_(remat="full"))

# Batches: the loader's rows and the synthetic batch's rows of this rank.
loader = BatchLoader(TokenDataset(f"{wdir}/tokens.npy", ARGS["seq"]), 8,
                     mesh=MESHES["d2f2"], seed=11, prefetch=1)
got = [next(loader) for _ in range(2)]
loader.close()
syn = train.synthetic_batch(CFG, 8, ARGS["seq"], seed=5, mesh=MESHES["f2m2"])
np.savez(f"{wdir}/rows_rank{rank}.npz", **{f"{k}{i}": b[k].numpy() for i, b in
                                            enumerate(got) for k in b},
         syn_inputs=syn["inputs"].numpy(), syn_targets=syn["targets"].numpy())

# Checkpoint: saved at (fsdp 2, model 2) after one step, restored at
# (fsdp 4) and again at (fsdp 2, model 2); the next steps against the
# uninterrupted run's.
ck = f"{wdir}/ckpt"
st, step, rows = run("ckpt", MESHES["f2m2"], 1, batch)
checkpoint.save(ck, st, wait=True, mesh=MESHES["f2m2"])
uninterrupted = []
for _ in range(2):
    st, m = step(st, rows)
    uninterrupted.append(metrics(m))
resumed = {}
for name in ("f4", "f2m2"):
    mesh = MESHES[name]
    tmpl = train.init_train_state(CFG, params=clone(PARAMS), device="cpu", mesh=mesh,
                                  learning_rate=ARGS["lr"])
    st = checkpoint.restore_latest(ck, tmpl, mesh)
    whole = {k: t.detach().numpy().copy() for k, t in
             flatten_params(sharding.unshard_tree(mesh, st.params))}
    whole.update({f"mu/{k}": t.numpy().copy() for k, t in
                  flatten_params(sharding.unshard_tree(mesh, st.opt_state.mu))})
    if rank == 0:
        np.savez(f"{wdir}/restored_{name}.npz", **whole)
    step = train.make_train_step(CFG, mesh, learning_rate=ARGS["lr"])
    rows = sharding.shard_batch(batch, mesh)
    resumed[name] = [st.step, st.opt_state.count]
    for _ in range(2):
        st, m = step(st, rows)
        resumed[name].append(metrics(m))
results["ckpt"].update(uninterrupted=uninterrupted, resumed=resumed)

# LoRA on (fsdp 2, model 2) from the JAX adapters, two steps (B is zero at
# init, so A moves from the second).
mesh = MESHES["f2m2"]
base = sharding.shard_tree(mesh, clone(PARAMS))
st = init_lora_state(CFG, base, 0, rank=4, mesh=mesh, lora=clone(LORA),
                     learning_rate=ARGS["lora_lr"])
lstep = make_lora_train_step(CFG, mesh, rank=4, learning_rate=ARGS["lora_lr"])
rows = sharding.shard_batch(batch, mesh)
out = []
for _ in range(2):
    st, m = lstep(st, base, rows)
    out.append(metrics(m))
np.savez(f"{wdir}/lora_rank{rank}.npz", **slices(st, "lora"))
every = [None] * 4
dist.all_gather_object(every, out)
results["lora"] = {"metrics": every, "coords": mesh.coords}

stats = [None] * 4
dist.all_gather_object(stats, dict(MESHES["f2m2"].stats))
if rank == 0:
    results["stats"] = stats
    print("RESULT " + json.dumps(results), flush=True)
dist.destroy_process_group()
'''


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_npz(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_params(_numpy(tree))})


def run_ranks(tmp: Path, timeout: float = JOIN_S) -> subprocess.Popen:
    """Start the four ranks of WORKER over gloo with a rendezvous file of
    their own; `join_ranks` collects them."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    rdv = tmp / f"rendezvous-{time.monotonic_ns()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    args = json.dumps({"layouts": LAYOUTS, "lr": LR, "lora_lr": LORA_LR, "seq": S})
    return [subprocess.Popen([sys.executable, str(script), str(r), f"file://{rdv}",
                              str(tmp), args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT), start_new_session=True)
            for r in range(WORLD)]


def join_ranks(procs, timeout: float = JOIN_S) -> dict:
    """Wait for every rank within `timeout` seconds, else kill them;
    returns rank 0's results."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _jax_batch(batch, mesh):
    sh = NamedSharding(mesh, JBATCH_SPEC)
    return {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}


def _device_slices(tree, prefix):
    """{name: {device index: numpy slice}} of a sharded JAX tree."""
    out = {}
    for name, leaf in flatten_params(tree):
        out[f"{prefix}/{name}"] = {jax.devices().index(s.device): np.asarray(s.data)
                                   for s in leaf.addressable_shards}
    return out


def _adam(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))


def _jax_run(jparams, batch, axes, steps, accum=1):
    mesh = jmake_mesh(jax.devices()[:WORLD], **axes)
    state = jtrain.init_train_state(JCFG, jax.random.PRNGKey(0), mesh=mesh, learning_rate=LR)
    step = jtrain.make_train_step(JCFG, mesh, learning_rate=LR, accum_steps=accum)
    jb = _jax_batch(batch, mesh)
    ms = []
    for _ in range(steps):
        state, m = step(state, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = _adam(state.opt_state)
    sl = {**_device_slices(state.params, "params"), **_device_slices(adam.mu, "mu"),
          **_device_slices(adam.nu, "nu")}
    return {"metrics": ms, "slices": sl}


def _port_run(jparams, batch, steps, accum=1):
    st = ttrain.init_train_state(TCFG, params=params_from_numpy(_numpy(jparams), "cpu"),
                                 device="cpu", learning_rate=LR)
    step = ttrain.make_train_step(TCFG, None, learning_rate=LR, accum_steps=accum)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        st, m = step(st, tb)
        ms.append({k: float(v) for k, v in m.items()})
    return {"metrics": ms, "state": st}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_sharded")
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    jl = jlora.lora_init(JCFG, jparams, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:4, 6:] = 0.0      # rows of fsdp 0: 6 tokens each, fsdp 1's whole rows
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    _save_npz(tmp / "params.npz", jparams)
    _save_npz(tmp / "lora.npz", jl)
    np.savez(tmp / "batch.npz", **batch, loss_mask=mask)
    np.save(tmp / "tokens.npy", rng.integers(0, JCFG.vocab_size, 40 * (S + 1)).astype(np.int32))
    t0 = time.monotonic()
    procs = run_ranks(tmp)
    try:
        # The references, while the ranks run.
        ref = {name: _jax_run(jparams, batch, axes, 3) for name, axes in LAYOUTS.items()}
        ref["accum"] = _jax_run(jparams, batch, LAYOUTS["f2m2"], 1, accum=2)
        ref["mask"] = _jax_run(jparams, {**batch, "loss_mask": mask}, LAYOUTS["f2m2"], 1)
        port = {"plain": _port_run(jparams, batch, 3),
                "accum": _port_run(jparams, batch, 1, accum=2),
                "mask": _port_run(jparams, {**batch, "loss_mask": mask}, 1)}
        jmesh = jmake_mesh(jax.devices()[:WORLD], **LAYOUTS["f2m2"])
        base = jshard_tree(jmesh, jparams)
        lst = jlora.init_lora_state(JCFG, base, jax.random.PRNGKey(1), rank=4, mesh=jmesh,
                                    learning_rate=LORA_LR)
        lstep = jlora.make_lora_train_step(JCFG, jmesh, rank=4, learning_rate=LORA_LR)
        jb = _jax_batch(batch, jmesh)
        lm = []
        for _ in range(2):
            lst, m = lstep(lst, base, jb)
            lm.append({k: float(v) for k, v in m.items()})
        adam = _adam(lst.opt_state)
        ref["lora"] = {"metrics": lm, "slices": {
            **_device_slices(lst.lora, "lora"), **_device_slices(adam.mu, "mu"),
            **_device_slices(adam.nu, "nu")}}
        dmesh = jmake_mesh(jax.devices()[:WORLD], **LAYOUTS["d2f2"])
        jloader = jdata.BatchLoader(jdata.TokenDataset(str(tmp / "tokens.npy"), S), 8,
                                    mesh=dmesh, seed=11, prefetch=1)
        ref["rows"] = [next(jloader) for _ in range(2)]
        jloader.close()
    finally:
        res = join_ranks(procs)
    res["_seconds"] = time.monotonic() - t0
    print(f"four ranks, every case, with the references: {res['_seconds']:.1f}s")
    return dict(res=res, ref=ref, port=port, tmp=tmp, batch=batch, jparams=jparams)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rank_slices(runs, case, rank):
    z = np.load(runs["tmp"] / f"{case}_rank{rank}.npz")
    return {k: z[k] for k in z.files}


def _unsharded_slices(runs, state, rank, axes):
    """Rank `rank`'s slices of the port's unsharded state under `axes`."""
    mesh = tsh.Mesh(torch.device("cpu"), dict(zip(tsh.AXES, (
        axes.get("data", 1), axes.get("fsdp", 1), 1, axes.get("model", 1), 1))),
        group=object(), rank=rank, backend="gloo", layout="training")
    out = {}
    for group, tree in (("params", state.params), ("mu", state.opt_state.mu),
                        ("nu", state.opt_state.nu)):
        specs = dict(flatten_params(tsh.param_specs(tree)))
        for k, t in flatten_params(tree):
            out[f"{group}/{k}"] = tsh.shard(t.detach(), specs[k], mesh).numpy()
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_metrics_equal_jax_mesh_step_and_unsharded_step(runs, layout):
    got = runs["res"][layout]["metrics"]
    want, plain = runs["ref"][layout]["metrics"], runs["port"]["plain"]["metrics"]
    for rank_metrics in got:
        assert rank_metrics == got[0]  # equal on every rank
    for step, (g, w, p) in enumerate(zip(got[0], want, plain)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{k} {step}")
            np.testing.assert_allclose(g[k], p[k], rtol=METRIC_RTOL, err_msg=f"{k} {step}")
        assert g["router_aux"] == 0.0
    assert got[0][-1]["loss"] < got[0][0]["loss"]  # the loss falls


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rank_slices_equal_jax_device_shards_after_three_steps(runs, layout):
    ref = runs["ref"][layout]["slices"]
    for rank in range(WORLD):
        got = _rank_slices(runs, layout, rank)
        plain = _unsharded_slices(runs, runs["port"]["plain"]["state"], rank, LAYOUTS[layout])
        assert sorted(got) == sorted(ref)
        for name, per_device in ref.items():
            assert got[name].shape == per_device[rank].shape, name
            assert _rel_l2(got[name], per_device[rank]) <= SLICE_REL, (name, rank)
            assert _rel_l2(got[name], plain[name]) <= SLICE_REL, (name, rank)


def test_accum_steps_on_the_mesh(runs):
    got = runs["res"]["accum"]["metrics"][0][0]
    for ref in (runs["ref"]["accum"]["metrics"][0], runs["port"]["accum"]["metrics"][0]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL, err_msg=k)
    ref = runs["ref"]["accum"]["slices"]
    for rank in range(WORLD):
        got_sl = _rank_slices(runs, "accum", rank)
        for name, per_device in ref.items():
            assert _rel_l2(got_sl[name], per_device[rank]) <= SLICE_REL, (name, rank)


def test_remat_full_gathers_again_in_backward_and_keeps_the_step(runs):
    """Under remat "full" the block body, and so its fsdp gathers, runs
    again in backward: twice the layer gathers of the step without remat,
    and the same metrics and slices."""
    got, plain = runs["res"]["remat"], runs["res"]["f4"]
    layers = 7 * TCFG.n_layers  # the gathered weights of every layer, once
    assert got["all_gathers"] == plain["all_gathers"] + 3 * layers
    for g, w in zip(got["metrics"][0], runs["ref"]["f4"]["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=k)
    ref = runs["ref"]["f4"]["slices"]
    for rank in range(WORLD):
        sl = _rank_slices(runs, "remat", rank)
        for name, per_device in ref.items():
            assert _rel_l2(sl[name], per_device[rank]) <= SLICE_REL, (name, rank)


def test_uneven_mask_gives_the_global_mean(runs):
    got = runs["res"]["mask"]["metrics"]
    assert all(m == got[0] for m in got)
    got = got[0][0]
    for ref in (runs["ref"]["mask"]["metrics"][0], runs["port"]["mask"]["metrics"][0]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL, err_msg=k)
    # The mean of the two fsdp rows' means is another number: the gate
    # can tell them apart.
    b = runs["batch"]
    logits = jtrain.forward(JCFG, runs["jparams"], jnp.asarray(b["inputs"]))
    nll = np.asarray(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, jnp.asarray(b["targets"])[..., None], -1)[..., 0])
    mask = np.load(runs["tmp"] / "batch.npz")["loss_mask"]
    per_rank = [float((nll[r] * mask[r]).sum() / mask[r].sum()) for r in (slice(0, 4), slice(4, 8))]
    assert abs(np.mean(per_rank) - got["loss"]) > 100 * METRIC_RTOL * got["loss"]


def test_batch_loader_rows_equal_jax_addressable_shards(runs):
    want = runs["ref"]["rows"]
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"rows_rank{rank}.npz")
        for i, jb in enumerate(want):
            for k in ("inputs", "targets"):
                shard = next(s for s in jb[k].addressable_shards
                             if s.device == jax.devices()[rank])
                np.testing.assert_array_equal(z[f"{k}{i}"], np.asarray(shard.data))


def test_synthetic_batch_gives_each_rank_its_rows_of_one_global_batch(runs):
    whole = ttrain.synthetic_batch(TCFG, 8, S, seed=5, device="cpu")
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"rows_rank{rank}.npz")
        row = runs["res"]["f2m2"]["coords"]["fsdp"] * 4 if rank == 0 else (rank // 2) * 4
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(z[f"syn_{k}"], whole[k][row:row + 4].numpy())


def test_checkpoint_restores_layout_free_bit_for_bit(runs):
    ck = runs["tmp"] / "ckpt"
    res = runs["res"]["ckpt"]
    # The restored whole leaves on (fsdp 4) and (fsdp 2, model 2) equal the
    # saved ones bit for bit, and so does a one-device restore.
    tmpl = ttrain.init_train_state(TCFG, params=params_from_numpy(_numpy(runs["jparams"]),
                                                                   "cpu"),
                                   device="cpu", learning_rate=LR)
    one = tckpt.restore_latest(ck, tmpl)
    assert one.step == 1 and one.opt_state.count == 1
    saved = {**{k: t.detach().numpy() for k, t in flatten_params(one.params)},
             **{f"mu/{k}": t.numpy() for k, t in flatten_params(one.opt_state.mu)}}
    for name in ("f4", "f2m2"):
        z = np.load(runs["tmp"] / f"restored_{name}.npz")
        assert sorted(z.files) == sorted(saved)
        for k in z.files:
            np.testing.assert_array_equal(z[k], saved[k], err_msg=f"{name} {k}")
        assert res["resumed"][name][:2] == [1, 1]
    # The next steps: the same mesh repeats the uninterrupted run bit for
    # bit; another mesh and one device within the metric tolerance.
    assert res["resumed"]["f2m2"][2:] == res["uninterrupted"]
    step = ttrain.make_train_step(TCFG, None, learning_rate=LR)
    tb = {k: torch.from_numpy(v) for k, v in runs["batch"].items()}
    for i, want in enumerate(res["uninterrupted"]):
        one, m = step(one, tb)
        for got in (res["resumed"]["f4"][2 + i], {k: float(v) for k, v in m.items()}):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)


def test_lora_step_on_fsdp2_model2_equals_jax(runs):
    got = runs["res"]["lora"]["metrics"]
    assert all(m == got[0] for m in got)
    for step, (g, w) in enumerate(zip(got[0], runs["ref"]["lora"]["metrics"])):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{k} {step}")
    ref = runs["ref"]["lora"]["slices"]
    for rank in range(WORLD):
        sl = _rank_slices(runs, "lora", rank)
        assert sorted(sl) == sorted(ref)
        for name, per_device in ref.items():
            assert sl[name].shape == per_device[rank].shape, name
            assert _rel_l2(sl[name], per_device[rank]) <= LORA_REL, (name, rank)


def test_spec_tables_and_rank_slices_equal_the_reference(runs):
    """PARAM_SPECS over params and moments, and rank r's slices of the
    unsharded params, against JAX device r's NamedSharding slices."""
    jparams = runs["jparams"]
    for name, axes in LAYOUTS.items():
        jmesh = jmake_mesh(jax.devices()[:WORLD], **axes)
        want = {k: tuple(s.spec) for k, s in flatten_params(param_shardings(jmesh, jparams))}
        tp = params_from_numpy(_numpy(jparams), "cpu")
        assert dict(flatten_params(tsh.param_specs(tp))) == want
        placed = jshard_tree(jmesh, jparams)
        for rank in range(WORLD):
            mesh = tsh.Mesh(torch.device("cpu"), dict(zip(tsh.AXES, (
                axes.get("data", 1), axes.get("fsdp", 1), 1, axes.get("model", 1), 1))),
                group=object(), rank=rank, backend="gloo", layout="training")
            cut = dict(flatten_params(tsh.shard_tree(mesh, tp)))
            for k, leaf in flatten_params(placed):
                shard = next(s for s in leaf.addressable_shards if s.device == jax.devices()[rank])
                np.testing.assert_array_equal(cut[k].numpy(), np.asarray(shard.data))


def test_collectives_ran_on_every_rank(runs):
    for st in runs["res"]["stats"]:
        assert st["all_gathers"] > 0 and st["reduce_scatters"] > 0 and st["all_reduces"] > 0


# -- the entry point ----------------------------------------------------------------


def test_fine_tune_over_four_ranks_trains_exports_and_resumes(tmp_path):
    """`fine_tune --model-parallel 2 --ranks 4` (model 2 x fsdp 2) on the
    CPU: rank 0 starts three followers, the batch rounds up to fsdp, the
    export is whole and what native_server serves, a rerun resumes."""
    from dstack_tpu_torch.native_server import Engine
    from dstack_tpu_torch.workloads.weights import load_packed

    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny", "--seq-len", "32", "--batch-size", "3",
            "--model-parallel", "2", "--ranks", "4", "--checkpoint-dir", str(ck)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([*argv, "--steps", "2"], capture_output=True, text=True,
                         timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "batch size 3 -> 4 (divisible by 2)" in out.stdout
    assert "4 ranks over gloo (fsdp 2 x model 2)" in out.stdout
    assert out.stdout.count("training complete") == 1  # rank 0 alone prints
    packed = load_packed(ck, "cpu")
    assert packed["layers"]["wq"].shape == (2, 128, 128)  # whole, not a rank's slice
    eng = Engine("tiny", 4, checkpoint_dir=str(ck), device="cpu")
    try:
        assert eng.weights_via == "packed"
        for k, t in flatten_params(packed):
            assert torch.equal(dict(flatten_params(eng.params))[k], t), k
    finally:
        eng.serving.close()
    again = subprocess.run([*argv, "--steps", "3"], capture_output=True, text=True,
                           timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout and "step 2: loss" in again.stdout


@pytest.mark.parametrize("flag,what", [
    (["--model-parallel", "2", "--seq-parallel", "2"], "3c"),
    (["--model-parallel", "2", "--expert-parallel", "2"], "3d"),
    (["--preset", "tiny-moe", "--model-parallel", "2"], "3d"),
])
def test_fine_tune_over_ranks_still_refuses_seq_expert_and_moe(flag, what):
    from dstack_tpu_torch import fine_tune

    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {what}"):
        fine_tune.main(["--device", "cpu", "--preset", "tiny", *flag])


def test_sigterm_drains_every_rank_once_and_a_relaunch_resumes(tmp_path):
    """SIGTERM to rank 0 of `fine_tune --model-parallel 2`: the ranks
    agree on the step, one checkpoint is written from both ranks' shards,
    every rank exits 113 (rank 0 reaps its follower), and a relaunch
    resumes there."""
    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny", "--seq-len", "32", "--batch-size", "2",
            "--model-parallel", "2", "--checkpoint-dir", str(ck)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([*argv, "--steps", "100000"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("step 10: loss"):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += out.splitlines()
    assert proc.returncode == ttrain.DRAIN_EXIT_CODE, (lines, err[-3000:])
    saved = [ln for ln in lines if ln.startswith("drain: checkpoint saved at step")]
    assert len(saved) == 1  # rank 0 alone writes and prints
    step = int(saved[0].split("at step ")[1].split()[0])
    assert step >= 11 and [p.name for p in ck.iterdir() if p.name.isdigit()] == [str(step)]
    left = subprocess.run(["ps", "-eo", "args"], capture_output=True, text=True).stdout
    assert str(ck) not in left  # no rank outlives the drain
    again = subprocess.run([*argv, "--steps", str(step + 1)], capture_output=True, text=True,
                           timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert again.returncode == 0, again.stderr[-3000:]
    assert f"resumed from step {step}" in again.stdout
