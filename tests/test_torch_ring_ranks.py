"""The ring across ranks on the port against the JAX package's ring under
`shard_map` and its mesh step with a seq axis (tiny, f32, on the CPU).

Four gloo ranks run every case of `WORKER` in one process group: fresh
interpreters that import no JAX, load the bridged weights, batches and
attention inputs from `.npz` files, and write each rank's outputs, grads,
slices and metrics back. While they run, this process computes the JAX
references on `make_mesh(jax.devices()[:4], ...)` from the same numpy
arrays (rank r of a port mesh holds what JAX device r holds) and the
port's one-device ring and unsharded step.

Tolerances, at about 3x the largest gap measured on the CPU, with PR 14's
bounds (tests/test_torch_train_sharded.py) as the ceiling: `_RankRing`'s
output and its q, k and v grads by max |diff| 3e-6 against JAX's ring and
the port's one-device ring (measured 9.5e-7; entries are O(1)); loss and
grad_norm 5e-7 relative against JAX's mesh step and the port's unsharded
step (measured 1.6e-7); each rank's param, mu and nu slices after 3 AdamW
steps by each leaf's rel_l2 5e-6 (measured 1.5e-6); LoRA slices 2e-5, PR
14's ceiling (measured 1.27e-5: Adam's normalised step turns a
summation-order difference of an adapter grad near eps into up to one
step of ~lr); data rows and the checkpoint bit for bit.
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

from dstack_tpu.workloads import attention as jattention
from dstack_tpu.workloads import data as jdata
from dstack_tpu.workloads import lora as jlora
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.sharding import shard_tree as jshard_tree
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import attention as tattention
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
# The reference's seq layouts (tests/test_workloads.py:85-92, :115;
# tests/test_long_context.py:24-35), cut to four ranks.
LAYOUTS = {"s4": dict(seq=4), "s2m2": dict(seq=2, model=2), "f2s2": dict(fsdp=2, seq=2)}
# _RankRing alone: (B, S, H, KV, hd), GQA 2:1.
RING = (2, 32, 4, 2, 16)
RING_TOL = 3e-6
METRIC_RTOL = 5e-7
SLICE_REL = 5e-6
LORA_REL = 2e-5


WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import attention, checkpoint, sharding, train
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


PARAMS, LORA, BATCH, RING = load("params"), load("lora"), load("batch"), load("ring")
sharding.init_ranks(4, rank, init, backend="gloo", device="cpu")
MESHES = {name: sharding.make_mesh(["cpu"], layout="training", **axes)
          for name, axes in ARGS["layouts"].items()}
results = {}


def every(x):
    out = [None] * 4
    dist.all_gather_object(out, x)
    return out


# _RankRing alone on the seq-4 line: this rank's shard of q, k, v and of
# the cotangent; its output and its shard's grads.
mesh = MESHES["s4"]
sl = slice(rank * ARGS["ring_s"] // 4, (rank + 1) * ARGS["ring_s"] // 4)
ring_out, hops = {}, []
for causal in (True, False):
    h0 = mesh.stats["hops"]
    q, k, v = (RING[n][:, sl].clone().requires_grad_() for n in ("q", "k", "v"))
    out = attention.make_attention_fn(mesh, causal=causal)(q, k, v)
    torch.sum(out * RING["w"][:, sl]).backward()
    tag = "causal" if causal else "full"
    ring_out.update({f"{tag}/out": out.detach().numpy(), f"{tag}/dq": q.grad.numpy(),
                     f"{tag}/dk": k.grad.numpy(), f"{tag}/dv": v.grad.numpy()})
    hops.append(mesh.stats["hops"] - h0)
np.savez(f"{wdir}/ring_rank{rank}.npz", **ring_out)
results["ring_hops"] = every(hops)


def slices(state, what="params"):
    first = state.params if what == "params" else state.lora
    return {f"{g}/{k}": t.detach().numpy().copy()
            for g, tree in ((what, first), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))
            for k, t in flatten_params(tree)}


def metrics(m):
    return {k: float(v) for k, v in m.items()}


def run(name, mesh, steps, batch):
    st = train.init_train_state(CFG, params=clone(PARAMS), device="cpu", mesh=mesh,
                                learning_rate=ARGS["lr"])
    step = train.make_train_step(CFG, mesh, learning_rate=ARGS["lr"])
    rows = sharding.shard_batch(batch, mesh)
    h0 = mesh.stats["hops"]
    out = []
    for _ in range(steps):
        st, m = step(st, rows)
        out.append(metrics(m))
    np.savez(f"{wdir}/{name}_rank{rank}.npz", **slices(st))
    results[name] = {"metrics": every(out), "coords": mesh.coords,
                     "hops": every(mesh.stats["hops"] - h0),
                     "rows": list(rows["inputs"].shape)}
    return st


batch = {k: BATCH[k] for k in ("inputs", "targets")}
for name, mesh in MESHES.items():
    run(name, mesh, 3, batch)
run("mask", MESHES["s4"], 1, {**batch, "loss_mask": BATCH["loss_mask"]})

# Checkpoint: saved from (fsdp 2, seq 2) after one step; rank 0 also
# writes the whole leaves it was saved from.
st = run("ckpt", MESHES["f2s2"], 1, batch)
checkpoint.save(f"{wdir}/ckpt", st, wait=True, mesh=MESHES["f2s2"])
whole = {f"params/{k}": t.detach().numpy().copy() for k, t in
         flatten_params(sharding.unshard_tree(MESHES["f2s2"], st.params))}
whole.update({f"nu/{k}": t.numpy().copy() for k, t in
              flatten_params(sharding.unshard_tree(MESHES["f2s2"], st.opt_state.nu))})
if rank == 0:
    np.savez(f"{wdir}/ckpt_whole.npz", **whole)

# Batches: the loader's block and the synthetic batch's block of this rank.
loader = BatchLoader(TokenDataset(f"{wdir}/tokens.npy", ARGS["seq"]), 8,
                     mesh=MESHES["f2s2"], seed=11, prefetch=1)
got = [next(loader) for _ in range(2)]
loader.close()
syn = train.synthetic_batch(CFG, 8, ARGS["seq"], seed=5, mesh=MESHES["s4"])
np.savez(f"{wdir}/rows_rank{rank}.npz", **{f"{k}{i}": b[k].numpy() for i, b in
                                            enumerate(got) for k in b},
         syn_inputs=syn["inputs"].numpy(), syn_targets=syn["targets"].numpy())

# LoRA on (seq 2, model 2) from the JAX adapters, two steps.
mesh = MESHES["s2m2"]
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
results["lora"] = {"metrics": every(out), "coords": mesh.coords}
if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
dist.destroy_process_group()
# Everything is written: leave without the interpreter's teardown, where a
# process of many gloo groups once aborted ("terminate called without an
# active exception", rc 134) under load after its work was done.
sys.stdout.flush()
os._exit(0)
'''


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_npz(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_params(_numpy(tree))})


def run_ranks(tmp: Path, args: dict):
    """Start the four ranks of WORKER over gloo with a rendezvous file of
    their own; `join_ranks` collects them."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    rdv = tmp / f"rendezvous-{time.monotonic_ns()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    return [subprocess.Popen([sys.executable, str(script), str(r), f"file://{rdv}",
                              str(tmp), json.dumps(args)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT), start_new_session=True)
            for r in range(WORLD)]


def join_ranks(procs, timeout: float = JOIN_S) -> dict:
    """Wait for every rank within `timeout` seconds, else kill them (a
    deadlocked ring fails here instead of hanging); returns rank 0's
    results."""
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


def _jax_run(batch, axes, steps):
    mesh = jmake_mesh(jax.devices()[:WORLD], **axes)
    state = jtrain.init_train_state(JCFG, jax.random.PRNGKey(0), mesh=mesh, learning_rate=LR)
    step = jtrain.make_train_step(JCFG, mesh, learning_rate=LR)
    jb = _jax_batch(batch, mesh)
    ms = []
    for _ in range(steps):
        state, m = step(state, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = _adam(state.opt_state)
    return {"metrics": ms, "slices": {**_device_slices(state.params, "params"),
                                      **_device_slices(adam.mu, "mu"),
                                      **_device_slices(adam.nu, "nu")}}


def _port_run(jparams, batch, steps):
    st = ttrain.init_train_state(TCFG, params=params_from_numpy(_numpy(jparams), "cpu"),
                                 device="cpu", learning_rate=LR)
    step = ttrain.make_train_step(TCFG, None, learning_rate=LR)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        st, m = step(st, tb)
        ms.append({k: float(v) for k, v in m.items()})
    return {"metrics": ms}


def _jax_ring(ring, causal):
    """JAX's ring over a seq-4 mesh: the output and the q, k, v grads of
    sum(out * w)."""
    mesh = jmake_mesh(jax.devices()[:WORLD], seq=4)
    fn = jattention.make_attention_fn(mesh, causal=causal)
    q, k, v, w = (jnp.asarray(ring[n]) for n in ("q", "k", "v", "w"))

    def loss(q, k, v):
        with mesh:
            return jnp.sum(fn(q, k, v) * w)

    with mesh:
        out = fn(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"),
                                                                         grads)}}


def _one_device_ring(ring, causal):
    """The port's one-device ring over 4 shards: the same outputs and grads."""
    fn = tattention.make_attention_fn(tsh.make_mesh(["cpu"], seq=4), causal=causal)
    q, k, v = (torch.from_numpy(ring[n]).requires_grad_() for n in ("q", "k", "v"))
    out = fn(q, k, v)
    torch.sum(out * torch.from_numpy(ring["w"])).backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_ranks")
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    jl = jlora.lora_init(JCFG, jparams, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, S // 4:] = 0.0      # seq rank 0 keeps all its tokens, ranks 1-3 none
    mask[:2, S // 2:S // 2 + 3] = 1.0   # rank 2 a few of two rows
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    b, s, h, kv, hd = RING
    ring = {"q": rng.standard_normal((b, s, h, hd)), "k": rng.standard_normal((b, s, kv, hd)),
            "v": rng.standard_normal((b, s, kv, hd)), "w": rng.standard_normal((b, s, h, hd))}
    ring = {n: a.astype(np.float32) for n, a in ring.items()}
    _save_npz(tmp / "params.npz", jparams)
    _save_npz(tmp / "lora.npz", jl)
    np.savez(tmp / "batch.npz", **batch, loss_mask=mask)
    np.savez(tmp / "ring.npz", **ring)
    np.save(tmp / "tokens.npy", rng.integers(0, JCFG.vocab_size, 40 * (S + 1)).astype(np.int32))
    t0 = time.monotonic()
    procs = run_ranks(tmp, {"layouts": LAYOUTS, "lr": LR, "lora_lr": LORA_LR, "seq": S,
                            "ring_s": RING[1]})
    try:
        # The references, while the ranks run.
        ref = {name: _jax_run(batch, axes, 3) for name, axes in LAYOUTS.items()}
        ref["mask"] = _jax_run({**batch, "loss_mask": mask}, LAYOUTS["s4"], 1)
        ref["ring"] = {c: _jax_ring(ring, c == "causal") for c in ("causal", "full")}
        port = {"plain": _port_run(jparams, batch, 3),
                "mask": _port_run(jparams, {**batch, "loss_mask": mask}, 1),
                "ring": {c: _one_device_ring(ring, c == "causal") for c in ("causal", "full")}}
        jmesh = jmake_mesh(jax.devices()[:WORLD], **LAYOUTS["s2m2"])
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
        dmesh = jmake_mesh(jax.devices()[:WORLD], **LAYOUTS["f2s2"])
        jloader = jdata.BatchLoader(jdata.TokenDataset(str(tmp / "tokens.npy"), S), 8,
                                    mesh=dmesh, seed=11, prefetch=1)
        ref["rows"] = [next(jloader) for _ in range(2)]
        jloader.close()
    finally:
        res = join_ranks(procs)
    res["_seconds"] = time.monotonic() - t0
    print(f"four ranks, every case, with the references: {res['_seconds']:.1f}s")
    return dict(res=res, ref=ref, port=port, tmp=tmp, batch=batch, mask=mask,
                jparams=jparams, ring=ring)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rank_slices(runs, case, rank):
    z = np.load(runs["tmp"] / f"{case}_rank{rank}.npz")
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("causal", ["causal", "full"])
def test_rank_ring_forward_and_grads_equal_jax_ring_and_one_device_ring(runs, causal):
    sl = RING[1] // WORLD
    for rank in range(WORLD):
        got = _rank_slices(runs, "ring", rank)
        for name in ("out", "dq", "dk", "dv"):
            for ref in (runs["ref"]["ring"][causal], runs["port"]["ring"][causal]):
                want = ref[name][:, rank * sl:(rank + 1) * sl]
                assert got[f"{causal}/{name}"].shape == want.shape
                np.testing.assert_allclose(got[f"{causal}/{name}"], want, rtol=0,
                                           atol=RING_TOL, err_msg=f"{name} rank {rank}")


def test_rank_ring_makes_the_same_hops_on_every_rank(runs):
    """n - 1 hops forward and n backward on every rank, rank 0 of the causal
    ring (whose later shards are all empty) included."""
    assert runs["res"]["ring_hops"] == [[2 * WORLD - 1] * 2] * WORLD


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
    assert got[0][-1]["loss"] < got[0][0]["loss"]  # the loss falls
    # Each step's hops: (seq - 1) forward and seq backward per layer.
    n = LAYOUTS[layout]["seq"]
    assert runs["res"][layout]["hops"] == [3 * TCFG.n_layers * (2 * n - 1)] * WORLD


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rank_slices_equal_jax_device_shards_after_three_steps(runs, layout):
    ref = runs["ref"][layout]["slices"]
    for rank in range(WORLD):
        got = _rank_slices(runs, layout, rank)
        assert sorted(got) == sorted(ref)
        for name, per_device in ref.items():
            assert got[name].shape == per_device[rank].shape, name
            assert _rel_l2(got[name], per_device[rank]) <= SLICE_REL, (name, rank)


def test_rank_blocks_follow_batch_spec(runs):
    """A rank holds B/(data*fsdp) rows of S/seq positions."""
    for name, axes in LAYOUTS.items():
        rows = B // axes.get("fsdp", 1)
        assert runs["res"][name]["rows"] == [rows, S // axes["seq"]], name


def test_uneven_mask_over_seq_ranks_gives_the_global_mean(runs):
    got = runs["res"]["mask"]["metrics"]
    assert all(m == got[0] for m in got)
    got = got[0][0]
    for ref in (runs["ref"]["mask"]["metrics"][0], runs["port"]["mask"]["metrics"][0]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL, err_msg=k)
    # The mean of the seq ranks' own means is another number.
    b = runs["batch"]
    logits = jtrain.forward(JCFG, runs["jparams"], jnp.asarray(b["inputs"]))
    nll = np.asarray(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, jnp.asarray(b["targets"])[..., None], -1)[..., 0])
    mask, q = runs["mask"], S // 4
    per_rank = [float((nll[:, i:i + q] * mask[:, i:i + q]).sum() / mask[:, i:i + q].sum())
                for i in range(0, S, q) if mask[:, i:i + q].sum()]
    assert abs(np.mean(per_rank) - got["loss"]) > 100 * METRIC_RTOL * got["loss"]


def test_batch_loader_blocks_equal_jax_addressable_shards(runs):
    want = runs["ref"]["rows"]
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"rows_rank{rank}.npz")
        for i, jb in enumerate(want):
            for k in ("inputs", "targets"):
                shard = next(s for s in jb[k].addressable_shards
                             if s.device == jax.devices()[rank])
                np.testing.assert_array_equal(z[f"{k}{i}"], np.asarray(shard.data))


def test_synthetic_batch_gives_each_seq_rank_its_stretch(runs):
    whole = ttrain.synthetic_batch(TCFG, 8, S, seed=5, device="cpu")
    q = S // 4
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"rows_rank{rank}.npz")
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(z[f"syn_{k}"],
                                          whole[k][:, rank * q:(rank + 1) * q].numpy())


def test_checkpoint_from_seq_ranks_restores_on_one_device_bit_for_bit(runs):
    """Saved from (fsdp 2, seq 2) after one step: written once (the seq
    replicas hold the same slices), restored on one device into a fresh
    template equal to the whole leaves it was saved from."""
    ck = runs["tmp"] / "ckpt"
    assert [p.name for p in ck.iterdir() if p.name.isdigit()] == ["1"]
    tmpl = ttrain.init_train_state(TCFG, seed=3, device="cpu", learning_rate=LR)
    one = tckpt.restore_latest(ck, tmpl)
    assert one.step == 1 and one.opt_state.count == 1
    z = np.load(runs["tmp"] / "ckpt_whole.npz")
    got = {**{f"params/{k}": t.detach().numpy() for k, t in flatten_params(one.params)},
           **{f"nu/{k}": t.numpy() for k, t in flatten_params(one.opt_state.nu)}}
    for k in z.files:
        np.testing.assert_array_equal(got[k], z[k], err_msg=k)
    # The first step's loss is the one-device step's.
    np.testing.assert_allclose(runs["res"]["ckpt"]["metrics"][0][0]["loss"],
                               runs["port"]["plain"]["metrics"][0]["loss"], rtol=METRIC_RTOL)


def test_lora_step_on_seq2_model2_equals_jax(runs):
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


def test_rope_positions_offset_by_the_seq_rank(monkeypatch):
    """On a seq rank the rope positions are its stretch of the whole
    sequence, coords["seq"] * S_local + arange(S_local); off a seq axis
    they start at 0."""
    from dstack_tpu_torch.workloads import attention, transformer

    seen, rope = [], transformer._rope

    def spy(x, positions, theta):
        seen.append(positions.tolist())
        return rope(x, positions, theta)

    monkeypatch.setattr(transformer, "_rope", spy)
    tp = transformer.init_params(TCFG, 0, "cpu")
    q = S // 4
    tokens = torch.zeros((1, q), dtype=torch.int64)
    for rank in range(WORLD):
        mesh = tsh.Mesh(torch.device("cpu"), dict(zip(tsh.AXES, (1, 1, 4, 1, 1))),
                        group=object(), rank=rank, backend="gloo", layout="training")
        seen.clear()
        transformer.forward(TCFG, tp, tokens, attention_fn=attention.plain_attention,
                            mesh=mesh)
        assert seen and all(p == list(range(rank * q, (rank + 1) * q)) for p in seen)
    seen.clear()
    transformer.forward(TCFG, tp, tokens, mesh=tsh.make_mesh(["cpu"], seq=4))
    assert seen and all(p == list(range(q)) for p in seen)


# -- the entry point ----------------------------------------------------------------


def test_fine_tune_seq2_model2_over_four_ranks_trains_drains_and_resumes(tmp_path):
    """`fine_tune --seq-parallel 2 --model-parallel 2 --ranks 4` on the
    CPU: rank 0 starts three followers, the mesh is seq 2 x model 2, a
    SIGTERM after a step drains every rank with one checkpoint, and a
    relaunch resumes there."""
    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny", "--seq-len", "32", "--batch-size", "2",
            "--seq-parallel", "2", "--model-parallel", "2", "--ranks", "4",
            "--checkpoint-dir", str(ck)]
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
    assert any("4 ranks over gloo (seq 2 x model 2)" in ln for ln in lines), lines[:3]
    saved = [ln for ln in lines if ln.startswith("drain: checkpoint saved at step")]
    assert len(saved) == 1  # rank 0 alone writes and prints
    step = int(saved[0].split("at step ")[1].split()[0])
    assert step >= 11 and [p.name for p in ck.iterdir() if p.name.isdigit()] == [str(step)]
    left = subprocess.run(["ps", "-eo", "args"], capture_output=True, text=True).stdout
    assert str(ck) not in left  # no rank outlives the drain
    again = subprocess.run([*argv, "--steps", str(step + 2)], capture_output=True, text=True,
                           timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert again.returncode == 0, again.stderr[-3000:]
    assert f"resumed from step {step}" in again.stdout
    assert again.stdout.count("training complete") == 1
