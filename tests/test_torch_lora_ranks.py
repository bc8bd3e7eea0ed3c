"""LoRA over ranks on the port against the JAX package's
`make_lora_train_step` on the same mesh (f32, on the CPU): on a
mixture-of-experts config and an expert axis, and on the row-parallel
targets.

Four gloo ranks run every case of `WORKER` in one process group: fresh
interpreters that import no JAX, load the bridged base, adapters and batch
from `.npz` files, and write each rank's adapter slices and metrics back.
While they run, this process computes the JAX references on
`make_mesh(jax.devices()[:4], ...)` from the same numpy arrays (rank r of a
port mesh holds what JAX device r holds).

The cases: tiny-moe with the default targets (wq, wv) over (expert 2,
data 2), (expert 2, fsdp 2), (expert 2, model 2), (seq 2, expert 2) and
(fsdp 2, model 2); tiny with the targets (wq, wo, w_up, w_down), two of
them row-parallel (wo, w_down: "model" on the input dim, "fsdp" on the
output), over (model 2, data 2) and (fsdp 2, model 2). Tolerances are
tests/test_torch_train_sharded.py's: loss and grad_norm 5e-7 relative
after each of 3 steps, each rank's adapter, mu and nu slices by each
leaf's rel_l2 2e-5 against JAX device r's shards (the layout-free
checkpoint rests on that). Two mutants must fail: the column targets'
grads also summed over expert (every rank of an expert line already holds
the whole grad, so the sum doubles it: grad_norm), and a row target's
whole-factor grads summed over the column targets' axes (each factor
misses the blocks of one axis: grad_norm).
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
from jax.sharding import NamedSharding

from dstack_tpu.workloads import lora as jlora
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.sharding import shard_tree as jshard_tree
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads.weights import flatten_params

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 150
LORA_LR, RANK = 1e-3, 4
B, S = 8, 32
ROWS = ("wq", "wo", "w_up", "w_down")
# case -> (preset, targets, mesh axes)
CASES = {
    "moe_e2d2": ("tiny-moe", ("wq", "wv"), dict(expert=2, data=2)),
    "moe_e2f2": ("tiny-moe", ("wq", "wv"), dict(expert=2, fsdp=2)),
    "moe_e2m2": ("tiny-moe", ("wq", "wv"), dict(expert=2, model=2)),
    "moe_s2e2": ("tiny-moe", ("wq", "wv"), dict(seq=2, expert=2)),
    "moe_f2m2": ("tiny-moe", ("wq", "wv"), dict(fsdp=2, model=2)),
    "rows_m2d2": ("tiny", ROWS, dict(model=2, data=2)),
    "rows_f2m2": ("tiny", ROWS, dict(fsdp=2, model=2)),
}
# mutant -> the sound case it is run on
MUTANTS = {"summed_over_expert": "moe_e2d2", "column_axes": "rows_f2m2"}
METRIC_RTOL = 5e-7
LORA_REL = 2e-5


WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import lora, sharding
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import flatten_params

rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
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


BATCH = load("batch")
sharding.init_ranks(4, rank, init, backend="gloo", device="cpu")
MESHES = {}
results = {}


def run(name, case, steps, save=True):
    preset, targets, axes = ARGS["cases"][case]
    key = json.dumps(axes, sort_keys=True)
    if key not in MESHES:
        MESHES[key] = sharding.make_mesh(["cpu"], layout="training", **axes)
    mesh, cfg = MESHES[key], PRESETS[preset].with_(dtype="float32")
    base = sharding.shard_tree(mesh, load(f"params_{preset}"))
    st = lora.init_lora_state(cfg, base, 0, rank=ARGS["rank"], targets=targets, mesh=mesh,
                              lora=load(f"lora_{case}"), learning_rate=ARGS["lr"])
    step = lora.make_lora_train_step(cfg, mesh, rank=ARGS["rank"], learning_rate=ARGS["lr"])
    rows = sharding.shard_batch(BATCH, mesh)
    out = []
    for _ in range(steps):
        st, m = step(st, base, rows)
        out.append({k: float(v) for k, v in m.items()})
    if save:
        np.savez(f"{wdir}/{name}_rank{rank}.npz", **{
            f"{g}/{k}": t.detach().numpy().copy()
            for g, tree in (("lora", st.lora), ("mu", st.opt_state.mu), ("nu", st.opt_state.nu))
            for k, t in flatten_params(tree)})
    every = [None] * 4
    dist.all_gather_object(every, {"metrics": out, "coords": mesh.coords})
    results[name] = every


for case in ARGS["cases"]:
    run(case, case, 3)

# The mutants: the column targets' grads summed over expert too, and a
# row target's whole-factor grads summed over the column targets' axes.
axes, gathered = lora._LORA_GRAD_AXES, lora._gathered_grad_axes
lora._LORA_GRAD_AXES = {k: v + ("expert",) for k, v in axes.items()}
try:
    run("summed_over_expert", ARGS["mutants"]["summed_over_expert"], 1, save=False)
finally:
    lora._LORA_GRAD_AXES = axes
lora._gathered_grad_axes = lambda spec, suffix: axes[suffix]
try:
    run("column_axes", ARGS["mutants"]["column_axes"], 1, save=False)
finally:
    lora._gathered_grad_axes = gathered

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
    args = json.dumps({"cases": CASES, "mutants": MUTANTS, "lr": LORA_LR, "rank": RANK})
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


def _jax_run(jparams, batch, case, steps=3):
    preset, targets, axes = CASES[case]
    mesh = jmake_mesh(jax.devices()[:WORLD], **axes)
    cfg = JPRESETS[preset].with_(dtype="float32")
    base = jshard_tree(mesh, jparams[preset])
    st = jlora.init_lora_state(cfg, base, jax.random.PRNGKey(1), rank=RANK, targets=targets,
                               mesh=mesh, learning_rate=LORA_LR)
    step = jlora.make_lora_train_step(cfg, mesh, rank=RANK, learning_rate=LORA_LR)
    sh = NamedSharding(mesh, JBATCH_SPEC)
    jb = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        st, m = step(st, base, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in st.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    return {"metrics": ms, "slices": {**_device_slices(_at_init_layout(st.lora, mesh), "lora"),
                                      **_device_slices(_at_init_layout(adam.mu, mesh), "mu"),
                                      **_device_slices(_at_init_layout(adam.nu, mesh), "nu")}}


def _at_init_layout(tree, mesh):
    """`tree` laid out as JAX's init_lora_state places adapters and moments
    (`_lora_specs`: A on fsdp, B on model). The jitted step's outputs take
    the shardings GSPMD propagates, which for a row target's factors are
    not that layout; the values are the same."""
    specs = jlora._lora_specs(tree)
    return jax.tree_util.tree_map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  tree, specs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lora_ranks")
    jparams = {p: jinit(JPRESETS[p].with_(dtype="float32"), jax.random.PRNGKey(0))
               for p in ("tiny", "tiny-moe")}
    for preset, params in jparams.items():
        _save_npz(tmp / f"params_{preset}.npz", params)
    for case, (preset, targets, _) in CASES.items():
        cfg = JPRESETS[preset].with_(dtype="float32")
        _save_npz(tmp / f"lora_{case}.npz", jlora.lora_init(
            cfg, jparams[preset], jax.random.PRNGKey(1), rank=RANK, targets=targets))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    np.savez(tmp / "batch.npz", **batch)
    t0 = time.monotonic()
    procs = run_ranks(tmp)
    try:
        ref = {case: _jax_run(jparams, batch, case) for case in CASES}
    finally:
        res = join_ranks(procs)
    print(f"four ranks, every case, with the references: {time.monotonic() - t0:.1f}s")
    return dict(res=res, ref=ref, tmp=tmp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_metrics(got, want, keys=("loss", "grad_norm"), what=""):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{what} {k} {step}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_lora_step_metrics_equal_jax_mesh_step(runs, case):
    """loss and grad_norm after each of 3 steps, equal on every rank,
    against JAX's make_lora_train_step on the same mesh."""
    every = runs["res"][case]
    got = every[0]["metrics"]
    for r in every:
        assert r["metrics"] == got
    _check_metrics(got, runs["ref"][case]["metrics"], what=case)
    assert got[-1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_adapter_slices_equal_jax_device_shards(runs, case):
    """Each rank's A, B and their moments after 3 steps are JAX device
    r's shards of them (A on fsdp, B on model, for every target)."""
    ref = runs["ref"][case]["slices"]
    for rank in range(WORLD):
        z = np.load(runs["tmp"] / f"{case}_rank{rank}.npz")
        assert sorted(z.files) == sorted(ref)
        for name, per_device in ref.items():
            assert z[name].shape == per_device[rank].shape, name
            assert _rel_l2(z[name], per_device[rank]) <= LORA_REL, (name, rank)


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_each_grad_sum_mutant_fails_the_grad_norm_gate(runs, mutant):
    """The grads summed over expert on an expert line, or a row target's
    whole-factor grads summed over the column targets' axes: the first
    step's grad_norm moves far past the gate that passes the sound ranks."""
    got = runs["res"][mutant][0]["metrics"][0]
    want = runs["ref"][MUTANTS[mutant]]["metrics"][0]
    assert abs(got["grad_norm"] - want["grad_norm"]) > 100 * METRIC_RTOL * want["grad_norm"]
    with pytest.raises(AssertionError):
        _check_metrics([got], [want], keys=("grad_norm",))


def test_fine_tune_lora_on_an_expert_axis_trains_exports_and_resumes(tmp_path):
    """`fine_tune --preset tiny-moe --lora-rank 4 --expert-parallel 2
    --ranks 2` on the CPU: the export is the merged params, whole; a rerun
    resumes from the adapter checkpoint."""
    from dstack_tpu_torch.workloads.weights import load_packed

    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny-moe", "--seq-len", "32", "--batch-size", "2",
            "--lora-rank", "4", "--expert-parallel", "2", "--ranks", "2",
            "--checkpoint-dir", str(ck)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([*argv, "--steps", "2"], capture_output=True, text=True,
                         timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "2 ranks over gloo (expert 2)" in out.stdout and "LoRA rank 4" in out.stdout
    assert "step 1: loss" in out.stdout and out.stdout.count("training complete") == 1
    packed = load_packed(ck, "cpu")
    assert packed["layers"]["wq"].shape == (2, 128, 128)  # merged, whole
    assert packed["layers"]["we_gate"].shape == (2, 4, 128, 256)
    assert "wq_a" not in packed["layers"]
    again = subprocess.run([*argv, "--steps", "3"], capture_output=True, text=True,
                           timeout=JOIN_S, env=env, cwd=str(ROOT))
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout and "step 2: loss" in again.stdout
