"""The port's GPipe pipeline (workloads/pipeline.py) against the JAX
package's `make_pipeline_train_step` on `jax.devices()[:k]` (tiny, 4
layers, f32, on the CPU): tests/test_pipeline.py's cases, an uneven mask
across data shards, the shared replicas equal on every stage, and
`train_pipeline` as a subprocess.

Four gloo ranks run `WORKER`: fresh interpreters that import no JAX, load
the bridged weights and batches from `.npz` files, run (data 1, pipe 4)
and (data 2, pipe 2) in one group, then ranks 0-1 run (data 1, pipe 2) in
a second group of two; each writes its stage's slices and metrics back.
This process computes the JAX references meanwhile from the same numpy
weights (rank r of a port pipeline mesh holds what JAX device r holds).

Tolerances, at about 3x the largest gap measured on the CPU, with PR 14's
bounds (tests/test_torch_train_sharded.py) as the ceiling: loss and
grad_norm 5e-7 relative against JAX's pipeline step and the port's
unsharded step (measured 1.7e-7); each stage's param, mu and nu slices
after the steps by each leaf's rel_l2 1e-5 (measured 3.0e-6: the
microbatches' grads summed in another order meet Adam's normalised step
near eps); the shared leaves' replicas bit for bit.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from dstack_tpu.workloads import pipeline as jpipe
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import pipeline as tpipe
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import (
    flatten_params,
    params_from_numpy,
    stage_state_from_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
JCFG = JPRESETS["tiny"].with_(n_layers=4, remat=False, dtype="float32")
TCFG = PRESETS["tiny"].with_(n_layers=4, remat=False, dtype="float32")
WORLD = 4
JOIN_S = 150
LR = 3e-4
S = 32
N_MICRO = 2
METRIC_RTOL = 5e-7
SLICE_REL = 1e-5


WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import pipeline, sharding
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import flatten_params

rank, wdir = int(sys.argv[1]), sys.argv[2]
ARGS = json.loads(sys.argv[3])
CFG = PRESETS["tiny"].with_(n_layers=4, remat=False, dtype="float32")
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


def every(x, n):
    out = [None] * n
    dist.all_gather_object(out, x)
    return out


results = {}


def run(name, cfg, params, batch, steps, data, pipe):
    mesh = pipeline.make_pipeline_mesh(["cpu"], data=data, pipe=pipe)
    st = pipeline.init_pipeline_state(cfg, 0, mesh, params=params,
                                      learning_rate=ARGS["lr"])
    step = pipeline.make_pipeline_train_step(cfg, mesh, n_microbatches=ARGS["micro"],
                                             learning_rate=ARGS["lr"])
    rows = pipeline.data_rows(batch, mesh)
    ms = []
    for _ in range(steps):
        st, m = step(st, rows)
        ms.append({k: float(v) for k, v in m.items()})
    np.savez(f"{wdir}/{name}_rank{rank}.npz",
             **{f"{g}/{k}": t.detach().numpy().copy()
                for g, tree in (("params", st.params), ("mu", st.opt_state.mu),
                                ("nu", st.opt_state.nu))
                for k, t in flatten_params(tree)})
    n = data * pipe
    results[name] = {"metrics": every(ms, n), "coords": every(mesh.coords, n),
                     "hops": every(mesh.stats["hops"], n), "rows": list(rows["inputs"].shape)}


PARAMS, P2, B4, B8 = load("params"), load("params2"), load("batch4"), load("batch8")
sharding.init_ranks(4, rank, ARGS["init4"], backend="gloo", device="cpu")
run("p4", CFG, PARAMS, {k: B4[k] for k in ("inputs", "targets")}, 1, 1, 4)
run("p4_mask", CFG, PARAMS, B4, 1, 1, 4)
run("d2p2", CFG, PARAMS, {k: B8[k] for k in ("inputs", "targets")}, 3, 2, 2)
run("d2p2_mask", CFG, PARAMS, B8, 1, 2, 2)
out4 = dict(results)
dist.destroy_process_group()
if rank < 2:
    results.clear()
    sharding.init_ranks(2, rank, ARGS["init2"], backend="gloo", device="cpu")
    run("p2", CFG.with_(n_layers=2), P2, load("batch2"), 2, 1, 2)
    if rank == 0:
        print("RESULT " + json.dumps({**out4, **results}), flush=True)
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


def run_ranks(tmp: Path):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    stamp = time.monotonic_ns()
    args = json.dumps({"lr": LR, "micro": N_MICRO,
                       "init4": f"file://{tmp / f'rdv4-{stamp}'}",
                       "init2": f"file://{tmp / f'rdv2-{stamp}'}"})
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    return [subprocess.Popen([sys.executable, str(script), str(r), str(tmp), args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT), start_new_session=True)
            for r in range(WORLD)]


def join_ranks(procs, timeout: float = JOIN_S) -> dict:
    """Wait for every rank within `timeout` seconds, else kill them (a
    deadlocked schedule fails here instead of hanging)."""
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


def _jax_pipeline(cfg, batch, steps, data, pipe):
    mesh = jpipe.make_pipeline_mesh(jax.devices()[:data * pipe], data=data, pipe=pipe)
    state = jpipe.init_pipeline_state(cfg, jax.random.PRNGKey(0), mesh, learning_rate=LR)
    step = jpipe.make_pipeline_train_step(cfg, mesh, n_microbatches=N_MICRO, learning_rate=LR)
    sh = NamedSharding(mesh, P("data"))
    jb = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        state, m = step(state, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    whole = {**{f"params/{k}": np.asarray(v) for k, v in flatten_params(state.params)},
             **{f"mu/{k}": np.asarray(v) for k, v in flatten_params(adam.mu)},
             **{f"nu/{k}": np.asarray(v) for k, v in flatten_params(adam.nu)}}
    return {"metrics": ms, "whole": whole}


def _port_unsharded(cfg, jparams, batch, steps):
    st = ttrain.init_train_state(cfg, params=params_from_numpy(_numpy(jparams), "cpu"),
                                 device="cpu", learning_rate=LR)
    step = ttrain.make_train_step(cfg, None, learning_rate=LR)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ms = []
    for _ in range(steps):
        st, m = step(st, tb)
        ms.append({k: float(v) for k, v in m.items()})
    return {"metrics": ms, "state": st}


def _batch(rng, b, s=S):
    tok = rng.integers(0, JCFG.vocab_size, (b, s + 1)).astype(np.int32)
    return {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    jparams2 = jinit(JCFG.with_(n_layers=2), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    b4, b8, b2 = _batch(rng, 4), _batch(rng, 8), _batch(rng, 4, 16)
    mask4 = np.zeros((4, S), np.float32)
    mask4[:, :8] = 1.0  # only the first 8 positions count (test_pipeline.py)
    mask8 = np.ones((8, S), np.float32)
    mask8[:4, 6:] = 0.0  # data shard 0: 6 tokens a row; shard 1 whole rows
    _save_npz(tmp / "params.npz", jparams)
    _save_npz(tmp / "params2.npz", jparams2)
    np.savez(tmp / "batch4.npz", **b4, loss_mask=mask4)
    np.savez(tmp / "batch8.npz", **b8, loss_mask=mask8)
    np.savez(tmp / "batch2.npz", **b2)
    t0 = time.monotonic()
    procs = run_ranks(tmp)
    try:
        ref = {"p4": _jax_pipeline(JCFG, b4, 1, 1, 4),
               "p4_mask": _jax_pipeline(JCFG, {**b4, "loss_mask": mask4}, 1, 1, 4),
               "d2p2": _jax_pipeline(JCFG, b8, 3, 2, 2),
               "d2p2_mask": _jax_pipeline(JCFG, {**b8, "loss_mask": mask8}, 1, 2, 2),
               "p2": _jax_pipeline(JCFG.with_(n_layers=2), b2, 2, 1, 2)}
        port = {"p2": _port_unsharded(TCFG.with_(n_layers=2), jparams2, b2, 2),
                "p4_mask": _port_unsharded(TCFG, jparams, {**b4, "loss_mask": mask4}, 1),
                "d2p2_mask": _port_unsharded(TCFG, jparams, {**b8, "loss_mask": mask8}, 1)}
    finally:
        res = join_ranks(procs)
    res["_seconds"] = time.monotonic() - t0
    print(f"four ranks and two, every case, with the references: {res['_seconds']:.1f}s")
    return dict(res=res, ref=ref, port=port, tmp=tmp, jparams=jparams, b4=b4, mask4=mask4)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rank(runs, case, rank):
    z = np.load(runs["tmp"] / f"{case}_rank{rank}.npz")
    return {k: z[k] for k in z.files}


def _stage_of_whole(whole, stage):
    """Stage `stage`'s share of a JAX pipeline state's whole leaves."""
    return {k: v[stage:stage + 1] if "/layers/" in k else v for k, v in whole.items()}


def test_stage_params_round_trip_equals_jax():
    """(L, ...) -> (P, L/P, ...) as the reference's, and back."""
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    tp = params_from_numpy(_numpy(jparams), "cpu")
    staged = tpipe.stage_params(TCFG, tp, 4)
    jstaged = jpipe.stage_params(JCFG, jparams, 4)
    assert staged["layers"]["wq"].shape[:2] == (4, 1)
    for k, t in flatten_params(staged):
        np.testing.assert_array_equal(t.numpy(), np.asarray(dict(flatten_params(jstaged))[k]))
    wq = staged["layers"]["wq"]
    np.testing.assert_array_equal(wq.reshape(TCFG.n_layers, *wq.shape[2:]).numpy(),
                                  np.asarray(jparams["layers"]["wq"]))
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.stage_params(TCFG, tp, 3)


def test_stage_state_from_numpy_is_init_pipeline_states_stage():
    """The JAX pipeline state bridged stage by stage equals the port's own
    init from the same params (moments zero), leaf for leaf."""
    jmesh = jpipe.make_pipeline_mesh(jax.devices()[:2], data=1, pipe=2)
    jstate = jax.device_get(jpipe.init_pipeline_state(JCFG, jax.random.PRNGKey(0), jmesh))
    mesh = tpipe.make_pipeline_mesh(["cpu"], data=1, pipe=1)
    whole = params_from_numpy(_numpy(jinit(JCFG, jax.random.PRNGKey(0))), "cpu")
    for stage in range(2):
        got = stage_state_from_numpy(_numpy(jstate), stage, "cpu")
        staged = tpipe.stage_slice(tpipe.stage_params(TCFG, whole, 2), stage)
        assert got.step == 0 and got.opt_state.count == 0
        for (k, a), (k2, b) in zip(flatten_params(got.params), flatten_params(staged)):
            assert k == k2 and a.requires_grad
            np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
        for _, t in flatten_params(got.opt_state.nu):
            assert not t.any()
    assert mesh.shape == {"data": 1, "pipe": 1} and mesh.coords == {"data": 0, "pipe": 0}


def test_rank_coordinates_are_the_reference_reshape(runs):
    """Rank r at (r // pipe, r % pipe), as np.array(devices).reshape(data, pipe)."""
    assert runs["res"]["d2p2"]["coords"] == [{"data": r // 2, "pipe": r % 2} for r in range(4)]
    assert runs["res"]["p4"]["coords"] == [{"data": 0, "pipe": r} for r in range(4)]


@pytest.mark.parametrize("case", ["p4", "p4_mask", "d2p2", "d2p2_mask", "p2"])
def test_pipeline_metrics_equal_jax_pipeline_step(runs, case):
    got = runs["res"][case]["metrics"]
    assert all(m == got[0] for m in got)  # equal on every rank
    for step, (g, w) in enumerate(zip(got[0], runs["ref"][case]["metrics"])):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{k} {step}")


@pytest.mark.parametrize("case", ["d2p2", "p2"])
def test_every_stage_slice_equals_jax_after_the_steps(runs, case):
    whole = runs["ref"][case]["whole"]
    n = len(runs["res"][case]["coords"])
    for rank in range(n):
        stage = runs["res"][case]["coords"][rank]["pipe"]
        want = _stage_of_whole(whole, stage)
        got = _rank(runs, case, rank)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            assert _rel_l2(got[k], v) <= SLICE_REL, (k, rank)


def test_shared_replicas_stay_equal_on_every_stage_bit_for_bit(runs):
    for case in ("d2p2", "p4"):
        ranks = [_rank(runs, case, r) for r in range(4)]
        for k in ranks[0]:
            if "/layers/" not in k:
                for r in range(1, 4):
                    np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"{case} {k}")


def test_pipeline_against_the_ports_unsharded_step(runs):
    """(data 1, pipe 2) is the unsharded step: the same loss and grad_norm
    and, after two steps, the same params and moments."""
    got, plain = runs["res"]["p2"]["metrics"][0], runs["port"]["p2"]
    for g, p in zip(got, plain["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], p[k], rtol=METRIC_RTOL, err_msg=k)
    st = plain["state"]
    whole = {**{f"params/{k}": t.detach() for k, t in flatten_params(st.params)},
             **{f"mu/{k}": t for k, t in flatten_params(st.opt_state.mu)},
             **{f"nu/{k}": t for k, t in flatten_params(st.opt_state.nu)}}
    for rank in range(2):
        got_sl = _rank(runs, "p2", rank)
        for k, t in whole.items():
            want = t.numpy()
            if "/layers/" in k:
                want = want.reshape(2, 1, *want.shape[1:])[rank:rank + 1]
            assert _rel_l2(got_sl[k], want) <= SLICE_REL, (k, rank)


def test_loss_mask_is_honoured(runs):
    """Masked tokens drop out of the pipelined loss: with one data shard it
    is the trainer's masked mean, and another number than the unmasked."""
    got = runs["res"]["p4_mask"]["metrics"][0][0]["loss"]
    np.testing.assert_allclose(got, runs["port"]["p4_mask"]["metrics"][0]["loss"],
                               rtol=METRIC_RTOL)
    ref, _ = jtrain.loss_fn(JCFG, runs["jparams"],
                            {**runs["b4"], "loss_mask": runs["mask4"]})
    np.testing.assert_allclose(got, float(ref), rtol=METRIC_RTOL)
    assert abs(got - runs["res"]["p4"]["metrics"][0][0]["loss"]) > 1e-3


def test_uneven_mask_across_data_shards_follows_the_reference_pmean(runs):
    """The reference averages the data shards' masked means; with a mask
    that counts 6 tokens a row on shard 0 and 32 on shard 1 that is not
    the global token mean the trainer takes, and the pipeline follows the
    reference."""
    got = runs["res"]["d2p2_mask"]["metrics"][0][0]["loss"]
    np.testing.assert_allclose(got, runs["ref"]["d2p2_mask"]["metrics"][0]["loss"],
                               rtol=METRIC_RTOL)
    trainer = runs["port"]["d2p2_mask"]["metrics"][0]["loss"]
    assert abs(got - trainer) > 100 * METRIC_RTOL * got


def test_exchanges_per_step(runs):
    """Each stage receives each microbatch's input and sends its output on
    in forward, and the grads back in backward: 2 exchanges per
    microbatch per inner boundary of a stage."""
    for case, pipe in (("p4", 4), ("d2p2", 2)):
        hops = runs["res"][case]["hops"]
        steps = len(runs["res"][case]["metrics"][0])
        for r, h in enumerate(hops):
            stage = runs["res"][case]["coords"][r]["pipe"]
            sides = (stage > 0) + (stage < pipe - 1)
            assert h == steps * N_MICRO * 2 * sides, (case, r)


def test_pipeline_mesh_needs_the_world():
    with pytest.raises(ValueError, match="data\\*pipe"):
        tpipe.make_pipeline_mesh(["cpu"], data=1, pipe=2)


def test_train_pipeline_over_four_ranks_runs(tmp_path):
    """`train_pipeline --stages 2 --ranks 4` on the CPU: data 2 x pipe 2,
    the batch rounded to microbatches x data, rank 0 alone prints."""
    argv = [sys.executable, "-m", "dstack_tpu_torch.train_pipeline", "--device", "cpu",
            "--preset", "tiny", "--stages", "2", "--ranks", "4", "--seq-len", "32",
            "--batch-size", "5", "--microbatches", "2", "--steps", "3"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    out = subprocess.run(argv, capture_output=True, text=True, timeout=JOIN_S, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "batch size 5 -> 8 (divisible by 4)" in out.stdout
    assert "4 ranks (data 2 x pipe 2), 2 microbatches" in out.stdout
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in out.stdout.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert out.stdout.count("training complete") == 1
