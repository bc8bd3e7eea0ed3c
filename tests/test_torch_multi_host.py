"""The port's training entry points across hosts, on the CPU: a gang of
host processes that join from the orchestrator's own environment
(`dstack_tpu.parallel.env.make_cluster_env` for N hosts on 127.0.0.1 with
a free coordinator port), against the JAX package's mesh step and against
the same ranks started on one host.

Each "host" is a process given its host's variables; it starts its
host's other ranks itself. Tolerances against JAX are
tests/test_torch_train_sharded.py's (loss and grad_norm 5e-7 relative,
each rank's slices rel_l2 1.2e-5 after 3 AdamW steps); against the same
ranks on one host, bit for bit (the same collectives over the same global
ranks).
"""

import json
import os
import re
import signal
import socket
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

from dstack_tpu.models.runs import ClusterInfo
from dstack_tpu.parallel.env import jax_initialize_kwargs, make_cluster_env
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import BATCH_SPEC as JBATCH_SPEC
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch import fine_tune, train_pipeline
from dstack_tpu_torch.workloads import sharding as tsh
from dstack_tpu_torch.workloads.train import DRAIN_EXIT_CODE
from dstack_tpu_torch.workloads.weights import flatten_params

ROOT = Path(__file__).resolve().parents[1]
JCFG = JPRESETS["tiny"].with_(dtype="float32")
JOIN_S = 150
LR = 3e-4
B, S = 8, 32
F2M2 = dict(fsdp=2, model=2)
METRIC_RTOL = 5e-7
SLICE_REL = 1.2e-5
GANG_VARS = (tsh.COORDINATOR_ENV, tsh.PROCESS_ID_ENV, tsh.NUM_PROCESSES_ENV)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def base_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in GANG_VARS}
    return {**env, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def host_envs(hosts: int, port: int) -> list:
    """Each host's environment, as the orchestrator renders it."""
    cluster = ClusterInfo(job_ips=["127.0.0.1"] * hosts, master_job_ip="127.0.0.1",
                          coordinator_port=port)
    return [{**base_env(), **make_cluster_env(cluster, h)} for h in range(hosts)]


def start(argv, env) -> subprocess.Popen:
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=str(ROOT), start_new_session=True)


def finish(procs, timeout: float = JOIN_S) -> list:
    """(rc, stdout, stderr) of every process within `timeout` seconds in
    all; whatever is still running then is killed."""
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
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def gang_run(argv, hosts: int = 2, timeout: float = JOIN_S) -> list:
    """`argv` run on every host of a gang of `hosts`."""
    return finish([start(argv, env) for env in host_envs(hosts, free_port())], timeout)


def left_behind(marker: str) -> list:
    """Processes whose command names `marker`, anchored on the interpreter."""
    ps = subprocess.run(["ps", "-eo", "args"], capture_output=True, text=True).stdout
    return [ln for ln in ps.splitlines() if marker in ln and "python" in ln.split(" ")[0]]


# -- the mesh step over two hosts against JAX ----------------------------------------

WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import sharding, train
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import flatten_params

wdir, tag = sys.argv[1], sys.argv[2]
flag = lambda name, default: (sys.argv[sys.argv.index(name) + 1] if name in sys.argv
                              else default)
rank, init = int(flag("--rank", 0)), flag("--dist-init", "")
CFG = PRESETS["tiny"].with_(dtype="float32")
LR = __LR__
torch.set_num_threads(1)
gang = sharding.gang_from_env(os.environ, 4)
mesh, followers = sharding.join_ranks(4, rank, init, "gloo", "cpu", sys.argv[:3],
                                      layout="training", gang=gang, fsdp=2, model=2)


def load(name):
    z, tree = np.load(f"{wdir}/{name}.npz"), {}
    for k in z.files:
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(z[k].copy())
    return tree


batch = load("batch")
st = train.init_train_state(CFG, params=load("params"), device="cpu", mesh=mesh,
                            learning_rate=LR)
step = train.make_train_step(CFG, mesh, learning_rate=LR)
rows = sharding.shard_batch(batch, mesh)
out = []
for _ in range(3):
    st, m = step(st, rows)
    out.append({k: float(v) for k, v in m.items()})
np.savez(f"{wdir}/{tag}_rank{mesh.rank}.npz",
         **{f"{g}/{k}": t.detach().numpy().copy()
            for g, tree in (("params", st.params), ("mu", st.opt_state.mu),
                            ("nu", st.opt_state.nu))
            for k, t in flatten_params(tree)})
me = {"rank": mesh.rank, "metrics": out, "coords": mesh.coords,
      "host": os.environ.get("JAX_PROCESS_ID"),
      "card": str(sharding.rank_device(mesh.rank, gang)),
      "leader": not init, "followers": len(followers)}
every = [None] * 4
dist.all_gather_object(every, me)
if mesh.rank == 0:
    print("RESULT " + json.dumps(every), flush=True)
sharding.leave_ranks(mesh)
sharding.stop_followers(followers)
os._exit(0)
'''


def _jax_batch(batch, mesh):
    sh = NamedSharding(mesh, JBATCH_SPEC)
    return {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}


def _device_slices(tree, prefix):
    out = {}
    for name, leaf in flatten_params(tree):
        out[f"{prefix}/{name}"] = {jax.devices().index(s.device): np.asarray(s.data)
                                   for s in leaf.addressable_shards}
    return out


def _jax_mesh_run(batch, steps):
    mesh = jmake_mesh(jax.devices()[:4], **F2M2)
    state = jtrain.init_train_state(JCFG, jax.random.PRNGKey(0), mesh=mesh, learning_rate=LR)
    step = jtrain.make_train_step(JCFG, mesh, learning_rate=LR)
    jb = _jax_batch(batch, mesh)
    ms = []
    for _ in range(steps):
        state, m = step(state, jb)
        ms.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    return {"metrics": ms, "slices": {**_device_slices(state.params, "params"),
                                      **_device_slices(adam.mu, "mu"),
                                      **_device_slices(adam.nu, "nu")}}


def _result(rc_out_err) -> list:
    rc, out, err = rc_out_err
    assert rc == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi_host")
    jparams = jinit(JCFG, jax.random.PRNGKey(0))
    np.savez(tmp / "params.npz", **{k: np.asarray(v) for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, jparams))})
    tok = np.random.default_rng(7).integers(0, JCFG.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    np.savez(tmp / "batch.npz", **batch)
    script = tmp / "worker.py"
    script.write_text(WORKER.replace("__LR__", repr(LR)))
    argv = [sys.executable, str(script), str(tmp)]
    one = start([*argv, "one"], base_env())
    hosts = [start([*argv, "two"], env) for env in host_envs(2, free_port())]
    try:
        ref = _jax_mesh_run(batch, 3)
    finally:
        done = finish([one, *hosts])
    return dict(tmp=tmp, ref=ref, one=_result(done[0]), two=_result(done[1]),
                host1=done[2])


def _slices(tmp, tag, rank):
    z = np.load(tmp / f"{tag}_rank{rank}.npz")
    return {k: z[k] for k in z.files}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_two_hosts_place_ranks_in_jax_device_order(mesh_runs):
    """Global rank = JAX_PROCESS_ID x 2 + the index on the host; each
    host's process leads its host and starts one follower; a rank's card
    is its index on its host."""
    two = mesh_runs["two"]
    assert [r["rank"] for r in two] == [0, 1, 2, 3]
    assert [r["host"] for r in two] == ["0", "0", "1", "1"]
    assert [r["leader"] for r in two] == [True, False, True, False]
    assert [r["followers"] for r in two] == [1, 0, 1, 0]
    assert [r["card"] for r in two] == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert [r["card"] for r in mesh_runs["one"]] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert [r["coords"] for r in two] == [r["coords"] for r in mesh_runs["one"]]
    assert mesh_runs["host1"][0] == 0 and "RESULT" not in mesh_runs["host1"][1]


def test_two_host_step_equals_the_jax_mesh_step(mesh_runs):
    want = mesh_runs["ref"]["metrics"]
    for r in mesh_runs["two"]:
        for step, (g, w) in enumerate(zip(r["metrics"], want)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=f"{k} {step}")
    ref = mesh_runs["ref"]["slices"]
    for rank in range(4):
        got = _slices(mesh_runs["tmp"], "two", rank)
        assert sorted(got) == sorted(ref)
        for name, per_device in ref.items():
            assert got[name].shape == per_device[rank].shape, name
            assert _rel_l2(got[name], per_device[rank]) <= SLICE_REL, (name, rank)


def test_two_host_step_equals_one_host_bit_for_bit(mesh_runs):
    assert [r["metrics"] for r in mesh_runs["two"]] == [r["metrics"] for r in mesh_runs["one"]]
    for rank in range(4):
        two, one = _slices(mesh_runs["tmp"], "two", rank), _slices(mesh_runs["tmp"], "one", rank)
        assert sorted(two) == sorted(one)
        for k in one:
            np.testing.assert_array_equal(two[k], one[k], err_msg=f"{k} rank {rank}")


# -- fine_tune and train_pipeline over two hosts ----------------------------------------

FT = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu", "--preset",
      "tiny", "--seq-len", "32", "--batch-size", "3", "--model-parallel", "2", "--ranks", "4"]


def test_fine_tune_over_two_hosts_exports_as_one_host_and_resumes(tmp_path):
    one_dir, two_dir = tmp_path / "one", tmp_path / "two"
    one = start([*FT, "--steps", "2", "--checkpoint-dir", str(one_dir)], base_env())
    hosts = [start([*FT, "--steps", "2", "--checkpoint-dir", str(two_dir)], env)
             for env in host_envs(2, free_port())]
    (rc1, out1, err1), *done = finish([one, *hosts])
    assert rc1 == 0, err1[-3000:]
    for h, (rc, out, err) in enumerate(done):
        assert rc == 0, err[-3000:]
        assert f"process {h}/2 runs ranks {2 * h}-{2 * h + 1} of 4" in out
    out0, out1_host = done[0][1], done[1][1]
    assert out0.count("training complete") == 1 and "training complete" not in out1_host
    assert "4 ranks over gloo (fsdp 2 x model 2)" in out0
    for name in ("manifest.json", "weights.bin"):
        assert (two_dir / "packed" / name).read_bytes() == (one_dir / "packed" / name).read_bytes()
    again = gang_run([*FT, "--steps", "3", "--checkpoint-dir", str(two_dir)])
    for rc, out, err in again:
        assert rc == 0, err[-3000:]
    assert "resumed from step 2" in again[0][1] and "step 2: loss" in again[0][1]


def test_sigterm_to_one_host_drains_every_rank_once_and_a_relaunch_resumes(tmp_path):
    """SIGTERM to host 1's process alone: every rank of both hosts agrees
    on one step, one checkpoint is written, every process exits 113 and
    none is left; the gang relaunched resumes there."""
    ck = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "dstack_tpu_torch.fine_tune", "--device", "cpu",
            "--preset", "tiny", "--seq-len", "32", "--batch-size", "2", "--model-parallel",
            "2", "--ranks", "4", "--checkpoint-dir", str(ck)]
    hosts = [start([*argv, "--steps", "100000"], env) for env in host_envs(2, free_port())]
    lines = []
    try:
        for line in hosts[0].stdout:
            lines.append(line.strip())
            if line.startswith("step 10: loss"):
                hosts[1].send_signal(signal.SIGTERM)
                break
    finally:
        done = finish(hosts)
    lines += done[0][1].splitlines()
    for rc, out, err in done:
        assert rc == DRAIN_EXIT_CODE, (lines, err[-3000:])
    saved = [ln for ln in lines + done[1][1].splitlines()
             if ln.startswith("drain: checkpoint saved at step")]
    assert len(saved) == 1  # global rank 0 alone writes and prints
    step = int(saved[0].split("at step ")[1].split()[0])
    assert step >= 11 and [p.name for p in ck.iterdir() if p.name.isdigit()] == [str(step)]
    time.sleep(1.5)  # a follower notices its leader's exit within a second
    assert left_behind(str(ck)) == []
    again = gang_run([*argv, "--steps", str(step + 1)])
    for rc, out, err in again:
        assert rc == 0, err[-3000:]
    assert f"resumed from step {step}" in again[0][1]


def _step_lines(out: str) -> list:
    """The step lines less their wall seconds."""
    return [ln.rsplit(" (", 1)[0] for ln in out.splitlines() if ln.startswith("step ")]


def test_train_pipeline_over_two_hosts_steps_as_one_host():
    argv = [sys.executable, "-m", "dstack_tpu_torch.train_pipeline", "--device", "cpu",
            "--preset", "tiny", "--stages", "2", "--ranks", "4", "--seq-len", "32",
            "--batch-size", "5", "--microbatches", "2", "--steps", "3"]
    one = start(argv, base_env())
    hosts = [start(argv, env) for env in host_envs(2, free_port())]
    done = finish([one, *hosts])
    for rc, out, err in done:
        assert rc == 0, err[-3000:]
    steps = _step_lines(done[1][1])  # steps 0 and 2 print
    assert [ln.split(":")[0] for ln in steps] == ["step 0", "step 2"]
    assert steps == _step_lines(done[0][1])
    assert "4 ranks (data 2 x pipe 2), 2 microbatches" in done[1][1]
    assert [ln for ln in done[2][1].splitlines()] == ["process 1/2 runs ranks 2-3 of 4"]


def test_hosts_that_run_different_commands_fail_on_every_rank_naming_the_flag():
    procs = [start([*FT, "--steps", str(2 + h)], env)
             for h, env in enumerate(host_envs(2, free_port()))]
    done = finish(procs)
    for rc, out, err in done:
        assert rc != 0
        # the leader's and its follower's message, both naming the flag
        assert err.count("differs from rank 0 at --steps") == 2, err[-3000:]
    time.sleep(1.5)
    assert left_behind("--steps 3 --rank 3") == []


# -- the pure mapping ---------------------------------------------------------------------


def _env(hosts, host_id, port=8476):
    return host_envs(hosts, port)[host_id]


def test_the_gang_reads_what_jax_distributed_initialize_reads():
    for hosts in (2, 4):
        for h in range(hosts):
            env = _env(hosts, h)
            kw = jax_initialize_kwargs(env)
            gang = tsh.gang_from_env(env, 8)
            assert (gang.coordinator, gang.hosts, gang.host_id) == (
                kw["coordinator_address"], kw["num_processes"], kw["process_id"])


@pytest.mark.parametrize("hosts,per_host", [(2, 1), (2, 2), (2, 4), (4, 2), (3, 3)])
def test_global_rank_local_index_and_card(hosts, per_host):
    world = hosts * per_host
    for h in range(hosts):
        gang = tsh.gang_from_env(_env(hosts, h), world)
        assert gang.per_host == per_host
        assert list(gang.ranks) == [h * per_host + i for i in range(per_host)]
        for i, rank in enumerate(gang.ranks):
            assert gang.local(rank) == i
            assert tsh.rank_device(rank, gang) == torch.device("cuda", i)
            assert tsh.rank_device(rank, gang, "cpu") == torch.device("cpu")
            assert tsh.rank_device(rank, gang, "cuda:0") == torch.device("cuda", 0)
        others = [r for r in range(world) if r not in gang.ranks]
        for rank in others:  # a rank of another host is never this host's
            with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
                gang.local(rank)


def test_global_rank_3_of_two_hosts_of_two_is_cuda_1():
    gang = tsh.gang_from_env(_env(2, 1), 4)
    assert tsh.rank_device(3, gang) == torch.device("cuda", 1)
    assert gang.describe(4) == "process 1/2 runs ranks 2-3 of 4"
    assert tsh.rank_device(3, None) == torch.device("cuda", 3)  # one host


@pytest.mark.parametrize("env", [{}, {"JAX_NUM_PROCESSES": "1"}, {
    "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0", "JAX_COORDINATOR_ADDRESS": "h:1"}])
def test_no_gang_without_more_than_one_process(env):
    assert tsh.gang_from_env(env, 4) is None


def test_check_backend_counts_this_hosts_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    gang = tsh.gang_from_env(_env(2, 1), 4)
    tsh.check_backend("nccl", 4, None, gang)  # 2 ranks on this host's 2 cards
    with pytest.raises(ValueError, match="4 ranks on 2 card"):
        tsh.check_backend("nccl", 4, None)
    with pytest.raises(ValueError, match="2 ranks of this host on every rank on cuda:0"):
        tsh.check_backend("nccl", 4, torch.device("cuda:0"), gang)
    env = _env(2, 1)
    assert tsh.gang_world(env, None, None, 1) == (4, gang)  # every card of every host
    assert tsh.gang_world(env, None, "cpu", 1)[0] == 2  # one rank a host on a named device
    assert tsh.gang_world(env, 6, None, 1)[0] == 6
    assert tsh.gang_world({}, None, None, 3) == (3, None)  # one host: the entry's default


REFUSALS = {
    "ranks_not_a_multiple": ({}, ["--ranks", "3"], "JAX_NUM_PROCESSES=2"),
    "process_id_missing": ({"JAX_PROCESS_ID": None}, [], "JAX_PROCESS_ID"),
    "process_id_out_of_range": ({"JAX_PROCESS_ID": "2"}, [], "JAX_PROCESS_ID='2'"),
    "process_id_negative": ({"JAX_PROCESS_ID": "-1"}, [], "JAX_PROCESS_ID='-1'"),
    "coordinator_missing": ({"JAX_COORDINATOR_ADDRESS": None}, [], "JAX_COORDINATOR_ADDRESS"),
    "coordinator_without_port": ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1"}, [],
                                 "JAX_COORDINATOR_ADDRESS='127.0.0.1'"),
    "coordinator_bad_port": ({"JAX_COORDINATOR_ADDRESS": "h:99999"}, [],
                             "JAX_COORDINATOR_ADDRESS='h:99999'"),
    "num_processes_malformed": ({"JAX_NUM_PROCESSES": "two"}, [], "JAX_NUM_PROCESSES='two'"),
}


@pytest.mark.parametrize("entry", ["fine_tune", "train_pipeline"])
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_a_bad_gang_raises_before_any_process_starts(monkeypatch, entry, case):
    change, flags, names = REFUSALS[case]
    env = {k: v for k, v in _env(2, 1).items() if k in GANG_VARS}
    env.update(change)
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    started = []
    monkeypatch.setattr(tsh, "spawn_followers", lambda *a: started.append(a))
    monkeypatch.setattr(tsh, "init_ranks", lambda *a, **k: started.append(a))
    if entry == "fine_tune":
        main, argv = fine_tune.main, ["--device", "cpu", "--preset", "tiny"]
    else:
        main, argv = train_pipeline.main, ["--device", "cpu", "--preset", "tiny",
                                           "--stages", "2"]
    with pytest.raises(SystemExit, match="invalid gang: .*" + re.escape(names)):
        main(argv + (flags or ["--ranks", "4"]))
    assert started == []


@pytest.mark.parametrize("a,b,flag", [
    (["-m", "x", "--steps", "2"], ["-m", "x", "--steps", "3"], "--steps"),
    (["-m", "x", "--steps=2"], ["-m", "x", "--steps=3"], "--steps"),
    (["-m", "x", "--steps", "2"], ["-m", "x", "--preset", "tiny"], "--steps"),
    (["-m", "x"], ["-m", "x", "--lora-rank", "4"], "--lora-rank"),
    (["-m", "x"], ["-m", "y"], "-m"),
    (["a.py", "x"], ["b.py", "x"], "'a.py'"),
])
def test_first_difference_names_the_flag(a, b, flag):
    assert tsh.first_difference(a, b) == flag


def test_own_command_drops_the_rank_flags_a_leader_adds():
    argv = ["-m", "x", "--steps", "2", "--rank", "3", "--dist-init", "tcp://h:1",
            "--rank=1", "--dist-init=tcp://h:2"]
    assert tsh.own_command(argv) == ["-m", "x", "--steps", "2"]
