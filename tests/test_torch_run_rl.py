"""`python -m dstack_tpu_torch.run_rl`, the port of examples/rl/run_rl.py,
on the CPU: Anakin against `rl.run_anakin` in process, and a Sebulba gang
of three processes given the orchestrator's own environment
(`dstack_tpu.parallel.env.make_cluster_env` for three nodes on 127.0.0.1,
the refresh address moved to a free pair of ports)."""

import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from dstack_tpu.models.runs import ClusterInfo
from dstack_tpu.parallel.env import make_cluster_env
from dstack_tpu_torch import run_rl
from dstack_tpu_torch.workloads.rl import run_anakin, tiny_rl_config

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120
RL = [sys.executable, "-m", "dstack_tpu_torch.run_rl", "--device", "cpu"]
SMALL = ["--batch", "4", "--horizon", "4"]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_run_rl", ROOT / "examples/rl/run_rl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def free_pair() -> int:
    """A port p with p + 1 free too (the refresh server and the sink)."""
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        t = socket.socket()
        try:
            t.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
        finally:
            t.close()


def base_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DSTACK_", "JAX_COORDINATOR", "JAX_PROCESS", "JAX_NUM"))}
    return {**env, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def gang_envs(nodes: int) -> list:
    cluster = ClusterInfo(job_ips=["127.0.0.1"] * nodes, master_job_ip="127.0.0.1",
                          coordinator_port=free_pair())
    port = free_pair()
    return [{**base_env(), **make_cluster_env(cluster, n),
             "DSTACK_TPU_RL_REFRESH_ADDR": f"127.0.0.1:{port}"} for n in range(nodes)]


def finish(procs, timeout: float = JOIN_S) -> list:
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


def test_anakin_prints_run_anakin_bit_for_bit_in_the_jax_scripts_form():
    args = ["--updates", "4", *SMALL, "--seed", "1"]
    out = subprocess.run([*RL, "--mode", "anakin", *args], capture_output=True, text=True,
                         timeout=JOIN_S, env=base_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = run_anakin(tiny_rl_config(), updates=4, batch_size=4, horizon=4, seed=1,
                          refresh="direct", device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert got["rewards"] == want["rewards"] and len(got["rewards"]) == 4
    assert got["mode"] == "anakin" and got["final_weight_epoch"] == want["final_weight_epoch"]
    # The JAX script's keys, in its order.
    jax_out = _jax_script()
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_out.anakin_main(Namespace(updates=1, batch=2, horizon=2, seed=0))
    assert list(got) == list(json.loads(buf.getvalue()))


def test_sebulba_gang_of_three_runs_its_updates_and_every_member_exits():
    envs = gang_envs(3)
    argv = [*RL, "--mode", "sebulba", "--updates", "3", *SMALL, "--timeout", "60"]
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(ROOT), start_new_session=True)
             for env in envs]
    done = finish(procs)
    for node, (rc, out, err) in enumerate(done):
        assert rc == 0, (node, err[-3000:])
    learner = done[0][1].splitlines()
    updates = [ln for ln in learner if ln.startswith("update ")]
    assert [ln.split()[1] for ln in updates] == ["0:", "1:", "2:"]
    assert [ln.rsplit("epoch=", 1)[1] for ln in updates] == ["2", "3", "4"]
    assert any(ln.startswith("dstack_tpu_rl_env_steps_total") for ln in learner)
    assert "# TYPE dstack_tpu_rl_learn_step_seconds histogram" in learner
    for _, out, _ in done[1:]:
        assert out == ""  # actors print nothing


def test_sebulba_without_the_refresh_address_exits_with_the_jax_message(monkeypatch):
    for k in ("DSTACK_TPU_RL_REFRESH_ADDR",):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as port:
        run_rl.main(["--mode", "sebulba", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["run_rl.py", "--mode", "sebulba"])
    with pytest.raises(SystemExit) as ref:
        _jax_script().main()
    assert str(port.value) == str(ref.value) and "DSTACK_TPU_RL_REFRESH_ADDR" in str(ref.value)
    out = subprocess.run([*RL, "--mode", "sebulba"], capture_output=True, text=True,
                         timeout=JOIN_S, env=base_env(), cwd=str(ROOT))
    assert out.returncode == 1 and str(ref.value) in out.stderr


@pytest.mark.parametrize("nodes,flag,width", [("3", [], 2), ("5", [], 4),
                                              ("5", ["--gang-width", "2"], 2)])
def test_the_learner_folds_every_actor_of_the_gang(monkeypatch, nodes, flag, width):
    seen = {}

    class Stop(Exception):
        pass

    def learner(config, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setenv("DSTACK_NODES_NUM", nodes)
    monkeypatch.setenv("DSTACK_NODE_RANK", "0")
    monkeypatch.setenv("DSTACK_TPU_RL_REFRESH_ADDR", f"127.0.0.1:{free_pair()}")
    monkeypatch.setattr(run_rl, "Learner", learner)
    with pytest.raises(Stop):
        run_rl.main(["--mode", "sebulba", "--device", "cpu", *flag])
    assert seen["gang_width"] == width and seen["learning_rate"] == 2e-2
