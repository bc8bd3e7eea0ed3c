"""An expert axis on the serving mesh on the port against the JAX package
(tiny-moe, f32, on the CPU).

The engine serves over gloo rank processes that import no JAX: expert 2
(two ranks, each holding 2 of tiny-moe's 4 experts) and model 2 x expert 2
(four ranks), each a module fixture with its own deadline (JOIN_S). Rank 0
also runs each case on the port's unsharded engine, and this process runs
JAX's engine on `make_mesh(jax.devices()[:n], ...)` of the same shape.

Gates, at temperature 0: the streams token for token against the port's
unsharded engine at capacity factor 2.0 (= E/k, where no token drops) and
at the preset's 1.25, and against JAX's expert-mesh engine at 2.0 (and at
1.25, where JAX's expert mesh matches its own one device too); speculation
with the int8 MoE drafter (its banks cut as the target's), a refresh, and
on expert 2 LoRA, the host tier and the split roles against the unsharded
engine; and the mutant that swaps the two expert blocks in the outputs'
gather must change the streams.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu.workloads.transformer import init_params as jinit

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 150
JMCFG = JPRESETS["tiny-moe"].with_(dtype="float32")
CF_ALL = 2.0   # E / k: every token finds room
KW = dict(slots=4, max_len=128, kv_block_size=16)
SCENARIOS = [(list(range(1, 30)), 12), (list(range(3, 35)), 12),
             (list(range(5, 42)), 12), (list(range(7, 24)), 12)]
SPLIT_KW = dict(slots=4, max_len=128, kv_block_size=16, prefill_chunk_tokens=32)
MESHES = {"e2": dict(expert=2), "m2e2": dict(model=2, expert=2)}
RUNS = {"e2": ["cf2", "cf125", "spec", "refresh", "lora", "tier", "split", "mutant"],
        "m2e2": ["cf2", "cf125", "spec", "refresh", "mutant"]}

WORKER = r'''
import hashlib, json, os, sys, threading, time
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import moe, serving, sharding
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.lora_serving import demo_adapter

rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
ARGS = json.loads(sys.argv[4])
T0 = time.monotonic()
torch.set_num_threads(1)


def note(what):
    print(f"rank {rank} {what} at {time.monotonic() - T0:.1f}s", file=sys.stderr, flush=True)


def load(name):
    z, tree = np.load(f"{wdir}/{name}.npz"), {}
    for k in z.files:
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(z[k].copy())
    return tree


def drain(q):
    out = []
    while True:
        t = q.get(timeout=60)
        if t is None:
            return out
        if isinstance(t, BaseException):
            raise t
        out.append(int(t))


MCFG = PRESETS["tiny-moe"].with_(dtype="float32")
CF2 = MCFG.with_(capacity_factor=ARGS["cf_all"])
P = load("tiny_moe")
KW, SC = ARGS["kw"], ARGS["scenarios"]
world = ARGS["world"]
note("joining")
sharding.init_ranks(world, rank, init, backend="gloo", device="cpu")
mesh = sharding.make_mesh(["cpu"], **ARGS["axes"])
note("joined")
results = {}


def prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


def wave(eng, reqs):
    return [drain(eng.submit(p, n, temperature=0.0)) for p, n in reqs]


def serve_plain(eng):
    return {"streams": wave(eng, SC)}


def serve_spec(eng):
    return {"streams": wave(eng, [(p, 24) for p, _ in SC]),
            "rounds": eng.stats()["spec_rounds_total"]}


SCALED = {k: ({kk: vv * 0.75 for kk, vv in v.items()} if isinstance(v, dict) else v * 0.75)
          for k, v in P.items()}


def serve_refresh(eng):
    first = wave(eng, SC)
    dropped = eng.refresh_params(SCALED)
    return {"streams": first + wave(eng, SC), "dropped": dropped}


ADAPTERS = {name: demo_adapter(MCFG, P, seed, rank=4, scale=0.5)
            for name, seed in (("t1", 1), ("t2", 2))}


def serve_lora(eng):
    for name, tree in ADAPTERS.items():
        eng.load_adapter(name, tree)
    outs = [eng.submit(SC[0][0], 12, temperature=0.0, adapter=a) for a in ("t1", "t2", None)]
    return {"streams": [drain(q) for q in outs]}


def serve_tier(eng):
    p0 = prompt(1, 24)
    streams = [drain(eng.submit(p0, 8, temperature=0.0))]
    streams += [drain(eng.submit(prompt(s, 24), 8, temperature=0.0)) for s in range(2, 10)]
    streams.append(drain(eng.submit(p0, 8, temperature=0.0)))
    out = eng.submit(prompt(11, 20), 24, temperature=0.0)
    got = [out.get(timeout=60) for _ in range(4)]
    eng.preempt(out)
    streams.append(got + drain(out))
    st = eng.stats()
    return {"streams": streams, **{k: st[k] for k in (
        "kv_spills_total", "prefix_cache_host_hits_total", "kv_swap_ins_total")}}


TIER_KW = dict(slots=2, max_len=64, kv_pool_blocks=16, kv_block_size=8,
               prefill_chunk_tokens=16, kv_host_budget_bytes=32 << 20)
CASES = {
    "cf2": (CF2, KW, serve_plain),
    "cf125": (MCFG, KW, serve_plain),
    "spec": (CF2, {**KW, "spec_enable": True}, serve_spec),
    "refresh": (CF2, KW, serve_refresh),
    "lora": (CF2, {**KW, "lora_max_adapters": 2, "lora_rank": 4}, serve_lora),
    "tier": (CF2, TIER_KW, serve_tier),
    "mutant": (CF2, KW, serve_plain),
}
real_gather = moe.gather_experts


def swapped_blocks(x, dim, mesh=None):
    out = real_gather(x, dim, mesh)
    if not sharding.serves_experts(mesh):
        return out
    return torch.cat(out.chunk(mesh.shape["expert"], dim)[::-1], dim)


for name in ARGS["cases"]:
    if name not in CASES:
        continue
    note(f"case {name} starts")
    cfg, kw, serve = CASES[name]
    if name == "mutant":
        moe.gather_experts = swapped_blocks
    try:
        if rank:
            serving.run_follower(mesh, cfg, P, **kw)
        else:
            eng = serving.ServingEngine(cfg, P, mesh=mesh, **kw)
            try:
                eng.warmup()
                res = serve(eng)
            finally:
                eng.close()
            moe.gather_experts = real_gather
            ref = serving.ServingEngine(cfg, P, device="cpu", **kw)
            try:
                res["unsharded"] = serve(ref)
            finally:
                ref.close()
            results[name] = res
    finally:
        moe.gather_experts = real_gather
    note(f"case {name} ends")


class Bridge:
    def __init__(self, engine):
        self.engine, self.outs = engine, {}

    def send(self, h):
        h = h._replace(epoch=self.engine.handoff_epoch)
        self.outs[h.request_id] = self.engine.submit_prefilled(h)


def split(pre_mesh, dec_mesh):
    dev = None if dec_mesh else "cpu"
    dec = serving.ServingEngine(CF2, P, role="decode", mesh=dec_mesh, device=dev,
                                **ARGS["split_kw"])
    bridge = Bridge(dec)
    pre = serving.ServingEngine(CF2, P, role="prefill", kv_transfer=bridge, mesh=pre_mesh,
                                device=dev, **ARGS["split_kw"])
    try:
        pre.warmup()
        dec.warmup()
        outs = [pre.submit(p, n, request_id=i) for i, (p, n) in enumerate(SC)]
        got = {i: drain(q) for i, q in enumerate(outs)}
        for rid, q in bridge.outs.items():
            got[rid] = drain(q)
        return {"streams": [got[i] for i in range(len(SC))]}
    finally:
        pre.close()
        dec.close()


if "split" in ARGS["cases"]:
    note("case split starts")
    # Two engines serve at once over the same ranks: a group each.
    ma, mb = (sharding.make_mesh(["cpu"], group=dist.new_group(list(range(world))),
                                 **ARGS["axes"]) for _ in range(2))
    if rank:
        ts = [threading.Thread(target=serving.run_follower, args=(m, CF2, P),
                               kwargs={**ARGS["split_kw"], "role": r})
              for m, r in ((ma, "prefill"), (mb, "decode"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        results["split"] = split(ma, mb)
        results["split"]["unsharded"] = split(None, None)
    note("case split ends")

if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
sharding.leave_ranks(mesh)
note("done")
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
'''


def _save_npz(path, tree):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(jax.tree_util.tree_map(np.asarray, tree), "")
    np.savez(path, **flat)


def run_ranks(tmp: Path, name: str) -> dict:
    """The ranks of mesh `name` as subprocesses over gloo, with a
    rendezvous file of their own, joined within JOIN_S or killed; a rank
    that fails fails with every rank's stderr tail. Returns rank 0's
    results."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    world = int(np.prod(list(MESHES[name].values())))
    rdv = tmp / f"rendezvous-{time.monotonic_ns()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    args = json.dumps({"world": world, "axes": MESHES[name], "cases": RUNS[name],
                       "kw": KW, "scenarios": SCENARIOS, "split_kw": SPLIT_KW,
                       "cf_all": CF_ALL})
    procs = [subprocess.Popen([sys.executable, str(script), str(r), f"file://{rdv}",
                               str(tmp), args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(ROOT), start_new_session=True)
             for r in range(world)]
    deadline = time.monotonic() + JOIN_S
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
    tails = "\n".join(f"--- rank {r} (exit {p.returncode}) stderr:\n{err[-3000:]}"
                      for r, (p, (_, err)) in enumerate(zip(procs, outs)))
    assert not late, f"mesh {name}: the ranks were not done within {JOIN_S}s\n{tails}"
    for p in procs:
        assert p.returncode == 0, tails
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def jmoe():
    return jinit(JMCFG, jax.random.PRNGKey(0))


def _drain(q):
    out = []
    while True:
        t = q.get(timeout=120)
        if t is None:
            return out
        if isinstance(t, BaseException):
            raise t
        out.append(int(t))


def _jax_streams(params, cf, mesh_axes=None):
    mesh = None
    if mesh_axes is not None:
        n = int(np.prod(list(mesh_axes.values())))
        mesh = jmake_mesh(jax.devices()[:n], fsdp=1, **mesh_axes)
    eng = jsrv.ServingEngine(JMCFG.with_(capacity_factor=cf), params, mesh=mesh, **KW)
    try:
        return [_drain(eng.submit(p, n)) for p, n in SCENARIOS]
    finally:
        eng.close()


def _serve(tmp_path_factory, jmoe, name):
    tmp = tmp_path_factory.mktemp(f"serving_expert_{name}")
    _save_npz(tmp / "tiny_moe.npz", jmoe)
    t0 = time.monotonic()
    res = run_ranks(tmp, name)
    print(f"mesh {name}, cases {RUNS[name]}: {time.monotonic() - t0:.1f}s")
    return res


@pytest.fixture(scope="module")
def e2(tmp_path_factory, jmoe):
    return _serve(tmp_path_factory, jmoe, "e2")


@pytest.fixture(scope="module")
def m2e2(tmp_path_factory, jmoe):
    return _serve(tmp_path_factory, jmoe, "m2e2")


CASES = [(mesh, case) for mesh, cases in RUNS.items() for case in cases if case != "mutant"]


@pytest.mark.parametrize("mesh,case", CASES)
def test_expert_mesh_streams_equal_the_unsharded_engine(request, mesh, case):
    r = request.getfixturevalue(mesh)[case]
    assert r["streams"] == r["unsharded"]["streams"]
    assert all(r["streams"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cf", [CF_ALL, JMCFG.capacity_factor])
def test_expert_mesh_streams_equal_the_jax_expert_mesh_engine(request, jmoe, mesh, cf):
    r = request.getfixturevalue(mesh)["cf2" if cf == CF_ALL else "cf125"]
    assert _jax_streams(jmoe, cf, MESHES[mesh]) == r["streams"]


def test_jax_expert_mesh_engine_equals_its_one_device_engine(jmoe):
    """What the port is held to: JAX's own expert meshes give its
    one-device streams at both capacity factors on these scenarios."""
    for cf in (CF_ALL, JMCFG.capacity_factor):
        one = _jax_streams(jmoe, cf)
        for axes in MESHES.values():
            assert _jax_streams(jmoe, cf, axes) == one, (cf, axes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_swapped_expert_blocks_change_the_streams(request, mesh):
    r = request.getfixturevalue(mesh)["mutant"]
    assert r["streams"] != r["unsharded"]["streams"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_mesh_features_ran(request, mesh):
    r = request.getfixturevalue(mesh)
    assert r["spec"]["rounds"] > 0
    assert r["refresh"]["dropped"] > 0
    assert r["refresh"]["streams"][:4] != r["refresh"]["streams"][4:]
    if mesh == "e2":
        for key in ("kv_spills_total", "prefix_cache_host_hits_total", "kv_swap_ins_total"):
            assert r["tier"][key] > 0 and r["tier"][key] == r["tier"]["unsharded"][key], key
        lora = r["lora"]["streams"]
        assert lora[0] != lora[2] and lora[1] != lora[2]  # an adapter changes the stream
