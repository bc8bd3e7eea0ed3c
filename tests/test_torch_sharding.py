"""Tensor-parallel serving on the port against the JAX package (tiny, f32).

The spec tables and each rank's parameter slices are held against the
reference's `serving_param_shardings` and `NamedSharding` in process on
this suite's 8-device CPU platform. The serving engine runs as two ranks
over gloo: two fresh interpreters that import no JAX, load the bridged
weights from an `.npz`, and serve every case of `WORKER` in one process
group (plain dense and MoE, speculation with the int8 drafter, LoRA
adapters, refresh_params, the host KV tier, sampling, and the split
roles on two groups); rank 0 also runs each case on the port's unsharded
engine. Their streams are held against the JAX engine on
`make_mesh(jax.devices()[:2], model=2)` where the reference pins one, and
against the port's unsharded engine everywhere. Every run has its own
rendezvous file, a join timeout and a kill.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.kv_blocks import init_paged_state as jinit_state
from dstack_tpu.workloads.kv_transfer import KVHandoff as JHandoff
from dstack_tpu.workloads.lora import lora_init
from dstack_tpu.workloads.quant import quantize_params as jquantize
from dstack_tpu.workloads.sharding import (
    make_mesh as jmake_mesh,
    serving_param_shardings,
    serving_state_shardings,
)
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads import sharding as tsh
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.kv_blocks import init_paged_state
from dstack_tpu_torch.workloads.quant import QTensor
from dstack_tpu_torch.workloads.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
JCFG = JPRESETS["tiny"].with_(dtype="float32")
JMCFG = JPRESETS["tiny-moe"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")
JOIN_S = 120
# test_sharded_serving_bitexact_subprocess's engine and scenarios, and
# test_disagg_sharded_bitexact's (tests/test_serving_*.py).
KW = dict(slots=2, max_len=128, kv_block_size=16)
SCENARIOS = [(list(range(1, 30)), 20), (list(range(3, 35)), 18)]
SPLIT_KW = dict(slots=4, max_len=128, kv_block_size=16, prefill_chunk_tokens=32)
SPLIT_SCENARIOS = [(list(range(1, 30)), 20), (list(range(3, 35)), 33),
                   (list(range(5, 42)), 12), (list(range(7, 24)), 1)]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return jinit(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jmoe():
    return jinit(JMCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(jax.devices()[:2], model=2)


def _rank_mesh(rank, n=2):
    """A mesh of the port as rank `rank` of `n` sees it, for the slicing
    functions, which run no collective."""
    shape = dict(zip(tsh.AXES, (1, 1, 1, n, 1)))
    return tsh.Mesh(torch.device("cpu"), shape, group=object(), rank=rank, backend="gloo")


def _flat_jax_specs(shardings):
    leaves = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path): tuple(s.spec)
            for path, s in leaves}


def _flat_port(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, path + (k,)))
        return out
    if isinstance(tree, QTensor):
        return {path + ("q",): tree.q, path + ("scale",): tree.scale}
    return {path: tree}


def _trees(jparams, jmoe):
    """(name, JAX tree, port tree) for every leaf family the engine loads."""
    lora = lora_init(JCFG, jparams, jax.random.PRNGKey(1), rank=4)
    # B is zero at init: give it values so the slices are checked on data.
    lora = {"layers": {k: (v if k.endswith("_a") else v + 0.5)
                       for k, v in lora["layers"].items()}}
    out = []
    for name, tree in (("target", jparams), ("int8", jquantize(jparams)),
                       ("lora", lora), ("moe", jmoe), ("moe_int8", jquantize(jmoe))):
        out.append((name, tree, params_from_numpy(_numpy(tree), "cpu")))
    return out


@pytest.mark.parametrize("family", ["target", "int8", "lora", "moe", "moe_int8"])
def test_spec_tables_equal_the_reference(jparams, jmoe, jmesh, family):
    _, jtree, ttree = next(t for t in _trees(jparams, jmoe) if t[0] == family)
    want = _flat_jax_specs(serving_param_shardings(jmesh, jtree))
    got = {path: spec for path, spec in _flat_port(tsh.serving_specs(ttree)).items()}
    assert got == want


@pytest.mark.parametrize("tree", [
    {"layers": {"w_new": np.zeros((2, 4, 4), np.float32)}},   # a weight with no rule
    {"lm_head": np.zeros((2, 4, 4), np.float32)},              # ndim against its rule
])
def test_spec_tables_refuse_what_the_reference_refuses(jmesh, tree):
    with pytest.raises(ValueError):
        serving_param_shardings(jmesh, tree)
    with pytest.raises(ValueError):
        tsh.serving_specs({k: (torch.from_numpy(v) if not isinstance(v, dict) else
                               {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                           for k, v in tree.items()})


@pytest.mark.parametrize("family", ["target", "int8", "lora", "moe", "moe_int8"])
def test_rank_slices_equal_the_named_sharding(jparams, jmoe, jmesh, family):
    _, jtree, ttree = next(t for t in _trees(jparams, jmoe) if t[0] == family)
    jsh = _flat_jax_specs(serving_param_shardings(jmesh, jtree))
    jleaves = {tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    for rank in (0, 1):
        got = _flat_port(tsh.serving_param_shards(_rank_mesh(rank), ttree))
        for path, spec in jsh.items():
            idx = NamedSharding(jmesh, P(*spec)).devices_indices_map(
                jleaves[path].shape)[jax.devices()[rank]]
            np.testing.assert_array_equal(got[path].numpy(), jleaves[path][idx],
                                          err_msg=f"{family} {path} rank {rank}")


def test_pool_shards_equal_the_named_sharding(jmesh):
    jstate = jinit_state(JCFG, batch=4, max_len=128, block_size=16, num_blocks=32)
    want = serving_state_shardings(jmesh, jstate)
    state = init_paged_state(TCFG, 4, 128, 16, 32, torch.device("cpu"))
    state.k.copy_(torch.arange(state.k.numel(), dtype=torch.float32).reshape(state.k.shape))
    assert tuple(want.k.spec) == tsh.SERVING_KV_POOL_SPEC
    for rank in (0, 1):
        got = tsh.serving_state_shards(_rank_mesh(rank), state)
        idx = want.k.devices_indices_map(tuple(state.k.shape))[jax.devices()[rank]]
        assert torch.equal(got.k, state.k[idx])
        assert got.block_tables is state.block_tables and got.lengths is state.lengths


def test_indivisible_heads_raise_as_in_the_reference(jparams):
    """tiny has 2 KV heads: a 4-way model axis cannot shard them."""
    with pytest.raises(ValueError):
        jsrv.ServingEngine(JCFG, jparams, slots=2, max_len=128,
                           mesh=jmake_mesh(jax.devices()[:4], model=4))
    tp = params_from_numpy(_numpy(jparams), "cpu")
    with pytest.raises(ValueError, match="must divide the mesh's model axis"):
        tsrv.ServingEngine(TCFG, tp, device="cpu", slots=2, max_len=128,
                           mesh=_rank_mesh(0, n=4))


@pytest.mark.parametrize("kw", [
    dict(model=2),                        # a model axis without ranks
    dict(data=2), dict(fsdp=2), dict(expert=2),
])
def test_meshes_without_ranks_still_refuse_every_axis_but_seq(kw):
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tsh.make_mesh(["cpu"], **kw)


def test_training_axes_over_ranks_raise():
    """A seq axis and an expert axis over ranks stay refused (ROADMAP
    Queue 1 items 3c, 3d); the data, fsdp and model axes train since the
    training slice (tests/test_torch_train_sharded.py)."""
    for shape in (dict(zip(tsh.AXES, (1, 1, 2, 1, 1))), dict(zip(tsh.AXES, (1, 1, 1, 1, 2)))):
        for layout in tsh.LAYOUTS:
            with pytest.raises(NotImplementedError, match="Queue 1 items 3c and 3d"):
                tsh.Mesh(torch.device("cpu"), shape, group=object(), backend="gloo",
                         layout=layout)


@pytest.mark.parametrize("world,device", [(2, "cuda:0"), (2, None)])
def test_nccl_refuses_ranks_that_share_a_card_and_names_gloo(world, device):
    dev = None if device is None else torch.device(device)
    with pytest.raises(ValueError, match="gloo"):
        tsh.check_backend("nccl", world, dev)


def test_all_gather_of_one_shard_is_its_input():
    x = torch.ones(3)
    assert tsh.all_gather(x, 0, None) is x
    assert tsh.all_gather(x, 0, tsh.make_mesh(["cpu"], seq=2)) is x


# -- the engine as two ranks over gloo ------------------------------------------------

WORKER = r'''
import hashlib, json, sys, threading
import numpy as np, torch, torch.distributed as dist
from dstack_tpu_torch.workloads import serving, sharding
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.kv_transfer import encode_msg, pack_handoff
from dstack_tpu_torch.workloads.lora_serving import demo_adapter

rank, init, wdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = set(sys.argv[4].split(","))


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


CFG = PRESETS["tiny"].with_(dtype="float32")
MCFG = PRESETS["tiny-moe"].with_(dtype="float32")
DENSE = load("tiny")
KW = json.loads(sys.argv[5])
SC = json.loads(sys.argv[6])
SPLIT_KW = json.loads(sys.argv[7])
SPLIT_SC = json.loads(sys.argv[8])
sharding.init_ranks(2, rank, init, backend="gloo", device="cpu")
mesh = sharding.make_mesh(["cpu"], model=2)
results = {}


def prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


def wave(eng, reqs):
    return [drain(eng.submit(p, n, temperature=0.0)) for p, n in reqs]


def serve_plain(eng):
    refused = False
    if eng.mesh is not None:
        try:
            eng.hold_admission()  # RL's gang admission: the training slice's
        except NotImplementedError:
            refused = True
    return {"streams": wave(eng, SC), "hold_refused": refused}


def serve_spec(eng):
    return {"streams": wave(eng, [(p, 40) for p, _ in SC]),
            "rounds": eng.stats()["spec_rounds_total"]}


ADAPTERS = {name: demo_adapter(CFG, DENSE, seed, rank=4, scale=0.5)
            for name, seed in (("t1", 1), ("t2", 2))}


def serve_lora(eng):
    for name, tree in ADAPTERS.items():
        eng.load_adapter(name, tree)
    outs = [eng.submit(p, 16, temperature=0.0, adapter=a)
            for (p, _), a in zip(SC + SC[:1], ("t1", "t2", None))]
    streams = [drain(q) for q in outs]
    eng.unload_adapter("t2")
    streams.append(drain(eng.submit(SC[1][0], 12, temperature=0.0, adapter="t1")))
    return {"streams": streams}


SCALED = {k: ({kk: vv * 0.75 for kk, vv in v.items()} if isinstance(v, dict) else v * 0.75)
          for k, v in DENSE.items()}


def serve_refresh(eng):
    first = wave(eng, SC)
    dropped = eng.refresh_params(SCALED)
    return {"streams": first + wave(eng, SC), "dropped": dropped}


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
        "kv_spills_total", "prefix_cache_host_hits_total", "kv_swap_ins_total",
        "slot_preemptions_total", "slot_swap_ins_total")}}


AGREE = []


def serve_sampled(eng):
    streams = [drain(eng.submit(p, n, temperature=0.9, top_p=0.8)) for p, n in SC]
    return {"streams": streams}


TIER_KW = dict(slots=2, max_len=64, kv_pool_blocks=16, kv_block_size=8,
               prefill_chunk_tokens=16, kv_host_budget_bytes=32 << 20)
CASES = [
    ("plain", CFG, DENSE, KW, serve_plain),
    ("moe", MCFG, None, KW, serve_plain),
    ("spec", CFG, DENSE, {**KW, "spec_enable": True}, serve_spec),
    ("lora", CFG, DENSE, {**KW, "slots": 3, "lora_max_adapters": 2, "lora_rank": 4},
     serve_lora),
    ("refresh", CFG, DENSE, KW, serve_refresh),
    ("tier", CFG, DENSE, TIER_KW, serve_tier),
    ("sampled", CFG, DENSE, {**KW, "seed": 7}, serve_sampled),
]


def spy(name):
    """Wrap an op so every rank's token ids are gathered and compared."""
    orig = getattr(serving.ServingEngine, name)

    def wrapped(self, *a):
        r = orig(self, *a)
        toks = r[0] if isinstance(r, tuple) else r
        if self.mesh is not None and toks is not None:
            both = sharding.all_gather(toks.reshape(1, -1).to(torch.int64), 0, self.mesh)
            if self.mesh.rank == 0:
                AGREE.append(bool(torch.equal(both[0], both[1])))
        return r
    return orig, wrapped


for name, cfg, params, kw, serve in CASES:
    if name not in cases:
        continue
    params = load("tiny_moe") if params is None else params
    patched = []
    if name == "sampled":
        for op in ("_op_decode", "_op_chunk"):
            orig, wrapped = spy(op)
            setattr(serving.ServingEngine, op, wrapped)
            patched.append((op, orig))
    if rank:
        fe = serving.run_follower(mesh, cfg, params, **kw)
        if name == "plain":
            np.savez(f"{wdir}/pool_rank1.npz", k=fe.state.k.numpy(), v=fe.state.v.numpy())
        assert not fe._rank_payloads or name == "tier", name
    else:
        eng = serving.ServingEngine(cfg, params, mesh=mesh, **kw)
        try:
            eng.warmup()
            res = serve(eng)
        finally:
            eng.close()
        res["model_shards"] = eng.stats()["model_shards"]
        if name == "plain":
            np.savez(f"{wdir}/pool_rank0.npz", k=eng.state.k.numpy(), v=eng.state.v.numpy())
        ref = serving.ServingEngine(cfg, params, device="cpu", **kw)
        try:
            res["unsharded"] = serve(ref)
        finally:
            ref.close()
        if name == "plain":
            np.savez(f"{wdir}/pool_unsharded.npz", k=ref.state.k.numpy(),
                     v=ref.state.v.numpy())
        if name == "sampled":
            res["agree"] = list(AGREE)
        results[name] = res
    for op, orig in patched:
        setattr(serving.ServingEngine, op, orig)


class Bridge:
    def __init__(self, engine):
        self.engine, self.outs, self.frames = engine, {}, {}

    def send(self, h):
        h = h._replace(epoch=self.engine.handoff_epoch)
        header, payloads = pack_handoff(h)
        self.frames[h.request_id] = hashlib.sha1(encode_msg(header, payloads)).hexdigest()
        self.outs[h.request_id] = self.engine.submit_prefilled(h)


def split(pre_mesh, dec_mesh):
    dec = serving.ServingEngine(CFG, DENSE, role="decode", mesh=dec_mesh,
                                device=None if dec_mesh else "cpu", **SPLIT_KW)
    bridge = Bridge(dec)
    pre = serving.ServingEngine(CFG, DENSE, role="prefill", kv_transfer=bridge,
                                mesh=pre_mesh, device=None if pre_mesh else "cpu",
                                **SPLIT_KW)
    try:
        pre.warmup()
        dec.warmup()
        outs = [pre.submit(p, n, request_id=i) for i, (p, n) in enumerate(SPLIT_SC)]
        got = {i: drain(q) for i, q in enumerate(outs)}
        for rid, q in bridge.outs.items():
            got[rid] = drain(q)
        ps, ds = pre.stats(), dec.stats()
        return {"streams": [got[i] for i in range(len(SPLIT_SC))], "frames": bridge.frames,
                "residue": [s["kv_blocks_in_use"] - s["kv_blocks_cached"] for s in (ps, ds)]}
    finally:
        pre.close()
        dec.close()


if "split" in cases:
    # Two engines serve at once over the same two ranks: a group each.
    ma, mb = (sharding.Mesh(torch.device("cpu"), mesh.shape, group=dist.new_group([0, 1]),
                            rank=rank, backend="gloo") for _ in range(2))
    if rank:
        ts = [threading.Thread(target=serving.run_follower, args=(m, CFG, DENSE),
                               kwargs={**SPLIT_KW, "role": r})
              for m, r in ((ma, "prefill"), (mb, "decode"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        results["split"] = split(ma, mb)
        results["split"]["unsharded"] = split(None, None)

if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
'''


def _save_npz(path, tree):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(_numpy(tree), "")
    np.savez(path, **flat)


def run_ranks(tmp: Path, cases, timeout: float = JOIN_S) -> dict:
    """Rank 0 and rank 1 of WORKER as subprocesses over gloo, with a
    rendezvous file of their own; both joined within `timeout` seconds or
    killed. Returns rank 0's results."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    rdv = tmp / f"rendezvous-{time.monotonic_ns()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    args = [str(tmp), ",".join(cases), json.dumps(KW), json.dumps(SCENARIOS),
            json.dumps(SPLIT_KW), json.dumps(SPLIT_SCENARIOS)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), f"file://{rdv}", *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(ROOT), start_new_session=True)
             for r in (0, 1)]
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


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory, jparams, jmoe):
    tmp = tmp_path_factory.mktemp("tp")
    _save_npz(tmp / "tiny.npz", jparams)
    _save_npz(tmp / "tiny_moe.npz", jmoe)
    t0 = time.monotonic()
    res = run_ranks(tmp, ["plain", "moe", "spec", "lora", "refresh", "tier", "sampled",
                          "split"])
    res["_seconds"] = time.monotonic() - t0
    res["_dir"] = str(tmp)
    print(f"two ranks, every case: {res['_seconds']:.1f}s")
    return res


def _drain(q):
    out = []
    while True:
        t = q.get(timeout=120)
        if t is None:
            return out
        if isinstance(t, BaseException):
            raise t
        out.append(int(t))


def test_two_rank_streams_and_pools_equal_the_jax_sharded_engine(tp_run, jparams, jmesh):
    eng = jsrv.ServingEngine(JCFG, jparams, mesh=jmesh, **KW)
    try:
        want = [_drain(eng.submit(p, n)) for p, n in SCENARIOS]
        jpools = {"k": np.asarray(eng.state.k), "v": np.asarray(eng.state.v)}
    finally:
        eng.close()
    plain = tp_run["plain"]
    assert plain["model_shards"] == 2
    assert plain["streams"] == want and all(want)
    assert plain["unsharded"]["streams"] == want
    # Across the two frameworks the f32 pools agree to the tolerance of
    # test_torch_kv_blocks.py's pool comparison: on this input JAX's own
    # sharded and unsharded pools differ by 2.6e-6, and the port's
    # unsharded pool and JAX's by 7.2e-6 (the products' summation order),
    # so 1e-6 holds only within one package (the next test).
    for name, jpool in jpools.items():
        nb = jpool.shape[1]
        for rank in (0, 1):
            pool = np.load(Path(tp_run["_dir"]) / f"pool_rank{rank}.npz")[name][:, :nb]
            heads = jpool[:, :, :, rank:rank + 1]   # tiny's 2 KV heads, one per rank
            np.testing.assert_allclose(pool, heads, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} pool, rank {rank}")


def test_two_rank_pools_are_the_unsharded_pools_head_slices(tp_run):
    d = Path(tp_run["_dir"])
    for name in ("k", "v"):
        whole = np.load(d / "pool_unsharded.npz")[name]
        got = np.concatenate([np.load(d / f"pool_rank{r}.npz")[name] for r in (0, 1)],
                             axis=3)
        np.testing.assert_array_equal(got, whole, err_msg=f"{name} pool")


@pytest.mark.parametrize("case", ["plain", "moe", "spec", "lora", "refresh", "tier"])
def test_two_rank_streams_equal_the_unsharded_engine(tp_run, case):
    r = tp_run[case]
    assert r["streams"] == r["unsharded"]["streams"]
    assert all(r["streams"])


def test_two_rank_features_ran(tp_run):
    assert tp_run["plain"]["hold_refused"] and tp_run["moe"]["hold_refused"]
    assert tp_run["spec"]["rounds"] > 0
    assert tp_run["refresh"]["dropped"] > 0
    # The refreshed weights change what the engine says.
    assert tp_run["refresh"]["streams"][:2] != tp_run["refresh"]["streams"][2:]
    tier = tp_run["tier"]
    for key in ("kv_spills_total", "prefix_cache_host_hits_total", "kv_swap_ins_total"):
        assert tier[key] > 0 and tier[key] == tier["unsharded"][key], key
    lora = tp_run["lora"]["streams"]
    assert lora[0] != lora[2]  # an adapter changes the stream of one prompt


def test_sampling_ranks_agree_at_every_step(tp_run):
    r = tp_run["sampled"]
    assert r["agree"] and all(r["agree"])
    assert all(r["streams"])


def test_two_rank_split_roles_equal_the_jax_split_and_the_unsharded_frames(tp_run, jparams,
                                                                           jmesh):
    split = tp_run["split"]
    dec = jsrv.ServingEngine(JCFG, jparams, **SPLIT_KW, role="decode", mesh=jmesh)

    class Bridge:
        outs = {}

        def send(self, h: JHandoff) -> None:
            h = h._replace(epoch=dec.handoff_epoch)
            self.outs[h.request_id] = dec.submit_prefilled(h)

    bridge = Bridge()
    pre = jsrv.ServingEngine(JCFG, jparams, **SPLIT_KW, role="prefill", kv_transfer=bridge,
                             mesh=jmesh)
    try:
        outs = [pre.submit(p, n, request_id=i) for i, (p, n) in enumerate(SPLIT_SCENARIOS)]
        got = {i: _drain(q) for i, q in enumerate(outs)}
        for rid, q in bridge.outs.items():
            got[rid] = _drain(q)
    finally:
        pre.close()
        dec.close()
    want = [got[i] for i in range(len(SPLIT_SCENARIOS))]
    assert split["streams"] == want
    assert split["unsharded"]["streams"] == want
    assert split["frames"] == split["unsharded"]["frames"] and split["frames"]
    assert split["residue"] == [0, 0]


# -- native_server --mesh-model 2 -------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _chat(port):
    body = json.dumps({"messages": [{"role": "user", "content": "hello there"}],
                       "max_tokens": 12, "temperature": 0.0}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["choices"][0]["message"]["content"]


def _serve_and_chat(mesh_model: int):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.native_server", "--preset", "tiny",
         "--device", "cpu", "--port", str(port), "--no-warmup",
         "--mesh-model", str(mesh_model)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    try:
        deadline = time.monotonic() + JOIN_S
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5):
                    break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.2)
        text = _chat(port)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        return text, proc.pid
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_native_server_mesh_model_2_answers_the_one_rank_servers_tokens():
    want, _ = _serve_and_chat(1)
    got, pid = _serve_and_chat(2)
    assert got == want and want
    # SIGTERM drained, closed the engine and reaped rank 1.
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = subprocess.run(["pgrep", "-af", "^[^ ]*python[^ ]* -m dstack_tpu_torch"
                               ".native_server .*--dist-init"],
                              capture_output=True, text=True).stdout.splitlines()
        if not left:
            break
        time.sleep(0.2)
    assert not left, left


def test_native_server_sigterm_drains_an_inflight_stream_and_reaps_its_rank():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.native_server", "--preset", "tiny",
         "--device", "cpu", "--port", str(port), "--no-warmup", "--mesh-model", "2",
         "--steps-per-sync", "1"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    try:
        deadline = time.monotonic() + JOIN_S
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5):
                    break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.2)
        body = json.dumps({"messages": [{"role": "user", "content": "hello"}],
                           "max_tokens": 48, "temperature": 0.0, "stream": True}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                     data=body, headers={"Content-Type": "application/json"})
        lines = []
        with urllib.request.urlopen(req, timeout=60) as r:
            lines.append(r.readline().decode())
            proc.send_signal(signal.SIGTERM)  # mid-stream
            lines += r.read().decode().splitlines()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert any("[DONE]" in ln for ln in lines)
    assert any('"finish_reason": "length"' in ln for ln in lines)
    left = subprocess.run(["pgrep", "-af", "^[^ ]*python[^ ]* -m dstack_tpu_torch"
                           ".native_server .*--dist-init"],
                          capture_output=True, text=True).stdout.splitlines()
    assert not left, left


def test_native_server_nccl_with_ranks_on_one_card_names_gloo():
    from dstack_tpu_torch import native_server

    with pytest.raises(SystemExit, match="gloo"):
        native_server.main(["--preset", "tiny", "--device", "cuda:0", "--mesh-model", "2",
                            "--dist-backend", "nccl"])
