"""Prefill/decode disaggregation in the PyTorch port against the JAX
package (tiny, f32, bridged weights, on the CPU, temperature 0): the port's
prefill tier handing off to its decode tier through an in-process bridge
gives the JAX unified engine's streams token for token, and so do a JAX
prefill tier handing off to a port decode tier and the reverse (which pins
the pool layout (L, n, bs, KV, hd) of both packages); the cases of
tests/test_serving_disagg.py (zero residue, stale epochs, geometry, a
cancel mid-handoff, trace continuity, role metrics, a speculation round
handed off with the drafter's rows); the two-process drill as a
subprocess; the cache-affinity sketch equal to the JAX engine's; and
`native_server --role`."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dstack_tpu.server.metrics_registry import METRICS
from dstack_tpu.workloads import kv_transfer as jkt
from dstack_tpu.workloads import lora_serving as jls
from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import kv_transfer as tkt
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.kv_blocks import BlockAllocator
from dstack_tpu_torch.workloads.weights import lora_from_numpy, params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")

# As tests/test_serving_disagg.py: 29 ends mid-block (16-blocks), 32 is
# exactly two blocks with a budget crossing the next boundary mid-decode,
# 37 leaves a 5-token remainder after a 32-token prefill chunk, 17/1
# completes on the prefill side without a handoff.
SCENARIOS = [
    (list(range(1, 30)), 20),
    (list(range(3, 35)), 33),
    (list(range(5, 42)), 12),
    (list(range(7, 24)), 1),
]
ENGINE_KW = dict(slots=4, max_len=128, kv_block_size=16,
                 prefill_chunk_tokens=32)
HANDED = sum(1 for _, b in SCENARIOS if b > 1)


@pytest.fixture(scope="module")
def weights():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def jax_ref(weights):
    """The JAX unified engine's streams of SCENARIOS."""
    jp, _ = weights
    eng = jsrv.ServingEngine(JCFG, jp, **ENGINE_KW)
    try:
        return [_drain(eng.submit(p, b)) for p, b in SCENARIOS]
    finally:
        eng.close()


def _drain(out, timeout=120):
    toks = []
    while True:
        t = out.get(timeout=timeout)
        if t is None:
            return toks
        if isinstance(t, BaseException):
            raise t
        toks.append(int(t))


def _port(params, role="unified", **kw):
    return tsrv.ServingEngine(TCFG, params, device="cpu", role=role,
                              **{**ENGINE_KW, **kw})


class Bridge:
    """In-process stand-in for TransferClient: stamps the decode engine's
    live epoch and calls submit_prefilled directly. `convert` turns the
    prefill package's handoff into the decode package's."""

    def __init__(self, engine, convert=lambda h: h):
        self.engine = engine
        self.convert = convert
        self.outs = {}

    def send(self, h) -> None:
        h = self.convert(h)._replace(epoch=self.engine.handoff_epoch)
        self.outs[h.request_id] = self.engine.submit_prefilled(h)


def _to_torch(h: jkt.KVHandoff) -> tkt.KVHandoff:
    arrays = {n: None if getattr(h, n) is None else torch.from_numpy(np.array(getattr(h, n)))
              for n in ("k", "v", "draft_k", "draft_v")}
    return tkt.KVHandoff(**{**h._asdict(), **arrays})


def _to_numpy(h: tkt.KVHandoff) -> jkt.KVHandoff:
    arrays = {n: None if getattr(h, n) is None else getattr(h, n).numpy()
              for n in ("k", "v", "draft_k", "draft_v")}
    return jkt.KVHandoff(**{**h._asdict(), **arrays})


def _split(pre, bridge):
    """SCENARIOS through a prefill engine; streams from the decode side."""
    outs = [pre.submit(p, b, request_id=i) for i, (p, b) in enumerate(SCENARIOS)]
    got = {}
    for i, out in enumerate(outs):
        r = _drain(out)
        if SCENARIOS[i][1] <= 1:
            got[i] = r  # completed locally on the prefill side
        else:
            assert r == [], f"prefill-side stream must be empty: {r}"
    for rid, out in bridge.outs.items():
        got[rid] = _drain(out)
    return [got[i] for i in range(len(SCENARIOS))]


def _run_disagg(params, **kw):
    dec = _port(params, "decode", **kw)
    bridge = Bridge(dec)
    pre = _port(params, "prefill", kv_transfer=bridge, **kw)
    try:
        streams = _split(pre, bridge)
        return streams, pre.stats(), dec.stats()
    finally:
        pre.close()
        dec.close()


def _assert_zero_residue(stats):
    # The prefix cache holds blocks at refcount 1, so in_use == cached is
    # the no-leak condition after all streams end.
    assert stats["kv_blocks_in_use"] == stats["kv_blocks_cached"], stats


def _wait_zero_residue(*engines, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(e.stats()["kv_blocks_in_use"] == e.stats()["kv_blocks_cached"]
               for e in engines):
            break
        time.sleep(0.05)
    for e in engines:
        _assert_zero_residue(e.stats())


# -- the port's split against the JAX unified engine -----------------------------


def test_disagg_matches_the_jax_and_port_unified_engines(weights, jax_ref):
    _, tp = weights
    uni = _port(tp)
    try:
        port_ref = [_drain(uni.submit(p, b)) for p, b in SCENARIOS]
    finally:
        uni.close()
    assert port_ref == jax_ref
    streams, ps, ds = _run_disagg(tp)
    assert streams == jax_ref
    _assert_zero_residue(ps)
    _assert_zero_residue(ds)
    assert ps["kv_handoffs_sent_total"] == ds["kv_handoffs_received_total"] == HANDED
    assert ps["kv_transfer_bytes_total"] > 0
    assert ds["kv_transfer_bytes_total"] == ps["kv_transfer_bytes_total"]
    assert ps["role"] == "prefill" and ds["role"] == "decode"
    assert ps["kv_transfer_hist"]["count"] == HANDED
    assert ps["kv_transfer_queue_depth"] == ds["kv_transfer_queue_depth"] == 0


def test_disagg_spec_round_with_drafter_rows_matches_jax(weights, jax_ref):
    """Speculation on both tiers: the drafter's rows ride the handoff, the
    decode tier runs speculation rounds, the streams stay the JAX plain
    engine's (greedy speculation is exact)."""
    _, tp = weights
    dec = _port(tp, "decode", spec_enable=True)
    seen = []

    class Spy(Bridge):
        def send(self, h):
            seen.append(h.draft_k is not None and h.draft_v is not None)
            super().send(h)

    bridge = Spy(dec)
    pre = _port(tp, "prefill", kv_transfer=bridge, spec_enable=True)
    try:
        assert _split(pre, bridge) == jax_ref
        ds = dec.stats()
    finally:
        pre.close()
        dec.close()
    assert seen == [True] * HANDED
    assert ds["spec_rounds_total"] > 0
    _assert_zero_residue(ds)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_handoffs_across_the_packages_match_the_jax_unified_engine(weights, jax_ref,
                                                                   direction):
    """A JAX prefill tier hands off to a port decode tier, and a port
    prefill tier to a JAX decode tier, through a bridge that converts numpy
    to torch and back: the pool layouts (L, n, bs, KV, hd) agree."""
    jp, tp = weights
    if direction == "jax_to_port":
        dec = _port(tp, "decode")
        bridge = Bridge(dec, _to_torch)
        pre = jsrv.ServingEngine(JCFG, jp, role="prefill", kv_transfer=bridge, **ENGINE_KW)
    else:
        dec = jsrv.ServingEngine(JCFG, jp, role="decode", **ENGINE_KW)
        bridge = Bridge(dec, _to_numpy)
        pre = _port(tp, "prefill", kv_transfer=bridge)
    try:
        assert _split(pre, bridge) == jax_ref
        ps, ds = pre.stats(), dec.stats()
    finally:
        pre.close()
        dec.close()
    _assert_zero_residue(ps)
    _assert_zero_residue(ds)
    assert ps["kv_transfer_bytes_total"] == ds["kv_transfer_bytes_total"] > 0


# -- the cases of tests/test_serving_disagg.py ------------------------------------


def _handoff(**kw):
    shape = (TCFG.n_layers, 2, 16, TCFG.n_kv_heads, TCFG.head_dim)
    good = dict(request_id=1, epoch=1, prompt=list(range(20)), first_token=3,
                max_new_tokens=4, temperature=0.0, top_p=1.0,
                k=torch.zeros(shape), v=torch.zeros(shape))
    return tkt.KVHandoff(**{**good, **kw})


def test_stale_epoch_rejected_with_zero_residue(weights):
    _, tp = weights
    dec = _port(tp, "decode")
    try:
        before = dec.stats()
        assert dec.bump_handoff_epoch() == 2
        with pytest.raises(tkt.StaleEpochError) as e:
            dec.submit_prefilled(_handoff(request_id=99, prompt=list(range(10)),
                                          k=torch.zeros(TCFG.n_layers, 1, 16, 2, 32),
                                          v=torch.zeros(TCFG.n_layers, 1, 16, 2, 32)))
        assert e.value.got == 1 and e.value.current == 2
        after = dec.stats()
        assert after["kv_handoffs_stale_rejected_total"] == 1
        assert after["kv_blocks_in_use"] == before["kv_blocks_in_use"]
        assert after["handoff_epoch"] == 2
        _assert_zero_residue(after)
    finally:
        dec.close()


@pytest.mark.parametrize("bad,error", [
    # 20 tokens need 2 blocks, not 1.
    (lambda h: dict(k=h.k[:, :1], v=h.v[:, :1]), ValueError),
    # Block size 8, not the pool's 16.
    (lambda h: dict(k=h.k[:, :, :8], v=h.v[:, :, :8]), ValueError),
    # A budget past max_len.
    (lambda h: dict(max_new_tokens=1000), ValueError),
    (lambda h: dict(prompt=[]), ValueError),
    (lambda h: dict(max_new_tokens=0), ValueError),
    # k and v of different shapes.
    (lambda h: dict(v=h.v[:, :, :, :1]), ValueError),
])
def test_submit_prefilled_validates_geometry(weights, bad, error):
    _, tp = weights
    dec = _port(tp, "decode")
    try:
        h = _handoff()
        with pytest.raises(error):
            dec.submit_prefilled(h._replace(**bad(h)))
        _assert_zero_residue(dec.stats())
        assert dec.stats()["kv_transfer_queue_depth"] == 0
    finally:
        dec.close()


@pytest.mark.parametrize("role", ["unified", "prefill"])
def test_only_a_decode_engine_takes_handoffs(weights, role):
    _, tp = weights
    kw = {"kv_transfer": Bridge(None)} if role == "prefill" else {}
    eng = _port(tp, role, **kw)
    try:
        with pytest.raises(RuntimeError, match="requires role='decode'"):
            eng.submit_prefilled(_handoff())
    finally:
        eng.close()


@pytest.mark.parametrize("kw,error,match", [
    (dict(role="prefill"), ValueError, "requires a kv_transfer"),
    (dict(role="router"), ValueError, "role must be"),
    (dict(role="decode", lora_max_adapters=2), ValueError, "requires role='unified'"),
    (dict(mesh=object()), NotImplementedError, "mesh"),
])
def test_role_validation(weights, kw, error, match):
    _, tp = weights
    with pytest.raises(error, match=match):
        tsrv.ServingEngine(TCFG, tp, device="cpu", **{**ENGINE_KW, **kw})


def test_cancel_mid_handoff_leaves_no_residue(weights):
    _, tp = weights
    dec = _port(tp, "decode")
    bridge = Bridge(dec)
    pre = _port(tp, "prefill", kv_transfer=bridge)
    try:
        out = pre.submit(list(range(11, 90)), 20, request_id=50)
        pre.cancel(out)
        r = out.get(timeout=60)
        assert r is None or isinstance(r, int)
        if 50 in bridge.outs:  # the handoff raced ahead of the cancel
            _drain(bridge.outs[50])
        _wait_zero_residue(pre, dec)
    finally:
        pre.close()
        dec.close()


def test_cancel_of_a_handoff_waiting_for_a_slot_answers_at_once(weights):
    """A decode tier with every slot busy keeps a handoff queued; a cancel
    answers it at the next boundary with no residue."""
    _, tp = weights
    dec = _port(tp, "decode", slots=1)
    try:
        busy = dec.submit_prefilled(_handoff(max_new_tokens=60, request_id=1))
        queued = dec.submit_prefilled(_handoff(request_id=2))
        dec.cancel(queued)
        assert queued.get(timeout=30) is None
        dec.cancel(busy)
        _drain(busy)
        _wait_zero_residue(dec)
    finally:
        dec.close()


def test_a_failed_transfer_fails_the_request_loudly(weights):
    """The decode side gone: the request gets the exception, never a clean
    empty end, and the prefill tier keeps no blocks."""
    _, tp = weights

    class Down:
        def send(self, h):
            raise ConnectionError("decode tier unreachable")

    pre = _port(tp, "prefill", kv_transfer=Down())
    try:
        out = pre.submit(list(range(1, 40)), 8, request_id=3)
        got = out.get(timeout=60)
        assert isinstance(got, ConnectionError)
        assert pre.request_trace(3)["status"] == "error"
        _wait_zero_residue(pre)
        assert pre.stats()["kv_handoffs_sent_total"] == 0
    finally:
        pre.close()


def test_close_answers_queued_handoffs_with_an_error(weights):
    _, tp = weights
    dec = _port(tp, "decode", slots=1)
    busy = dec.submit_prefilled(_handoff(max_new_tokens=100, request_id=1))
    queued = dec.submit_prefilled(_handoff(request_id=2))
    dec.close()
    for out in (busy, queued):
        while True:
            t = out.get(timeout=30)
            if not isinstance(t, int):
                break
        assert isinstance(t, RuntimeError)


def test_trace_continuity_across_tiers(weights):
    """One request, one trace: both tiers' traces share the trace_id
    carried on the handoff, the ship and adopt spans land on their own
    tiers in order, and each tier's phases sum to its total."""
    _, tp = weights
    tparent = "00-" + "5a" * 16 + "-" + "1b" * 8 + "-01"
    dec = _port(tp, "decode")
    bridge = Bridge(dec)
    pre = _port(tp, "prefill", kv_transfer=bridge)
    try:
        out = pre.submit(list(range(1, 40)), 8, request_id=7, traceparent=tparent,
                         x_request_id="cli-7")
        assert _drain(out) == []  # handed off: tokens stream decode-side
        assert len(_drain(bridge.outs[7])) == 8
        pt, dt = pre.request_trace(7), dec.request_trace(7)
        assert pt["trace_id"] == dt["trace_id"] == "5a" * 16
        assert pt["x_request_id"] == "cli-7"
        assert pre.request_trace("cli-7") == pt
        assert [p["phase"] for p in pt["phases"]] == ["queue_wait", "prefill", "kv_ship"]
        assert [p["phase"] for p in dt["phases"]] == ["queue_wait", "kv_adopt", "decode"]
        assert pt["status"] == "ok" and dt["status"] == "ok"
        for t in (pt, dt):
            assert abs(sum(p["duration_s"] for p in t["phases"]) - t["total_seconds"]) < 1e-9
        assert pt["counters"]["prefill_chunks"] >= 1
        assert pt["counters"]["kv_payload_bytes"] > 0
        assert dt["counters"]["kv_payload_bytes"] == pt["counters"]["kv_payload_bytes"]
        assert dt["counters"]["decode_steps"] >= 1
        assert "kv_ship" in pre.recorder.phase_histograms()
        assert "kv_adopt" in dec.recorder.phase_histograms()
        assert 'phase="kv_ship",role="prefill"' in tsrv.prometheus_metrics(pre.stats())
    finally:
        pre.close()
        dec.close()


def test_role_metrics_render(weights):
    _, tp = weights
    dec = _port(tp, "decode")
    bridge = Bridge(dec)
    pre = _port(tp, "prefill", kv_transfer=bridge)
    try:
        pre.warmup()
        dec.warmup()
        _drain(pre.submit(list(range(1, 40)), 8, request_id=0))
        _drain(bridge.outs[0])
        pm = tsrv.prometheus_metrics(pre.stats())
        dm = tsrv.prometheus_metrics(dec.stats())
    finally:
        pre.close()
        dec.close()
    assert "dstack_tpu_serving_kv_handoffs_sent_total 1" in pm
    assert "dstack_tpu_serving_kv_handoffs_received_total 1" in dm
    assert "dstack_tpu_serving_kv_transfer_bytes_total" in pm
    assert "dstack_tpu_serving_kv_transfer_queue_depth 0" in pm
    assert 'dstack_tpu_serving_ttft_seconds_count{role="prefill"} 1' in pm
    assert 'dstack_tpu_serving_ttft_seconds_count{role="decode"} 1' in dm
    assert 'dstack_tpu_serving_kv_transfer_seconds_count{role="prefill"} 1' in pm
    assert 'dstack_tpu_serving_tpt_seconds_bucket{le="+Inf",role="decode"}' in dm
    for text in (pm, dm):
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, mtype = line.split()
                assert name in METRICS and METRICS[name][0] == mtype, line


def test_warmup_runs_the_roles_transfer_programs(weights):
    """A prefill engine's warmup adds one gather per pow-2 block count up
    to max_blocks (8 here: 1, 2, 4, 8), a decode engine's one scatter each,
    on the discard block: the pools' real blocks stay zero."""
    _, tp = weights
    uni = _port(tp)
    dec = _port(tp, "decode")
    pre = _port(tp, "prefill", kv_transfer=Bridge(dec))
    try:
        base = uni.warmup()["programs"]
        assert pre.warmup()["programs"] == base + 4
        assert dec.warmup()["programs"] == base + 4
        nb = dec._num_blocks
        assert not dec.state.k[:, :nb].any() and not dec.state.v[:, :nb].any()
    finally:
        for e in (pre, dec, uni):
            e.close()


# -- the drill --------------------------------------------------------------------


def test_drill_runs_as_two_processes_on_cpu(tmp_path):
    """Three processes of tiny f32 at one intra-op thread each, so the
    drill keeps well inside its limit beside other test workers."""
    out = tmp_path / "report.json"
    r = subprocess.run(
        [sys.executable, "-m", "dstack_tpu_torch.workloads.serving_disagg",
         "--device", "cpu", "--preset", "tiny", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads(out.read_text())
    checks = report["checks"]
    assert report["ok"] and checks["bit_exact"] and checks["params_equal"]
    assert checks["zero_residue"] and checks["trace_continuity"]
    assert checks["stale_reject_recovered"]
    assert report["handoffs_sent"] >= 5


def test_drill_refuses_a_model_mesh():
    """A model axis the heads do not split over (tiny: 4 q / 2 KV heads
    on 3 ranks) is refused before any worker starts; two ranks per worker
    serve (the next test)."""
    from dstack_tpu_torch.workloads import serving_disagg

    with pytest.raises(ValueError, match="must divide the mesh's model axis"):
        serving_disagg.main(["--device", "cpu", "--mesh-model", "3"])


def test_drill_leaves_each_rank_its_own_card(monkeypatch):
    """With no --device the drill names none to its workers, so each
    worker's rank r goes to cuda:r (sharding.join_ranks), and the nccl
    check counts cards instead of refusing every rank on one device."""
    from dstack_tpu_torch.workloads import serving_disagg

    argv = serving_disagg.worker_argv("decode", 1, mesh_model=2, transfer_port=2)
    assert "--device" not in argv
    argv = serving_disagg.worker_argv("decode", 1, device="cpu", transfer_port=2)
    assert argv[argv.index("--device") + 1] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on 1 card"):
        serving_disagg.run_drill(None, mesh_model=2, dist_backend="nccl", verbose=False)
    with pytest.raises(ValueError, match="every rank on cuda:0.*gloo"):
        serving_disagg.run_drill("cuda:0", mesh_model=2, dist_backend="nccl",
                                 verbose=False)


def test_drill_runs_two_ranks_per_worker_on_cpu(tmp_path):
    """Each tier tensor-parallel over two gloo ranks: the drill's own
    checks (bit-exact against the unified engine, zero residue, trace
    continuity, stale epoch, cancel) and no process left behind."""
    out = tmp_path / "drill.json"
    r = subprocess.run(
        [sys.executable, "-m", "dstack_tpu_torch.workloads.serving_disagg",
         "--device", "cpu", "--preset", "tiny", "--mesh-model", "2", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads(out.read_text())
    checks = report["checks"]
    assert report["ok"] and report["mesh_model"] == 2
    assert checks["bit_exact"] and checks["params_equal"] and checks["zero_residue"]
    left = subprocess.run(["pgrep", "-af", "^[^ ]*python[^ ]* -m dstack_tpu_torch.workloads"
                           ".serving_disagg .*--dist-init"],
                          capture_output=True, text=True).stdout.splitlines()
    assert not left, left


# -- the cache-affinity sketch ----------------------------------------------------


PROMPTS = [list(range(1, 40)), list(range(50, 75)), list(range(1, 20)) + [9] * 30]


def _serve_namespaced(eng, adapters):
    for name, (ja, ta) in adapters.items():
        eng.load_adapter(name, ja if isinstance(eng, jsrv.ServingEngine) else ta)
    for adapter in (None, "t1", "t2"):
        for p in PROMPTS:
            _drain(eng.submit(p, 3, adapter=adapter))


def test_affinity_sketch_equals_the_jax_engines_across_namespaces(weights):
    jp, tp = weights
    adapters = {}
    for name, seed in (("t1", 11), ("t2", 22)):
        ja = jls.demo_adapter(JCFG, jp, jax.random.PRNGKey(seed), rank=4,
                              targets=("wq", "wv"))
        adapters[name] = (ja, lora_from_numpy(jax.tree_util.tree_map(np.asarray, ja), "cpu"))
    kw = dict(lora_max_adapters=2, lora_rank=4)
    je = jsrv.ServingEngine(JCFG, jp, **ENGINE_KW, **kw)
    te = _port(tp, **kw)
    try:
        _serve_namespaced(je, adapters)
        _serve_namespaced(te, adapters)
        want, got = je.affinity_sketch(), te.affinity_sketch()
        assert got == want
        assert got["adapters"] == ["t1", "t2"] and got["block_size"] == 16
        # Three namespaces, each its own digests of the same prompts.
        assert len(got["digests"]) == len(set(got["digests"])) == 3 * 5
        assert te.affinity_sketch(limit=4) == je.affinity_sketch(limit=4)
        assert te.affinity_sketch(limit=4)["digests"] == got["digests"][-4:]
        assert te.stats()["affinity"] == got
    finally:
        je.close()
        te.close()


def test_affinity_digests_are_the_chain_heads():
    """A digest is the first DIGEST_HEX hex digits of the block's
    namespace-seeded chain hash; partial tails are left out."""
    from dstack_tpu_torch.workloads.kv_blocks import _chain_hash

    a = BlockAllocator(8, 4)
    tokens = list(range(10))  # two full blocks and a tail of 2
    table = [a.alloc() for _ in range(3)]
    a.insert_full(tokens, table, namespace=b"t1")
    a.insert_tail(tokens, table, namespace=b"t1")
    h1 = _chain_hash(BlockAllocator._ns_seed(b"t1"), tokens[:4])
    h2 = _chain_hash(h1, tokens[4:8])
    assert a.affinity_digests() == [h1.hex()[:16], h2.hex()[:16]]
    assert a.affinity_digests(limit=1) == [h2.hex()[:16]]


def test_affinity_sketch_with_the_host_tier_equals_the_jax_engines(weights):
    """Prefix blocks evicted from a small pool spill to the host tier; the
    sketch lists the device's digests first, then the host's, bounded by
    `limit`, as the JAX engine does."""
    jp, tp = weights
    kw = dict(kv_pool_blocks=8, kv_host_budget_bytes=1 << 22)
    prompts = [[s * 7 + i % 50 + 1 for i in range(33)] for s in range(6)]
    je = jsrv.ServingEngine(JCFG, jp, **ENGINE_KW, **kw)
    te = _port(tp, **kw)
    try:
        for eng in (je, te):
            for p in prompts:
                _drain(eng.submit(p, 2))
        want, got = je.affinity_sketch(), te.affinity_sketch()
        assert te.stats()["kv_host_blocks"] > 0
        assert got == want
        host = te._host_tier.affinity_digests()
        device = te._alloc.affinity_digests()
        assert host and got["digests"] == device + [d for d in host if d not in device]
        assert te.affinity_sketch(limit=3) == je.affinity_sketch(limit=3)
        assert len(te.affinity_sketch(limit=3)["digests"]) == 3
    finally:
        je.close()
        te.close()


# -- native_server --role ----------------------------------------------------------


def _call(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("extra,message", [
    (["--role", "decode"], "requires --kv-transfer-port"),
    (["--role", "prefill"], "requires --kv-transfer-connect"),
    (["--role", "prefill", "--kv-transfer-connect", "localhost:http"], "is not host:port"),
])
def test_native_server_role_flag_validation(extra, message):
    from dstack_tpu_torch import native_server

    with pytest.raises(SystemExit, match=message):
        native_server.main(["--preset", "tiny", "--device", "cpu"] + extra)


def test_native_server_refuses_a_model_mesh():
    """--mesh-model 2 serves (tests/test_torch_sharding.py); a model axis
    the heads do not split over is refused before any rank starts."""
    from dstack_tpu_torch import native_server

    with pytest.raises(SystemExit, match="must divide the mesh's model axis"):
        native_server.main(["--preset", "tiny", "--device", "cpu", "--mesh-model", "3"])


def _serve(engine):
    from dstack_tpu_torch.native_server import make_server, start_warmup

    server, ready = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    start_warmup(engine, ready).join(timeout=60)
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def test_native_server_prefill_decode_pair_streams_the_unified_tokens():
    """A prefill-tier chat acks with finish_reason kv_handoff and the
    handoff id; the decode tier streams that request at
    /v1/handoffs/<id>, the unified server's tokens; the id is claimed once;
    both tiers report ready, their role and the affinity sketch."""
    from dstack_tpu_torch.native_server import Engine

    kw = dict(device="cpu", slots=2)
    dec = Engine("tiny", 8, role="decode", kv_transfer_port=0,
                 kv_transfer_host="127.0.0.1", **kw)
    pre = Engine("tiny", 8, role="prefill",
                 kv_transfer_connect=f"127.0.0.1:{dec.transfer_server.port}", **kw)
    uni = Engine("tiny", 8, **kw)
    servers = []
    try:
        (sd, bd), (sp, bp), (su, bu) = [_serve(e) for e in (dec, pre, uni)]
        servers = [sd, sp, su]
        msg = {"messages": [{"role": "user", "content": "split me"}], "max_tokens": 6,
               "temperature": 0}
        code, body = _call("POST", bu + "/v1/chat/completions", msg)
        want = json.loads(body)["choices"][0]["message"]["content"]
        code, body = _call("POST", bp + "/v1/chat/completions", msg)
        ack = json.loads(body)
        assert code == 200 and ack["choices"][0]["finish_reason"] == "kv_handoff"
        hid = ack["handoff_id"]
        assert ack["usage"]["handoff_id"] == hid and ack["usage"]["completion_tokens"] == 0
        code, body = _call("GET", bd + f"/v1/handoffs/{hid}")
        assert code == 200 and body.rstrip().endswith("data: [DONE]")
        events = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: {")]
        assert len(events) == 6 and all(e["id"] == hid for e in events)
        assert "".join(e["text"] for e in events) == want
        assert _call("GET", bd + f"/v1/handoffs/{hid}")[0] == 404  # claimed
        assert _call("GET", bd + "/v1/handoffs/x")[0] == 400
        for base, role in ((bp, "prefill"), (bd, "decode")):
            assert _call("GET", base + "/readyz")[0] == 200
            code, text = _call("GET", base + "/metrics?format=prometheus")
            assert f'dstack_tpu_serving_ttft_seconds_count{{role="{role}"}} 1' in text
            code, sketch = _call("GET", base + "/v1/affinity")
            assert code == 200 and json.loads(sketch)["block_size"] == 16
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for e in (pre, dec, uni):
            e.close()


def test_prefill_worker_runs_at_the_niceness_it_is_given():
    """--nice (the reference's isolation of a prefill flood on a shared
    host): WorkerProc passes it to the prefill worker only, and the worker
    runs deprioritised by that much before it builds anything."""
    from dstack_tpu_torch.workloads import serving_disagg

    worker = serving_disagg.WorkerProc("prefill", device="cpu", connect_port=1, nice=5)
    try:
        assert worker.proc.args[worker.proc.args.index("--nice") + 1] == "5"
        want = os.getpriority(os.PRIO_PROCESS, 0) + 5
        deadline = time.monotonic() + 60
        while os.getpriority(os.PRIO_PROCESS, worker.proc.pid) != want:
            assert worker.proc.poll() is None, "the worker exited before renicing"
            assert time.monotonic() < deadline, "the worker never reniced"
            time.sleep(0.05)
    finally:
        worker.proc.kill()
        worker.proc.wait(timeout=30)
    decode = serving_disagg.WorkerProc("decode", device="cpu", transfer_port=1, nice=5)
    try:
        assert "--nice" not in decode.proc.args
    finally:
        decode.proc.kill()
        decode.proc.wait(timeout=30)
