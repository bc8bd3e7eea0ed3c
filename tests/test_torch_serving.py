"""The PyTorch ServingEngine on the CPU against the JAX ServingEngine
(tiny, f32, bridged weights): identical temperature-0 token streams
through chunked prefill, the prefix cache and paged decode; block
accounting; refusal of the one unported option (a mesh) and validation
of the ported ones; the native server in process, with service.yml's flags too."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dstack_tpu.server.metrics_registry import METRICS
from dstack_tpu.workloads import serving as jsrv
from dstack_tpu.workloads.config import PRESETS as JPRESETS
from dstack_tpu.workloads.transformer import init_params as jinit
from dstack_tpu_torch.workloads import serving as tsrv
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.weights import params_from_numpy

JCFG = JPRESETS["tiny"].with_(dtype="float32")
TCFG = PRESETS["tiny"].with_(dtype="float32")
ENGINE_KW = dict(slots=4, max_len=96, prefill_chunk_tokens=16, kv_block_size=8)


@pytest.fixture(scope="module")
def weights():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=120)
        if isinstance(tok, BaseException):
            raise tok
        if tok is None:
            return out
        out.append(tok)


def _prompt(seed, n):
    return [(i * 37 + seed * 13 + 5) % 100 + 1 for i in range(n)]


PREFIX = _prompt(7, 24)
REQUESTS = [  # (prompt, max_new_tokens)
    (_prompt(1, 5), 9),
    (_prompt(2, 27), 8),            # crosses chunk (16) and block (8) bounds
    (PREFIX + [3, 5], 6),           # shares a 24-token prefix ...
    (_prompt(3, 41), 7),            # three chunks
    (PREFIX + [11, 13, 17], 6),     # ... with this one
    (_prompt(5, 1), 5),
]


def _serve(engine, waves):
    """Submit each wave concurrently, drain it, then the next; the
    prefix sharers sit in different waves so the second can hit."""
    out = []
    for wave in waves:
        qs = [engine.submit(p, max_new_tokens=n, temperature=0.0) for p, n in wave]
        out += [_drain(q) for q in qs]
    return out


def test_engine_token_streams_match_jax_engine(weights):
    jp, tp = weights
    waves = [REQUESTS[:4], REQUESTS[4:]]
    je = jsrv.ServingEngine(JCFG, jp, **ENGINE_KW)
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", **ENGINE_KW)
    try:
        want = _serve(je, waves)
        got = _serve(te, waves)
        jst, tst = je.stats(), te.stats()
    finally:
        je.close()
        te.close()
    assert got == want
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    for key in ("prefix_cache_hits_total", "prefix_tokens_reused_total",
                "prefill_chunks_total", "prefill_tokens_computed_total",
                "kv_blocks_in_use", "kv_blocks_cached", "admitted_total"):
        assert tst[key] == jst[key], key
    assert tst["prefix_tokens_reused_total"] >= 24
    assert tst["attn_path"] == "plain" and tst["attn_dispatch_plain_total"] > 0
    assert tst["attn_dispatch_cuda_total"] == 0


def test_blocks_drain_when_idle_and_cancel_frees_them(weights):
    _, tp = weights
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", prefix_cache=False,
                            steps_per_sync=1, **ENGINE_KW)
    try:
        te.warmup()
        assert _drain(te.submit(_prompt(1, 20), max_new_tokens=5)) and \
            te.stats()["kv_blocks_in_use"] == 0
        q = te.submit(_prompt(2, 30), max_new_tokens=60)
        first = q.get(timeout=60)
        assert isinstance(first, int)
        te.cancel(q)
        assert isinstance(_drain(q), list)
        assert te.stats()["kv_blocks_in_use"] == 0
        te.cancel(q)  # idempotent after the end
    finally:
        te.close()


def test_cancel_of_a_queued_request_answers_at_once(weights):
    _, tp = weights
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", slots=1, max_len=96,
                            prefill_chunk_tokens=16, kv_block_size=8)
    try:
        busy = te.submit(_prompt(1, 10), max_new_tokens=40)
        queued = te.submit(_prompt(2, 10), max_new_tokens=4)
        te.cancel(queued)
        assert _drain(queued) == []
        assert len(_drain(busy)) == 40
        assert te.stats()["kv_blocks_in_use"] == te.stats()["kv_blocks_cached"]
    finally:
        te.close()


def test_params_that_require_grad_serve_without_autograd(weights):
    """Params straight from a train state (requires_grad=True) serve the
    same temperature-0 tokens as detached ones, and nothing the engine or
    generate produces carries an autograd graph."""
    import torch

    from dstack_tpu_torch.workloads.generate import generate
    from dstack_tpu_torch.workloads.weights import flatten_params

    _, tp = weights
    trained = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    streams = {}
    for name, params in (("detached", tp), ("requires_grad", trained)):
        eng = tsrv.ServingEngine(TCFG, params, device="cpu", **ENGINE_KW)
        try:
            streams[name] = [_drain(eng.submit(p, n, temperature=0.0))
                             for p, n in REQUESTS[:3]]
            assert not any(t.requires_grad for _, t in flatten_params(eng.params))
            for t in (eng.state.k, eng.state.v, eng.state.last_token):
                assert t.grad_fn is None and not t.requires_grad
        finally:
            eng.close()
    assert streams["requires_grad"] == streams["detached"]
    prompt = torch.tensor([REQUESTS[1][0]])
    out = generate(TCFG, trained, prompt, max_new_tokens=4)
    assert out.grad_fn is None and not out.requires_grad
    assert out.tolist() == generate(TCFG, tp, prompt, max_new_tokens=4).tolist()


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"mesh": "seq"}])
def test_unported_options_raise(weights, kw):
    """A mesh serves over ranks (tests/test_torch_sharding.py); an object
    that is not a mesh of the port, and a one-device seq mesh (the ring's,
    a training axis), are refused."""
    _, tp = weights
    if kw["mesh"] == "seq":
        from dstack_tpu_torch.workloads.sharding import make_mesh

        kw = {"mesh": make_mesh(["cpu"], seq=2)}
    with pytest.raises(NotImplementedError):
        tsrv.ServingEngine(TCFG, tp, device="cpu", **{**ENGINE_KW, **kw})


# Pool bytes of ENGINE_KW's pool (tiny f32: 2 layers x 48 blocks x 8 rows
# x k and v of 2 heads x 32), as the reference counts them.
ONE_POOL = 2 * 48 * 8 * 2 * 2 * 32 * 4


@pytest.mark.parametrize("kw,match", [
    (dict(spec_enable=True, spec_draft_config=TCFG.with_(vocab_size=300)),
     "vocab_size 300 must match"),
    (dict(spec_enable=True, spec_draft_config=TCFG.with_(max_seq_len=64)),
     "must cover the engine window 96"),
    (dict(max_resident_slots=2), "requires a host tier"),
    (dict(max_resident_slots=5, kv_host_budget_bytes=1 << 20), r"in \[1, slots=4\]"),
    (dict(spec_enable=True, kv_budget_bytes=int(ONE_POOL * 1.5)),
     "drafter KV pool alongside the target pool"),
    (dict(kv_budget_bytes=ONE_POOL - 1), "cannot fit the KV pool"),
    (dict(spec_enable=True, spec_max_draft=0), "spec_max_draft must be >= 1"),
])
def test_ctor_validation_of_the_ported_options(weights, kw, match):
    """The reference's messages for the drafter's vocab and window, the
    resident cap without a tier or out of range, and a KV budget that
    fits one pool but not the drafter's beside it."""
    _, tp = weights
    if "spec_draft_config" in kw:
        kw = {**kw, "spec_draft_params": tp}
    with pytest.raises(ValueError, match=match):
        tsrv.ServingEngine(TCFG, tp, device="cpu", **{**ENGINE_KW, **kw})
    # ONE_POOL is exactly the pool's size: it fits, one byte less does not.
    tsrv.ServingEngine(TCFG, tp, device="cpu", kv_budget_bytes=ONE_POOL,
                       **ENGINE_KW).close()


def test_submit_validates_like_the_reference(weights):
    _, tp = weights
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", max_pending=0, **ENGINE_KW)
    try:
        for bad in (dict(tokens=[], max_new_tokens=3),
                    dict(tokens=[1], max_new_tokens=0),
                    dict(tokens=[1], max_new_tokens=3, temperature=float("nan")),
                    dict(tokens=[1], max_new_tokens=3, top_p=0.0),
                    dict(tokens=[1] * 90, max_new_tokens=10)):
            with pytest.raises(ValueError):
                te.submit(**bad)
    finally:
        te.close()


def test_prometheus_series_are_registered(weights):
    _, tp = weights
    te = tsrv.ServingEngine(TCFG, tp, device="cpu", **ENGINE_KW)
    try:
        te.warmup()
        _drain(te.submit(_prompt(1, 9), max_new_tokens=3))
        text = tsrv.prometheus_metrics(te.stats())
    finally:
        te.close()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split()
            assert name in METRICS and METRICS[name][0] == mtype, line
    assert 'dstack_tpu_serving_attn_dispatch_total{path="plain"}' in text


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def test_native_server_in_process_on_cpu():
    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

    engine = Engine("tiny", max_new_tokens=8, device="cpu", slots=2)
    server, ready = make_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        start_warmup(engine, ready).join(timeout=60)
        assert _http("GET", base + "/readyz")[0] == 200
        assert _http("GET", base + "/healthz")[0] == 200
        code, body = _http("GET", base + "/v1/models")
        assert code == 200 and json.loads(body)["data"][0]["id"]
        msg = {"messages": [{"role": "user", "content": "hi"}],
               "max_tokens": 5, "temperature": 0}
        code, body = _http("POST", base + "/v1/chat/completions", msg)
        resp = json.loads(body)
        assert code == 200 and resp["usage"]["completion_tokens"] == 5
        code, body = _http("POST", base + "/v1/chat/completions",
                           {**msg, "stream": True})
        assert code == 200 and body.rstrip().endswith("data: [DONE]")
        code, body = _http("GET", base + "/metrics")
        stats = json.loads(body)
        assert code == 200 and stats["admitted_total"] == 2
        code, body = _http("GET", base + "/metrics?format=prometheus")
        assert code == 200 and "dstack_tpu_serving_admitted_total 2" in body
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.serving.close()


def test_native_server_echoes_the_request_trace_identity():
    """As the JAX server (tests/test_serving_http.py): X-Request-ID and
    Traceparent come back on a 200, a 400 and a stream, the caller's when
    valid and minted otherwise, and the engine's flight recorder keeps the
    same pair for the request."""
    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

    engine = Engine("tiny", max_new_tokens=4, device="cpu", slots=2)
    server, ready = make_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    tp = f"00-{'f0' * 16}-{'1b' * 8}-01"
    msg = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
           "temperature": 0}

    def post(data, headers):
        req = urllib.request.Request(base + "/v1/chat/completions", data=data,
                                     headers={"Content-Type": "application/json",
                                              **headers})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read().decode()

    try:
        start_warmup(engine, ready).join(timeout=60)
        given = {"X-Request-ID": "trace-test-1", "traceparent": tp}
        minted = {"X-Request-ID": "bad id!", "traceparent": "00-zz-1b-01"}
        for body, code in ((json.dumps(msg).encode(), 200), (b"{not json", 400),
                           (json.dumps({**msg, "stream": True}).encode(), 200)):
            status, hdrs, text = post(body, given)
            assert status == code, text
            assert hdrs["X-Request-ID"] == "trace-test-1"
            assert hdrs["Traceparent"] == tp
            status, hdrs, text = post(body, minted)
            assert status == code, text
            rid, got_tp = hdrs["X-Request-ID"], hdrs["Traceparent"]
            assert len(rid) == 16 and int(rid, 16) >= 0, rid
            assert got_tp != tp and len(got_tp.split("-")) == 4, got_tp
            if code == 200:
                rec = engine.serving.recorder.get(rid)
                assert rec["x_request_id"] == rid and rec["traceparent"] == got_tp
        rec = engine.serving.recorder.get("trace-test-1")
        assert rec["traceparent"] == tp and rec["trace_id"] == "f0" * 16
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.serving.close()


def _serve_http(**engine_kw):
    from dstack_tpu_torch.native_server import Engine, make_server, start_warmup

    engine = Engine("tiny", max_new_tokens=4, device="cpu", slots=2, **engine_kw)
    server, ready = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    start_warmup(engine, ready).join(timeout=60)

    def stop():
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
        engine.serving.close()

    return engine, f"http://127.0.0.1:{server.server_address[1]}", stop


def _post(base, body, headers=()):
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **dict(headers)})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def _get_error(url):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url, timeout=60)
    return err.value.code, json.loads(err.value.read().decode())


MSG = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3, "temperature": 0}


def test_request_trace_endpoint_by_request_id_and_engine_id():
    """GET /v1/requests/<id>/trace by X-Request-ID or the engine's id
    (examples/deployment/native/server.py), a JSON 404 when unknown."""
    engine, base, stop = _serve_http()
    try:
        assert _post(base, MSG, {"X-Request-ID": "trace-me-1"})[0] == 200
        code, body = _http("GET", base + "/v1/requests/trace-me-1/trace")
        trace = json.loads(body)
        assert code == 200 and trace["x_request_id"] == "trace-me-1"
        assert trace["status"] == "ok" and trace["counters"]["decode_tokens"] >= 1
        phases = [p["phase"] for p in trace["phases"]]
        assert phases[:2] == ["queue_wait", "prefill"] and "decode" in phases
        code, by_id = _http("GET", base + f"/v1/requests/{trace['request_id']}/trace")
        assert code == 200 and json.loads(by_id)["x_request_id"] == "trace-me-1"
        assert engine.serving.request_trace("trace-me-1")["request_id"] == trace["request_id"]
        code, err = _get_error(base + "/v1/requests/no-such-request/trace")
        assert code == 404 and "no-such-request" in err["error"]
    finally:
        stop()


def _sse_chunks(body):
    return [json.loads(line[len("data: "):]) for line in body.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_stream_ends_with_a_phase_summary_chunk():
    engine, base, stop = _serve_http()
    try:
        code, body = _post(base, {**MSG, "stream": True}, {"X-Request-ID": "stream-1"})
        assert code == 200 and body.rstrip().endswith("data: [DONE]")
        chunks = _sse_chunks(body)
        summary = chunks[-1]
        assert "phase_summary" not in chunks[-2]
        # An empty-delta choice, so a client indexing choices[0] survives it.
        assert summary["choices"] == [{"index": 0, "delta": {}, "finish_reason": None}]
        ps = summary["phase_summary"]
        assert set(ps) == {"request_id", "trace_id", "total_seconds", "phases", "counters"}
        assert ps == {k: engine.serving.request_trace("stream-1")[k] for k in ps}
        assert ps["total_seconds"] > 0 and ps["phases"]
    finally:
        stop()


def test_trace_ring_zero_disables_request_traces():
    engine, base, stop = _serve_http(trace_ring=0, trace_slow_ms=5.0)
    try:
        assert not engine.serving.recorder.enabled
        assert engine.serving.recorder.tail.slow_ms == 5.0
        assert _post(base, MSG, {"X-Request-ID": "untraced"})[0] == 200
        assert _get_error(base + "/v1/requests/untraced/trace")[0] == 404
        code, body = _post(base, {**MSG, "stream": True})
        assert code == 200 and body.rstrip().endswith("data: [DONE]")
        assert not any("phase_summary" in c for c in _sse_chunks(body))
        code, body = _http("GET", base + "/metrics?format=prometheus")
        assert code == 200 and "dstack_tpu_compile_cache_hits_total 0" in body
    finally:
        stop()


def test_native_server_main_passes_trace_and_cache_flags(tmp_path, monkeypatch):
    """--trace-ring / --trace-slow-ms reach the engine, and
    --compile-cache-dir is enabled before the engine starts (it wins over
    $DSTACK_TPU_COMPILE_CACHE; the nvcc release is stubbed here)."""
    from dstack_tpu_torch import native_server
    from dstack_tpu_torch.workloads import compile_cache

    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(compile_cache, "nvcc_version", lambda: "12.9")
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    seen = {}

    class Stop(Exception):
        pass

    def fake_make_server(engine, host, port, model_name):
        seen["recorder"] = engine.serving.recorder
        seen["leaf"] = compile_cache.enabled_dir()
        engine.serving.close()
        raise Stop

    monkeypatch.setattr(native_server, "make_server", fake_make_server)
    with pytest.raises(Stop):
        native_server.main(["--preset", "tiny", "--device", "cpu", "--max-new-tokens", "4",
                            "--trace-ring", "3", "--trace-slow-ms", "7.5",
                            "--compile-cache-dir", str(tmp_path / "flag")])
    assert seen["recorder"].capacity == 3 and seen["recorder"].tail.slow_ms == 7.5
    assert seen["leaf"] == str(tmp_path / "flag" / "nvcc12.9-sm90a")
    assert compile_cache.enable_from_env() == seen["leaf"]


NEW_SERIES = (
    "dstack_tpu_serving_spec_rounds_total", "dstack_tpu_serving_spec_tokens_accepted_total",
    "dstack_tpu_serving_spec_accept_rate_ewma", "dstack_tpu_serving_kv_host_bytes",
    "dstack_tpu_serving_kv_swap_ins_total", "dstack_tpu_serving_slot_preemptions_total",
    "dstack_tpu_serving_slot_swap_ins_total", "dstack_tpu_serving_slots_swapped",
    "dstack_tpu_serving_prefix_cache_host_hits_total",
    "dstack_tpu_serving_kv_swap_in_seconds_count",
)


def test_native_server_runs_service_yml_flags_on_cpu(monkeypatch):
    """examples/deployment/native/service.yml's command line, with
    `--preset tiny --device cpu` and no checkpoint: main() starts, two
    tenants (Bearer keys) are served and resolve to their tenants, and
    /metrics in both formats carries the speculation and host-tier
    series under the JAX names."""
    import chip_smoke as cs
    from dstack_tpu_torch import native_server

    argv = cs.service_argv("tiny", port=0) + ["--device", "cpu", "--max-new-tokens", "16"]
    assert "--spec-enable" in argv and "--qos-weight" in argv and "--checkpoint-dir" not in argv
    started, seen = threading.Event(), {}
    real_make = native_server.make_server

    def make(engine, host, port, model_name):
        server, ready = real_make(engine, "127.0.0.1", port, model_name)
        seen.update(server=server, ready=ready, engine=engine)
        started.set()
        return server, ready

    monkeypatch.setattr(native_server, "make_server", make)
    tenants = []
    th = threading.Thread(target=native_server.main, args=(argv,), daemon=True)
    th.start()
    assert started.wait(120)
    eng = seen["engine"]
    real_submit = eng.serving.submit

    def submit(*a, **kw):
        tenants.append(kw.get("tenant"))
        return real_submit(*a, **kw)

    eng.serving.submit = submit
    base = f"http://127.0.0.1:{seen['server'].server_address[1]}"
    try:
        assert seen["ready"].wait(120)
        st = eng.serving.stats()
        assert st["spec_enabled"] and st["kv_host_enabled"] and st["max_resident_slots"] == 8
        assert st["slots"] == 32 and st["kv_block_size"] == 32
        assert eng.serving._qos_weights == {"paid": 4.0, "besteffort": 1.0}
        body = {**MSG, "max_tokens": 6}
        for key in ("besteffort", "paid"):
            code, text = _post(base, body, {"Authorization": f"Bearer {key}"})
            assert code == 200 and json.loads(text)["usage"]["completion_tokens"] == 6
        assert _post(base, MSG)[0] == 200
        assert tenants == ["besteffort", "paid", "default"]
        code, text = _http("GET", base + "/v1/affinity")
        sketch = json.loads(text)
        assert code == 200 and sketch["block_size"] == 32 and sketch["digests"]
        assert sketch["digests"] == eng.serving.affinity_sketch()["digests"]
        code, text = _http("GET", base + "/metrics")
        stats = json.loads(text)
        assert code == 200 and stats["spec_rounds_total"] > 0 and stats["admitted_total"] == 3
        code, text = _http("GET", base + "/metrics?format=prometheus")
        for name in NEW_SERIES:
            assert name in text, name
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, mtype = line.split()
                assert name in METRICS and METRICS[name][0] == mtype, line
    finally:
        seen["server"].shutdown()
        th.join(timeout=30)
    assert not th.is_alive()


@pytest.mark.parametrize("extra,message", [
    (["--spec-max-draft", "0"], "--spec-max-draft must be positive"),
    (["--spec-draft-preset", "nope"], "is not a known preset"),
    (["--max-resident-slots", "2"], "needs --kv-host-budget-mb"),
    (["--qos-weight", "paid"], "is not TENANT=WEIGHT"),
    (["--qos-weight", "paid=-1"], "is not TENANT=WEIGHT"),
])
def test_native_server_flag_validation(extra, message, capsys):
    from dstack_tpu_torch import native_server

    with pytest.raises(SystemExit, match=message):
        native_server.main(["--preset", "tiny", "--device", "cpu"] + extra)


def test_native_server_preset_drafter_is_seeded():
    """--spec-draft-preset <preset>: a random drafter of that preset from
    the torch generator seeded at 1, the same on every boot."""
    from dstack_tpu_torch.native_server import Engine
    from dstack_tpu_torch.workloads.transformer import init_params

    engine = Engine("tiny", 8, device="cpu", slots=2, spec_enable=True,
                    spec_draft_preset="tiny")
    try:
        want = init_params(PRESETS["tiny"], 1, "cpu")
        got = engine.serving._draft_params
        assert torch.equal(got["embed"], want["embed"])
        assert not torch.equal(got["embed"], engine.params["embed"])
    finally:
        engine.serving.close()


# -- multi-tenant LoRA on the server ------------------------------------------------


def _post_code(base, body, path="/v1/chat/completions", method="POST"):
    """(status, JSON body) of a request, error statuses included."""
    req = urllib.request.Request(base + path, method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_an_adapter_request_is_never_served_by_the_base_model():
    """`model: "m:t1"` names an adapter: a server without LoRA answers 400
    (plain and streamed), a LoRA server answers 404 for an adapter it has
    not loaded, and 200 with t1's tokens, not the base's, when t1 is."""
    msg = {**MSG, "model": "m:t1", "max_tokens": 4}
    engine, base, stop = _serve_http()
    try:
        assert _post_code(base, msg)[0] == 400
        assert _post_code(base, {**msg, "stream": True})[0] == 400
        assert _post_code(base, MSG)[0] == 200
    finally:
        stop()
    engine, base, stop = _serve_http(lora_max_adapters=2, adapters=["t1=random"])
    try:
        for body in ({**msg, "model": "m:ghost"}, {**msg, "model": "m:ghost", "stream": True}):
            code, text = _post_code(base, body)
            assert code == 404 and "ghost" in text
        code, text = _post_code(base, msg)
        assert code == 200
        got = json.loads(text)["choices"][0]["message"]["content"]
        msgs, kw = msg["messages"], dict(max_tokens=4, temperature=0.0)
        assert got == engine.chat(msgs, adapter="t1", **kw)
        assert got != engine.chat(msgs, **kw)
        assert engine.serving._lora.inflight == 0
    finally:
        stop()


def test_native_server_adapter_flags_models_load_and_unload(tmp_path, monkeypatch):
    """main() with `--adapter t1=random --adapter t2=<npz>` on port 0:
    /v1/models lists both, chats on m:t1, m:t2 and m answer 200, DELETE
    unloads (then m:t1 is a 404), POST /v1/adapters reloads from an npz
    (409 while the adapter is busy, 400 on a rank mismatch), and the
    Prometheus text carries the adapters_loaded gauge."""
    from dstack_tpu_torch import native_server
    from dstack_tpu_torch.workloads.lora_serving import demo_adapter, save_adapter
    from dstack_tpu_torch.workloads.transformer import init_params

    cfg = PRESETS["tiny"]
    params = init_params(cfg, 0, "cpu")
    npz, bad = str(tmp_path / "t2.npz"), str(tmp_path / "r4.npz")
    save_adapter(npz, demo_adapter(cfg, params, 5, rank=8), rank=8, alpha=16.0)
    save_adapter(bad, demo_adapter(cfg, params, 5, rank=4), rank=4)
    started, seen = threading.Event(), {}
    real_make = native_server.make_server

    def make(engine, host, port, model_name):
        server, ready = real_make(engine, "127.0.0.1", port, model_name)
        seen.update(server=server, ready=ready, engine=engine)
        started.set()
        return server, ready

    monkeypatch.setattr(native_server, "make_server", make)
    argv = ["--preset", "tiny", "--device", "cpu", "--port", "0", "--slots", "2",
            "--model-name", "m", "--max-new-tokens", "8",
            "--adapter", "t1=random", "--adapter", f"t2={npz}"]
    th = threading.Thread(target=native_server.main, args=(argv,), daemon=True)
    th.start()
    assert started.wait(120)
    eng = seen["engine"]
    base = f"http://127.0.0.1:{seen['server'].server_address[1]}"
    try:
        assert seen["ready"].wait(120)
        st = eng.serving.stats()
        assert st["lora_max_adapters"] == 2 and st["adapters_loaded"] == 2
        ids = [m["id"] for m in json.loads(_http("GET", base + "/v1/models")[1])["data"]]
        assert ids == ["m", "m:t1", "m:t2"]
        texts = {}
        for model in ("m:t1", "m:t2", "m"):
            code, text = _post_code(base, {**MSG, "model": model, "max_tokens": 6})
            assert code == 200, (model, text)
            texts[model] = json.loads(text)["choices"][0]["message"]["content"]
        assert len(set(texts.values())) == 3  # each adapter changes the stream
        assert _post_code(base, None, "/v1/adapters/t1", "DELETE")[0] == 200
        assert _post_code(base, None, "/v1/adapters/t1", "DELETE")[0] == 404
        assert _post_code(base, {**MSG, "model": "m:t1"})[0] == 404
        code, text = _post_code(base, {"name": "t1", "path": npz}, "/v1/adapters")
        assert code == 200 and json.loads(text)["model"] == "m:t1"
        assert _post_code(base, {**MSG, "model": "m:t1"})[0] == 200
        assert _post_code(base, {"name": "t3", "path": bad}, "/v1/adapters")[0] == 400
        assert _post_code(base, {"name": "t3"}, "/v1/adapters")[0] == 400
        eng.serving._lora.acquire("t1")  # an in-flight request's ref
        try:
            assert _post_code(base, {"name": "t1", "path": npz}, "/v1/adapters")[0] == 409
            assert _post_code(base, None, "/v1/adapters/t1", "DELETE")[0] == 409
        finally:
            eng.serving._lora.release("t1")
        code, text = _http("GET", base + "/metrics?format=prometheus")
        assert "dstack_tpu_serving_adapters_loaded 2" in text
        assert eng.serving._lora.inflight == 0
    finally:
        seen["server"].shutdown()
        th.join(timeout=30)
    assert not th.is_alive()


def test_native_server_random_adapter_is_seeded_by_its_name():
    from dstack_tpu_torch.native_server import Engine

    banks = []
    for _ in range(2):
        engine = Engine("tiny", 8, device="cpu", slots=2, lora_max_adapters=2,
                        adapters=["t1=random", "t2=random"])
        try:
            banks.append({k: v.clone() for k, v in engine.serving._lora.bank["layers"].items()})
        finally:
            engine.serving.close()
    for k, v in banks[0].items():
        assert torch.equal(v, banks[1][k]) and v.any()
        assert not torch.equal(v[:, 0], v[:, 1])  # two names, two adapters


@pytest.mark.parametrize("extra,message", [
    (["--adapter", "t1"], "is not NAME=PATH"),
    (["--adapter", "t1=/nonexistent.npz"], "--adapter 't1=/nonexistent.npz'"),
])
def test_native_server_refuses_a_bad_adapter_flag(extra, message):
    from dstack_tpu_torch import native_server

    with pytest.raises(SystemExit, match=message):
        native_server.main(["--preset", "tiny", "--device", "cpu", "--slots", "2"] + extra)
