"""The PyTorch ServingEngine on the CPU against the JAX ServingEngine
(tiny, f32, bridged weights): identical temperature-0 token streams
through chunked prefill, the prefix cache and paged decode; block
accounting; refusal of unported options; the native server in process."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

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


@pytest.mark.parametrize("kw", [
    {"spec_enable": True}, {"mesh": object()}, {"lora_max_adapters": 2},
    {"role": "prefill"}, {"kv_transfer": object()},
    {"kv_host_budget_bytes": 1 << 20}, {"max_resident_slots": 2},
])
def test_unported_options_raise(weights, kw):
    _, tp = weights
    with pytest.raises(NotImplementedError):
        tsrv.ServingEngine(TCFG, tp, device="cpu", **{**ENGINE_KW, **kw})


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
