"""OpenAI-compatible model server over the PyTorch serving engine (the
unified subset of examples/deployment/native/server.py).

Endpoints: GET /v1/models (with `<model>:<adapter>` for each loaded LoRA
adapter), POST /v1/chat/completions (plain and SSE), POST /v1/adapters
and DELETE /v1/adapters/<name> (runtime adapter load and unload),
GET /healthz (liveness), GET /readyz (503 until the engine's warmup has
built the kernel and run every program once), GET /metrics (JSON, or
Prometheus text with ?format=prometheus or Accept: text/plain), GET
/v1/requests/<id>/trace (one request's phase timeline from the flight
recorder, by engine id or X-Request-ID; a JSON 404 when unknown). Every
JSON and SSE response echoes the request's `X-Request-ID` and
`Traceparent` (minted when absent or malformed), the identity that the
engine's flight recorder keeps for the request; a stream ends with a
`phase_summary` chunk (an empty-delta choice) before `[DONE]`.

Weights (`--checkpoint-dir`), in the reference's cold-start order: the
packed export first, then the params of the newest train-state
checkpoint (workloads/checkpoint.py); the load is bracketed by the
weights_start / weights_end stage markers. `--compile-cache-dir` (else
`$DSTACK_TPU_COMPILE_CACHE`) keeps the kernel library on a volume.

The tokenizer is the same toy byte-level one as the JAX server's, so the
server runs without a vocabulary download; swap in a real tokenizer for
real checkpoints.

Serving flags of examples/deployment/native/service.yml: speculative
decoding (`--spec-enable`, `--spec-max-draft`, `--spec-draft-preset`:
`int8` is the int8 quantization of the target; a preset name builds a
random drafter of that preset from a torch generator seeded at 1, which
cannot reproduce the JAX server's `jax.random` drafter), the KV budget
check (`--kv-budget-mb`), the host KV tier and slot overcommit
(`--kv-host-budget-mb`, `--max-resident-slots`) and QoS weights
(`--qos-weight TENANT=WEIGHT`). A request's tenant is its Bearer key, else
the adapter named in `model`, else "default", as the JAX server resolves
it; on a host-tier engine a heavier tenant may preempt a lighter one's
live slot. `--qos-rate` (requests/s, with `--qos-burst` and
`--qos-tenant-cap`) puts the per-tenant QoS gate (utils/qos.py) in front
of `submit`: a tenant over its token bucket gets a 429 with `Retry-After`,
and under contention admission follows weighted deficit round robin;
`/metrics` carries the per-tenant series (requests, sheds, TTFT) and, in
JSON, the gate's `qos` stats. `GET /v1/affinity` serves the engine's
cache-affinity sketch (chain-head digests, loaded adapters, the tokenizer's
parameters) from a 0.25 s cache.

Prefill/decode disaggregation, as the JAX server's `--role`: `--role
decode --kv-transfer-port P` admits handoffs on a KV transfer server at P
(0 picks a free port, printed as "kv transfer server on :P") and streams
each one at `GET /v1/handoffs/<id>` (SSE, one claim per id); `--role
prefill --kv-transfer-connect HOST:P` prefills and ships the KV, and its
chat answers with `finish_reason: "kv_handoff"` and the `handoff_id`.

Tensor parallelism, as the JAX server's `--mesh-model N`: the server is
rank 0 of a `torch.distributed` group of N ranks and starts ranks 1..N-1
itself, as fresh interpreters of this module (`--rank r --dist-init
tcp://127.0.0.1:<port>`, a loopback port the server picks), so a service
command stays one process. Rank r runs on `cuda:r`, or on `--device` for
every rank when it is given. Each rank loads the same weights and serves
its columns of them (workloads/sharding.py); the ranks of the split roles
do the same. `--dist-backend` is the port's transport switch: `nccl` (the
default on CUDA) for one rank per card, `gloo` (the default on the CPU)
for ranks that share a card; nccl with every rank on one card refuses
and names gloo. SIGTERM stops taking requests, waits for in-flight ones
(up to DRAIN_S), closes the engine, which stops the followers, and
reaps them: no rank outlives the server, and a follower whose server
disappears exits.

Multi-tenant LoRA, as the JAX server: `--adapter NAME=PATH` (repeatable)
preloads an adapter, PATH a `save_adapter` npz of either package or
`random` for a demo adapter; `--lora-max-adapters` sizes the device bank
(default: the number of `--adapter`s; 0 without them is no LoRA) and
`--lora-rank` its rank. A request picks its adapter with the OpenAI
`model` field, `"<model>:<adapter>"`: an unknown adapter answers 404, and
an engine without LoRA answers 400. A `random` adapter is drawn from a
torch generator seeded with the CRC-32 of its name (stable across runs;
the JAX server seeds `jax.random` from Python's `hash`, which changes with
PYTHONHASHSEED, so the two servers' random adapters differ anyway).

    python -m dstack_tpu_torch.native_server --preset smol-1b --port 9000
"""

import argparse
import codecs
import itertools
import json
import math
import signal
import sys
import threading
import time
import zlib
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from dstack_tpu_torch.utils.histogram import HistogramData
from dstack_tpu_torch.utils.qos import (
    DEFAULT_TENANT,
    QoSGate,
    TenantLabels,
    TenantShedError,
)
from dstack_tpu_torch.utils.stagemarkers import auto_stage
from dstack_tpu_torch.utils.tracecontext import ensure_request_trace
from dstack_tpu_torch.workloads import compile_cache
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.kv_transfer import TransferClient, TransferServer
from dstack_tpu_torch.workloads.lora_serving import (
    AdapterBusyError,
    AdapterPoolFullError,
    demo_adapter,
    load_adapter_file,
)
from dstack_tpu_torch.workloads.serving import (
    EngineOverloadedError,
    ServingEngine,
    prometheus_metrics,
    run_follower,
)
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads.transformer import init_params

# Prompts are bucketed to powers of two as in the JAX server, so both
# servers hand the engine the same prompt shapes.
MIN_BUCKET = 32
# Seconds a built affinity sketch is served before it is rebuilt.
AFFINITY_TTL_S = 0.25
# Seconds SIGTERM waits for in-flight requests before the engine closes.
DRAIN_S = 30.0


def encode_text(text: str, vocab_size: int, max_seq_len: int,
                max_new_tokens: int):
    """The byte tokenizer: token ids of `text`, left-padded with newline
    bytes to a power-of-two bucket (at least MIN_BUCKET), the OLDEST
    bytes truncated past it, within max_seq_len - max_new_tokens."""
    ids = [min(b, vocab_size - 1) for b in text.encode()] or [0]
    limit = max_seq_len - max_new_tokens
    ids = ids[-limit:] if limit > 0 else ids[:1]
    bucket = MIN_BUCKET
    while bucket * 2 <= len(ids):
        bucket *= 2
    bucket = min(bucket, limit if limit > 0 else bucket)
    if len(ids) < bucket:
        ids = [10] * (bucket - len(ids)) + ids
    else:
        ids = ids[-bucket:]
    return ids


def chat_text(messages) -> str:
    """The prompt text of a chat: one `role: content` line per message,
    then the assistant's turn."""
    return "\n".join(
        f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages
    ) + "\nassistant:"


class Engine:
    """Model + serving engine + byte tokenizer. With a `mesh` over ranks
    (sharding.make_mesh), rank 0's Engine drives the tensor-parallel
    engine; on ranks 1.. the constructor loads the same weights, follows
    rank 0's engine until it closes, and returns with `serving` None."""

    def __init__(self, preset: str, max_new_tokens: int,
                 checkpoint_dir: str = "", quantize: str = "none",
                 device: DeviceLike = None, slots: int = 8,
                 steps_per_sync: int = 4, max_prefills_per_chunk: int = 4,
                 prefill_chunk_tokens: int = 128, kv_block_size: int = 16,
                 max_pending: int = 16, seed: int = 0, params=None,
                 trace_ring: int = 256, trace_slow_ms: Optional[float] = None,
                 spec_enable: bool = False, spec_max_draft: int = 4,
                 spec_draft_preset: str = "int8", kv_budget_mb: int = 0,
                 kv_host_budget_mb: int = 0, max_resident_slots: int = 0,
                 qos_weights=None, qos_rate: float = 0.0, qos_burst: float = 20.0,
                 qos_tenant_cap: int = 64, lora_max_adapters: int = 0,
                 lora_rank: int = 8, adapters=(), role: str = "unified",
                 mesh=None, kv_transfer_connect: str = "",
                 kv_transfer_port: Optional[int] = None,
                 kv_transfer_host: str = "0.0.0.0"):
        self.config = PRESETS[preset]
        if max_new_tokens >= self.config.max_seq_len:
            raise ValueError(
                f"--max-new-tokens {max_new_tokens} must be <"
                f" max_seq_len {self.config.max_seq_len} for {preset}"
            )
        self.max_new_tokens = max_new_tokens
        self.device = resolve_device(device) if mesh is None else mesh.device
        leader = mesh is None or mesh.rank == 0
        auto_stage("weights_start")
        t0 = time.monotonic()
        weights_via = "given"
        if params is None and checkpoint_dir:
            from dstack_tpu_torch.workloads import checkpoint as ckpt

            # Cold-start order: the packed export, then the params of the
            # newest train-state checkpoint (its moments are not read).
            params = ckpt.load_packed(checkpoint_dir, self.device)
            weights_via = "packed"
            if params is None:
                params = ckpt.restore_latest_params(checkpoint_dir, self.device)
                weights_via = "checkpoint"
            if params is None:
                raise ValueError(
                    f"no packed export ({checkpoint_dir}/packed) and no"
                    f" train-state checkpoint under {checkpoint_dir}"
                )
        elif params is None:
            params = init_params(self.config, seed, self.device)
            weights_via = "init"
        if quantize == "int8":
            from dstack_tpu_torch.workloads.quant import quantize_params

            params = quantize_params(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        auto_stage("weights_end")
        self.weights_seconds = time.monotonic() - t0
        self.weights_via = weights_via
        # The drafter: the engine quantizes the target itself for "int8";
        # a preset name drafts with a random model of that preset.
        draft_params = draft_config = None
        if spec_enable and spec_draft_preset != "int8":
            draft_config = PRESETS[spec_draft_preset]
            draft_params = init_params(draft_config, 1, self.device)
        # A prefill tier ships finished KV blocks to the decode tier's
        # transfer server; its chat acks with finish_reason "kv_handoff".
        kv_transfer = None
        if role == "prefill" and leader:
            if not kv_transfer_connect:
                raise SystemExit(
                    "--role prefill requires --kv-transfer-connect host:port")
            host, _, port = kv_transfer_connect.rpartition(":")
            try:
                kv_transfer = TransferClient(host or "127.0.0.1", int(port))
            except ValueError:
                raise SystemExit(
                    f"--kv-transfer-connect {kv_transfer_connect!r} is not"
                    " host:port")
        self._handoff_ids = itertools.count(1)
        kw = dict(
            slots=slots, temperature=0.8,
            max_pending=max_pending, steps_per_sync=steps_per_sync,
            max_prefills_per_chunk=max_prefills_per_chunk,
            prefill_chunk_tokens=prefill_chunk_tokens,
            kv_block_size=kv_block_size, device=self.device,
            trace_ring=trace_ring, trace_slow_ms=trace_slow_ms,
            spec_enable=spec_enable, spec_max_draft=spec_max_draft,
            spec_draft_params=draft_params, spec_draft_config=draft_config,
            kv_budget_bytes=kv_budget_mb * (1 << 20) or None,
            kv_host_budget_bytes=kv_host_budget_mb * (1 << 20) or None,
            max_resident_slots=max_resident_slots or None,
            qos_weights=qos_weights or None,
            lora_max_adapters=lora_max_adapters, lora_rank=lora_rank,
            role=role, kv_transfer=kv_transfer,
        )
        if not leader:
            run_follower(mesh, self.config, params, **kw)
            self.serving = None
            return
        self.serving = ServingEngine(self.config, params, mesh=mesh, **kw)
        self.params = self.serving.params  # detached: serving builds no graph
        # --adapter NAME=PATH entries: "random" makes a demo adapter in
        # process; anything else is a save_adapter npz with its own rank
        # and alpha.
        self.lora_rank = lora_rank
        try:
            for entry in adapters:
                name, _, path = entry.partition("=")
                if not name or not path:
                    raise ValueError(f"--adapter {entry!r} is not NAME=PATH")
                try:
                    self.load_adapter(name, path)
                except (ValueError, RuntimeError, OSError) as e:
                    raise ValueError(f"--adapter {entry!r}: {e}") from e
        except ValueError:
            self.serving.close()
            raise
        # Per-tenant QoS in front of submit: token buckets shed floods (429
        # + Retry-After), the DRR queue orders admission under contention
        # for the decode slots. Off unless qos_rate > 0.
        self.qos = None
        if qos_rate > 0:
            self.qos = QoSGate(rate=qos_rate, burst=qos_burst,
                               tenant_cap=qos_tenant_cap,
                               weights=qos_weights or None,
                               concurrency=max(slots, max_pending))
        # Per-tenant series, bounded by the gate's labels when QoS is on.
        self.tenant_labels = (self.qos.labels if self.qos is not None
                              else TenantLabels(cap=qos_tenant_cap))
        self._tenant_lock = threading.Lock()
        self.tenant_requests = defaultdict(int)
        self.tenant_shed = defaultdict(int)
        self.tenant_ttft = defaultdict(HistogramData)
        # A decode tier admits handoffs through its transfer server and
        # parks each admitted stream for GET /v1/handoffs/<id>.
        self.handoff_streams = {}
        self.handoff_lock = threading.Lock()
        self.transfer_server = None
        if role == "decode" and kv_transfer_port is not None:
            self.transfer_server = TransferServer(
                kv_transfer_host, kv_transfer_port, self._on_handoff,
                epoch=self.serving.handoff_epoch)

    def _on_handoff(self, h) -> None:
        out = self.serving.submit_prefilled(h)
        with self.handoff_lock:
            self.handoff_streams[h.request_id] = out

    def close(self) -> None:
        if self.transfer_server is not None:
            self.transfer_server.close()
        self.serving.close()

    def record_tenant(self, tenant: str, *, shed: bool = False,
                      ttft: Optional[float] = None) -> None:
        """Count a tenant's request (or its shed), or observe its TTFT. A
        TTFT sample counts no second request (the JAX server's does)."""
        label = self.tenant_labels.label(tenant or DEFAULT_TENANT)
        with self._tenant_lock:
            if shed:
                self.tenant_shed[label] += 1
            elif ttft is None:
                self.tenant_requests[label] += 1
            if ttft is not None:
                self.tenant_ttft[label].observe(ttft)

    def tenant_metrics_lines(self) -> list:
        """The per-tenant Prometheus series appended to the engine's."""
        with self._tenant_lock:
            req = sorted(self.tenant_requests.items())
            shed = sorted(self.tenant_shed.items())
            ttft = sorted((t, h.to_dict()) for t, h in self.tenant_ttft.items())
        lines = ["# TYPE dstack_tpu_serving_tenant_requests_total counter"]
        lines += [f'dstack_tpu_serving_tenant_requests_total{{tenant="{t}"}} {n}'
                  for t, n in req]
        lines.append("# TYPE dstack_tpu_serving_tenant_shed_total counter")
        lines += [f'dstack_tpu_serving_tenant_shed_total{{tenant="{t}"}} {n}'
                  for t, n in shed]
        base = "dstack_tpu_serving_tenant_ttft_seconds"
        lines.append(f"# TYPE {base} histogram")
        for t, h in ttft:
            for le, cum in h["buckets"]:
                lines.append(f'{base}_bucket{{le="{le}",tenant="{t}"}} {cum}')
            lines.append(f'{base}_bucket{{le="+Inf",tenant="{t}"}} {h["count"]}')
            lines.append(f'{base}_sum{{tenant="{t}"}} {h["sum"]}')
            lines.append(f'{base}_count{{tenant="{t}"}} {h["count"]}')
        return lines

    def load_adapter(self, name: str, path: str, alpha: float = 16.0) -> int:
        """Load a LoRA adapter into the bank: `path` is a save_adapter npz,
        or "random" for a demo adapter seeded with the CRC-32 of `name`.
        Returns the bank slot. ValueError when the file's rank is not the
        engine's; RuntimeError on an engine without LoRA."""
        if path == "random":
            tree = demo_adapter(self.config, self.params, zlib.crc32(name.encode()),
                                rank=self.lora_rank, targets=("wq", "wv"))
            return self.serving.load_adapter(name, tree, alpha=alpha)
        tree, rank, file_alpha = load_adapter_file(path)
        if rank != self.lora_rank:
            raise ValueError(f"adapter {name!r} has rank {rank}, engine pool is"
                             f" rank {self.lora_rank}")
        return self.serving.load_adapter(name, tree, alpha=file_alpha)

    def encode(self, text: str):
        return encode_text(text, self.config.vocab_size, self.config.max_seq_len,
                           self.max_new_tokens)

    def decode(self, ids) -> str:
        return bytes(int(t) % 256 for t in ids).decode("utf-8", errors="replace")

    def chat_stream(self, messages, max_tokens=None, temperature=None,
                    top_p=None, usage_out=None, traceparent=None,
                    x_request_id=None, tenant=None, adapter=None):
        """Yield decoded text fragments as tokens land. Malformed
        per-request fields fall back to the server defaults; UTF-8 is
        decoded incrementally so multi-byte characters reassemble.
        `adapter` names a loaded LoRA adapter (KeyError when unknown,
        ValueError on an engine without LoRA)."""
        budget = self.max_new_tokens
        if max_tokens is not None:
            try:
                budget = max(1, min(int(max_tokens), self.max_new_tokens))
            except (TypeError, ValueError):
                pass
        temp = None
        if temperature is not None:
            try:
                v = float(temperature)
                if v == v and v != float("inf"):
                    temp = max(0.0, v)
            except (TypeError, ValueError):
                pass
        nucleus = 1.0
        if top_p is not None:
            try:
                v = float(top_p)
                if v == v:
                    nucleus = min(max(v, 1e-6), 1.0)
            except (TypeError, ValueError):
                pass
        tokens = self.encode(chat_text(messages))
        if usage_out is not None:
            usage_out["prompt_tokens"] = len(tokens)
            usage_out["completion_tokens"] = 0
        rid = None
        if self.serving.role == "prefill":
            # Carried on the KV handoff: the decode tier streams the
            # request at GET /v1/handoffs/<id>.
            rid = next(self._handoff_ids)
            if usage_out is not None:
                usage_out["handoff_id"] = rid
        # Arrival before QoS admission: the flight recorder's
        # qos_admission phase is the time spent at the gate.
        t_arrival = time.monotonic()
        granted = False
        if self.qos is not None:
            # Sheds (TenantShedError -> 429) or waits for the tenant's DRR
            # turn at a grant permit; the permit frees in `finally`.
            try:
                self.qos.admit(tenant or DEFAULT_TENANT)
            except TenantShedError:
                # Shed before the engine saw it: a one-shot terminal trace.
                self.serving.recorder.record_dropped(
                    x_request_id, x_request_id=x_request_id,
                    traceparent=traceparent, t0=t_arrival)
                raise
            granted = True
        t_submit = time.monotonic()
        try:
            out = self.serving.submit(tokens, max_new_tokens=budget,
                                      temperature=temp, top_p=nucleus,
                                      request_id=rid, traceparent=traceparent,
                                      x_request_id=x_request_id,
                                      tenant=tenant or DEFAULT_TENANT,
                                      adapter=adapter,
                                      t_arrival=t_arrival if granted else None)
        except BaseException:
            if granted:
                self.qos.release()
            raise
        self.record_tenant(tenant)
        dec = codecs.getincrementaldecoder("utf-8")("replace")
        ttft_seen = False
        try:
            while True:
                tok = out.get()
                if isinstance(tok, BaseException):
                    raise RuntimeError(f"generation failed: {tok}")
                if tok is None:
                    tail = dec.decode(b"", True)
                    if tail:
                        yield tail
                    if (self.serving.role == "prefill" and budget > 1
                            and usage_out is not None
                            and not usage_out.get("completion_tokens")):
                        # Handed off: the first token travels inside the KV
                        # handoff and the decode tier streams the rest;
                        # this response is the ack.
                        usage_out["finish_reason"] = "kv_handoff"
                    return
                if not ttft_seen:
                    ttft_seen = True
                    self.record_tenant(tenant, ttft=time.monotonic() - t_submit)
                if usage_out is not None:
                    usage_out["completion_tokens"] += 1
                piece = dec.decode(bytes([int(tok) % 256]))
                if piece:
                    yield piece
        finally:
            # Consumer gone mid-stream: stop decoding into a dead queue.
            self.serving.cancel(out)
            if granted:
                self.qos.release()

    def chat(self, messages, max_tokens=None, temperature=None, top_p=None,
             usage_out=None, traceparent=None, x_request_id=None,
             tenant=None, adapter=None) -> str:
        return "".join(self.chat_stream(messages, max_tokens, temperature,
                                        top_p, usage_out=usage_out,
                                        traceparent=traceparent,
                                        x_request_id=x_request_id,
                                        tenant=tenant, adapter=adapter))


def make_server(engine: Engine, host: str, port: int,
                model_name: str = "dstack-tpu-torch-native"):
    """(server, ready): a ThreadingHTTPServer bound to host:port serving
    `engine`, and the Event that flips /readyz to 200."""
    ready = threading.Event()
    # The affinity sketch is polled by every router worker: a short cache
    # bounds its cost at one build per TTL however many poll.
    sketch = {"at": 0.0, "body": None}
    sketch_lock = threading.Lock()

    def affinity():
        with sketch_lock:
            now = time.monotonic()
            if sketch["body"] is None or now - sketch["at"] > AFFINITY_TTL_S:
                sketch["body"] = {
                    **engine.serving.affinity_sketch(),
                    "model": model_name,
                    # What a router needs to recompute the same chain keys
                    # over the same block boundaries.
                    "tokenizer": {
                        "kind": "byte",
                        "vocab_size": engine.config.vocab_size,
                        "prompt_limit": engine.config.max_seq_len - engine.max_new_tokens,
                        "min_bucket": MIN_BUCKET,
                    },
                }
                sketch["at"] = now
            return sketch["body"]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def parse_request(self) -> bool:
            self._trace_state = {}  # one trace identity per request
            return super().parse_request()

        def _trace_identity(self):
            """(traceparent, request_id) of this request: the inbound
            `traceparent` and `X-Request-ID` when valid, minted otherwise,
            once per request, so the response echoes the pair the engine
            recorded (as examples/deployment/native/server.py does)."""
            hdrs = {k.lower(): v for k, v in self.headers.items()}
            return ensure_request_trace(self._trace_state, hdrs)

        def _send(self, code: int, obj, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            tp, rid = self._trace_identity()
            self.send_header("X-Request-ID", rid)
            self.send_header("Traceparent", tp)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_shed(self, e: TenantShedError) -> None:
            engine.record_tenant(e.tenant, shed=True)
            self._send(
                429,
                {"error": {"message": str(e), "type": "rate_limited",
                           "tenant": e.tenant, "retry_after": e.retry_after}},
                headers=[("Retry-After", str(max(1, math.ceil(e.retry_after))))],
            )

        def _send_overloaded(self, e: EngineOverloadedError) -> None:
            self._send(
                429,
                {"error": {"message": str(e), "type": "overloaded",
                           "retry_after": e.retry_after}},
                headers=[("Retry-After", str(int(e.retry_after + 0.5) or 1))],
            )

        def _chunk(self, delta, finish=None):
            return {
                "id": "chatcmpl-native", "object": "chat.completion.chunk",
                "created": int(time.time()), "model": model_name,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}],
            }

        def _request_identity(self, req):
            """(adapter, tenant) of a request, as the JAX server resolves
            them: the OpenAI `model` field selects the adapter
            ("base:adapter"); the tenant is the Bearer key when one was
            sent, else the adapter, else the default bucket."""
            model = req.get("model") or ""
            adapter = (model.split(":", 1)[1] or None) if ":" in model else None
            auth = self.headers.get("Authorization", "")
            key = auth[7:].strip() if auth.lower().startswith("bearer ") else ""
            return adapter, key or adapter or DEFAULT_TENANT

        def _stream(self, req) -> None:
            """OpenAI-style SSE: one delta chunk per decoded piece. The
            first piece is pulled before the 200 is committed, so a
            submit-time error is a clean JSON error."""
            tp, rid = self._trace_identity()
            adapter, tenant = self._request_identity(req)
            try:
                pieces = engine.chat_stream(
                    req.get("messages", []), req.get("max_tokens"),
                    req.get("temperature"), req.get("top_p"),
                    traceparent=tp, x_request_id=rid, tenant=tenant, adapter=adapter,
                )
                first = next(pieces)
            except StopIteration:
                first, pieces = "", iter(())
            except TenantShedError as e:
                return self._send_shed(e)
            except EngineOverloadedError as e:
                engine.record_tenant(tenant, shed=True)
                return self._send_overloaded(e)
            except KeyError as e:  # unknown adapter
                return self._send(404, {"error": f"unknown adapter: {e}"})
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:
                return self._send(500, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-ID", rid)
            self.send_header("Traceparent", tp)
            self.end_headers()
            try:
                for i, piece in enumerate(itertools.chain([first], pieces)):
                    delta = ({"content": piece} if i else
                             {"role": "assistant", "content": piece})
                    self.wfile.write(
                        b"data: " + json.dumps(self._chunk(delta)).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: " + json.dumps(
                    self._chunk({}, "length")).encode() + b"\n\n")
                # The flight recorder's phase summary of this stream, so the
                # client sees where its latency went without a second round
                # trip; an empty-delta choice, since SSE consumers commonly
                # index choices[0] unconditionally.
                trace = engine.serving.request_trace(rid)
                if trace is not None:
                    summary = self._chunk({})
                    summary["phase_summary"] = {
                        k: trace[k] for k in ("request_id", "trace_id", "total_seconds",
                                              "phases", "counters")}
                    self.wfile.write(b"data: " + json.dumps(summary).encode() + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")
            except Exception:
                # Headers are committed: truncating without [DONE] is the
                # SSE convention for a broken stream.
                return

        def do_GET(self):
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path == "/healthz":
                return self._send(200, {"ok": True})
            if path == "/readyz":
                if ready.is_set():
                    return self._send(200, {
                        "ready": True,
                        "warmup_seconds": engine.serving.stats()["warmup_seconds"],
                        "weights_seconds": round(engine.weights_seconds, 3),
                        "weights_via": engine.weights_via,
                    })
                return self._send(503, {"ready": False, "phase": "warmup"},
                                  headers=[("Retry-After", "2")])
            if path == "/v1/models":
                # Loaded adapters list as models of their own
                # (`base:adapter`), as the JAX server lists them.
                names = [model_name] + [f"{model_name}:{a}"
                                        for a in sorted(engine.serving.adapters())]
                return self._send(200, {"object": "list", "data": [
                    {"id": n, "object": "model", "created": 0, "owned_by": "dstack-tpu"}
                    for n in names]})
            if path == "/metrics":
                stats = engine.serving.stats()
                accept = self.headers.get("Accept", "")
                if "format=prometheus" in query or "text/plain" in accept:
                    body = "\n".join([prometheus_metrics(stats).rstrip("\n")]
                                     + engine.tenant_metrics_lines()).encode() + b"\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if engine.qos is not None:
                    stats = {**stats, "qos": engine.qos.stats()}
                return self._send(200, stats)
            if path == "/v1/affinity":
                return self._send(200, affinity())
            if path.startswith("/v1/handoffs/"):
                return self._stream_handoff(path)
            if path.startswith("/v1/requests/") and path.endswith("/trace"):
                # By engine request id or client X-Request-ID (the live ring
                # first, then the tail store).
                rid = path[len("/v1/requests/"):-len("/trace")]
                trace = engine.serving.request_trace(rid)
                if trace is None:
                    return self._send(404, {"error": f"no trace for request {rid!r}"})
                return self._send(200, trace)
            self._send(404, {"error": "not found"})

        def _stream_handoff(self, path: str) -> None:
            """Decode tier: a handed-off request's tokens as SSE events
            ({"id", "token", "text"}, then [DONE]). The claim is exclusive:
            two readers cannot interleave one stream."""
            try:
                rid = int(path.rsplit("/", 1)[1])
            except ValueError:
                return self._send(400, {"error": "handoff id must be int"})
            with engine.handoff_lock:
                out = engine.handoff_streams.pop(rid, None)
            if out is None:
                return self._send(404, {"error": f"no handoff {rid}"})
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                while True:
                    tok = out.get()
                    if tok is None:
                        self.wfile.write(b"data: [DONE]\n\n")
                        return
                    if isinstance(tok, BaseException):
                        return  # truncated without [DONE]: a broken stream
                    ev = {"id": rid, "token": int(tok), "text": engine.decode([tok])}
                    self.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                    self.wfile.flush()
            except OSError:
                engine.serving.cancel(out)  # reader gone: free the slot

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _load_adapter_route(self) -> None:
            """POST /v1/adapters {"name", "path", "alpha"?}: runtime adapter
            load or replace. 409 when every bank slot is pinned by
            in-flight requests or the adapter is busy (retryable); 400 on a
            shape or rank mismatch, a missing file or an engine without
            LoRA."""
            try:
                req = self._read_json()
            except json.JSONDecodeError as e:
                return self._send(400, {"error": f"bad json: {e}"})
            name, path = req.get("name"), req.get("path")
            if not name or not path:
                return self._send(400, {"error": "`name` and `path` are required"})
            try:
                slot = engine.load_adapter(name, path, alpha=float(req.get("alpha", 16.0)))
            except (AdapterPoolFullError, AdapterBusyError) as e:
                return self._send(409, {"error": str(e)})
            except (ValueError, OSError, RuntimeError) as e:
                return self._send(400, {"error": str(e)})
            self._send(200, {"name": name, "slot": slot, "model": f"{model_name}:{name}"})

        def do_DELETE(self):
            path = self.path.rstrip("/")
            prefix = "/v1/adapters/"
            if not path.startswith(prefix):
                return self._send(404, {"error": "not found"})
            name = path[len(prefix):]
            try:
                engine.serving.unload_adapter(name)
            except AdapterBusyError as e:
                return self._send(409, {"error": str(e)})
            except KeyError:
                return self._send(404, {"error": f"unknown adapter: {name}"})
            except RuntimeError as e:  # engine built without LoRA
                return self._send(400, {"error": str(e)})
            self._send(200, {"name": name, "unloaded": True})

        def do_POST(self):
            path = self.path.rstrip("/")
            if path == "/v1/adapters":
                return self._load_adapter_route()
            if path != "/v1/chat/completions":
                return self._send(404, {"error": "not found"})
            try:
                req = self._read_json()
            except json.JSONDecodeError as e:
                return self._send(400, {"error": f"bad json: {e}"})
            if req.get("stream"):
                return self._stream(req)
            usage = {}
            tp, rid = self._trace_identity()
            adapter, tenant = self._request_identity(req)
            try:
                text = engine.chat(req.get("messages", []), req.get("max_tokens"),
                                   req.get("temperature"), req.get("top_p"),
                                   usage_out=usage, traceparent=tp, x_request_id=rid,
                                   tenant=tenant, adapter=adapter)
            except TenantShedError as e:
                return self._send_shed(e)
            except EngineOverloadedError as e:
                engine.record_tenant(tenant, shed=True)
                return self._send_overloaded(e)
            except KeyError as e:  # unknown adapter
                return self._send(404, {"error": f"unknown adapter: {e}"})
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:
                return self._send(500, {"error": str(e)})
            finish = usage.pop("finish_reason", "length")
            handoff_id = usage.pop("handoff_id", None)
            usage["total_tokens"] = sum(usage.values())
            if handoff_id is not None:
                usage["handoff_id"] = handoff_id
            self._send(200, {
                "id": "chatcmpl-native",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": model_name,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish,
                }],
                "usage": usage,
                # Top level too, where the JAX server puts it.
                **({"handoff_id": handoff_id} if handoff_id is not None else {}),
            })

    class ModelHTTPServer(ThreadingHTTPServer):
        # A deeper accept backlog than BaseServer's 5: bursts must reach
        # admission control (429), not a kernel-level refusal.
        request_queue_size = 64
        daemon_threads = True
        # Requests being answered (HTTP/1.0: one per connection), which a
        # draining server waits for.
        active = 0
        _active_lock = threading.Lock()

        def process_request_thread(self, request, client_address):
            with self._active_lock:
                self.active += 1
            try:
                super().process_request_thread(request, client_address)
            finally:
                with self._active_lock:
                    self.active -= 1

    return ModelHTTPServer((host, port), Handler), ready


def start_warmup(engine: Engine, ready: threading.Event) -> threading.Thread:
    """Warm in the background; /readyz flips when warmup ends."""

    def _warm() -> None:
        try:
            r = engine.serving.warmup()
            print(f"warmup: {r['programs']} programs in {r['seconds']:.2f}s",
                  flush=True)
        except RuntimeError as e:
            # A request raced admission before warmup started; it pays
            # the build warmup would have.
            print(f"warmup skipped: {e}", flush=True)
        ready.set()

    t = threading.Thread(target=_warm, daemon=True, name="warmup")
    t.start()
    return t


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="smol-1b", choices=sorted(PRESETS))
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--model-name", default="dstack-tpu-torch-native")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu'"
                             " runs the plain PyTorch path)")
    parser.add_argument("--max-new-tokens", type=int, default=64)
    parser.add_argument("--checkpoint-dir", default="",
                        help="directory holding a save_packed export"
                             " (packed/manifest.json + weights.bin) from the JAX"
                             " package or the port's fine_tune, or else the port's"
                             " train-state checkpoints; without it weights are"
                             " random from --seed")
    parser.add_argument("--compile-cache-dir", default="",
                        help="kernel-library cache base dir (wins over"
                             " $DSTACK_TPU_COMPILE_CACHE); the library lands in a"
                             " leaf keyed by nvcc release and architecture")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quantize", default="none", choices=["none", "int8"])
    parser.add_argument("--max-pending", type=int, default=16)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--steps-per-sync", type=int, default=4)
    parser.add_argument("--max-prefills-per-chunk", type=int, default=4)
    parser.add_argument("--prefill-chunk-tokens", type=int, default=128)
    parser.add_argument("--kv-block-size", type=int, default=16)
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the warmup pass (the first request then"
                             " pays the kernel build)")
    parser.add_argument("--trace-ring", type=int, default=256,
                        help="flight-recorder ring size (retained request"
                             " traces); 0 disables per-request tracing")
    parser.add_argument("--trace-slow-ms", type=float, default=None,
                        help="tail-based capture threshold: full traces persist"
                             " only for requests at/above this many ms or ending"
                             " in error/shed (unset disables tail capture)")
    parser.add_argument("--spec-enable", action="store_true",
                        help="draft-model speculative decoding: a cheap"
                             " drafter proposes tokens, the target verifies"
                             " them in one forward (distribution-exact)")
    parser.add_argument("--spec-max-draft", type=int, default=4,
                        help="ceiling for the adaptive per-slot draft length")
    parser.add_argument("--spec-draft-preset", default="int8",
                        help="drafter model: 'int8' (quantized copy of the"
                             " target) or a preset name (random weights)")
    parser.add_argument("--kv-budget-mb", type=int, default=0,
                        help="KV pool memory budget in MiB (0 = unlimited);"
                             " with --spec-enable the target AND drafter"
                             " pools must both fit")
    parser.add_argument("--kv-host-budget-mb", type=int, default=0,
                        help="host-RAM KV tier budget in MiB (0 = no host"
                             " tier): evicted prefix-cache blocks spill here"
                             " instead of dying, and preempted slots park"
                             " their live KV chain here until resume")
    parser.add_argument("--max-resident-slots", type=int, default=0,
                        help="decode slots resident on the card (0 = --slots);"
                             " below --slots admitted streams overcommit the"
                             " card through the host tier (requires"
                             " --kv-host-budget-mb)")
    parser.add_argument("--qos-weight", action="append", default=[],
                        metavar="TENANT=WEIGHT",
                        help="per-tenant weight (repeatable; default 1.0):"
                             " with --kv-host-budget-mb a heavier tenant may"
                             " preempt a lighter tenant's live slot")
    parser.add_argument("--qos-rate", type=float, default=0.0,
                        help="per-tenant token-bucket refill rate"
                             " (requests/s); 0 disables QoS admission")
    parser.add_argument("--qos-burst", type=float, default=20.0,
                        help="per-tenant token-bucket capacity")
    parser.add_argument("--qos-tenant-cap", type=int, default=64,
                        help="distinct tenant labels before metrics"
                             " collapse into the overflow label")
    parser.add_argument("--role", default="unified",
                        choices=["unified", "prefill", "decode"],
                        help="serving tier: unified (default) runs prefill"
                             " and decode in-process; prefill ships finished"
                             " KV blocks to the decode tier; decode admits"
                             " handed-off requests on --kv-transfer-port")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="tensor-parallel ranks: the server starts ranks"
                             " 1..N-1 itself, rank r on cuda:r (or on --device)")
    parser.add_argument("--dist-backend", choices=sharding.BACKENDS, default=None,
                        help="transport between the ranks of --mesh-model:"
                             " nccl (default on CUDA, one rank per card) or gloo"
                             " (default on the CPU; ranks that share a card)")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dist-init", default="", help=argparse.SUPPRESS)
    parser.add_argument("--kv-transfer-port", type=int, default=None,
                        help="decode role: port the KV transfer server"
                             " listens on (0 picks a free one)")
    parser.add_argument("--kv-transfer-connect", default="",
                        help="prefill role: host:port of the decode tier's"
                             " KV transfer server")
    parser.add_argument("--adapter", action="append", default=[],
                        metavar="NAME=PATH",
                        help="preload a LoRA adapter (repeatable); PATH is an"
                             " .npz from save_adapter, or 'random' for a demo"
                             " adapter. Request it with model '<model>:NAME'")
    parser.add_argument("--lora-max-adapters", type=int, default=0,
                        help="device adapter-bank slots; 0 disables LoRA"
                             " multiplexing (defaults to the number of"
                             " --adapter entries when adapters are given)")
    parser.add_argument("--lora-rank", type=int, default=8,
                        help="rank of the device adapter bank; every loaded"
                             " adapter must match it")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if args.mesh_model < 1:
        raise SystemExit(f"--mesh-model must be >= 1, got {args.mesh_model}")
    if args.adapter and args.lora_max_adapters <= 0:
        args.lora_max_adapters = len(args.adapter)
    if args.spec_max_draft <= 0:
        raise SystemExit(
            f"--spec-max-draft must be positive, got {args.spec_max_draft}")
    if args.spec_draft_preset != "int8" and args.spec_draft_preset not in PRESETS:
        raise SystemExit(
            f"--spec-draft-preset {args.spec_draft_preset!r} is not a known"
            f" preset (choose 'int8' or one of: {', '.join(sorted(PRESETS))})"
        )
    if args.role == "decode" and args.kv_transfer_port is None:
        raise SystemExit("--role decode requires --kv-transfer-port")
    if args.max_resident_slots and not args.kv_host_budget_mb:
        raise SystemExit(
            "--max-resident-slots overcommit needs --kv-host-budget-mb"
            " (swapped-out slots park their KV in the host tier)"
        )
    qos_weights = {}
    for entry in args.qos_weight:
        tenant, _, weight = entry.partition("=")
        try:
            qos_weights[tenant] = float(weight)
        except ValueError:
            weight = ""
        if not tenant or not weight or qos_weights[tenant] <= 0:
            raise SystemExit(
                f"--qos-weight {entry!r} is not TENANT=WEIGHT"
                " with a positive weight"
            )
    # An explicit cache dir must be live before the engine's warmup or a
    # first request builds the kernel library.
    if args.compile_cache_dir:
        compile_cache.enable(args.compile_cache_dir)
    mesh, followers = None, []
    if args.mesh_model > 1:
        config = PRESETS[args.preset]
        try:
            sharding.check_heads(args.mesh_model, config)
            mesh, followers = sharding.join_ranks(
                args.mesh_model, args.rank, args.dist_init, args.dist_backend, args.device,
                ["-m", "dstack_tpu_torch.native_server", *argv])
        except ValueError as e:
            raise SystemExit(f"invalid serving configuration: {e}")
    try:
        engine = Engine(
            args.preset, args.max_new_tokens, args.checkpoint_dir,
            quantize=args.quantize, device=args.device, slots=args.slots,
            steps_per_sync=args.steps_per_sync,
            max_prefills_per_chunk=args.max_prefills_per_chunk,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            kv_block_size=args.kv_block_size, max_pending=args.max_pending,
            seed=args.seed, trace_ring=args.trace_ring,
            trace_slow_ms=args.trace_slow_ms, spec_enable=args.spec_enable,
            spec_max_draft=args.spec_max_draft,
            spec_draft_preset=args.spec_draft_preset,
            kv_budget_mb=args.kv_budget_mb,
            kv_host_budget_mb=args.kv_host_budget_mb,
            max_resident_slots=args.max_resident_slots,
            qos_weights=qos_weights, qos_rate=args.qos_rate,
            qos_burst=args.qos_burst, qos_tenant_cap=args.qos_tenant_cap,
            lora_max_adapters=args.lora_max_adapters, lora_rank=args.lora_rank,
            adapters=args.adapter, role=args.role, mesh=mesh,
            kv_transfer_connect=args.kv_transfer_connect,
            kv_transfer_port=args.kv_transfer_port, kv_transfer_host=args.host,
        )
    except BaseException as e:
        sharding.stop_followers(followers, timeout=0)
        if isinstance(e, ValueError):
            raise SystemExit(f"invalid serving configuration: {e}")
        raise
    if engine.serving is None:
        return  # a follower rank: its leader closed the engine
    leaf = engine.serving.stats()["compile_cache_dir"]
    if leaf:
        print(f"compile cache: {leaf}", flush=True)
    if engine.transfer_server is not None:
        print(f"kv transfer server on :{engine.transfer_server.port}", flush=True)
    server, ready = make_server(engine, args.host, args.port, args.model_name)
    print(f"native model server (torch, {engine.device}): {args.model_name}"
          f" on :{server.server_address[1]}", flush=True)
    if args.no_warmup:
        ready.set()
    else:
        start_warmup(engine, ready)
    stopping = threading.Event()

    def _on_sigterm(signum, frame):
        # serve_forever returns once shutdown() runs in another thread.
        stopping.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve_forever()
    finally:
        if stopping.is_set():
            drain(server, engine.serving, DRAIN_S)
        server.server_close()
        engine.close()
        sharding.stop_followers(followers)


def drain(server, serving: ServingEngine, timeout: float) -> bool:
    """After `server` stopped accepting: wait until the engine has nothing
    in flight or queued and every response is written (True), or
    `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if serving.idle() and server.active == 0:
            return True
        time.sleep(0.05)
    return False



if __name__ == "__main__":
    main()
