"""OpenAI-compatible model server over the PyTorch serving engine (the
unified subset of examples/deployment/native/server.py).

Endpoints: GET /v1/models, POST /v1/chat/completions (plain and SSE),
GET /healthz (liveness), GET /readyz (503 until the engine's warmup has
built the kernel and run every program once), GET /metrics (JSON, or
Prometheus text with ?format=prometheus or Accept: text/plain). Every
JSON and SSE response echoes the request's `X-Request-ID` and
`Traceparent` (minted when absent or malformed), the identity that the
engine's flight recorder keeps for the request.

The tokenizer is the same toy byte-level one as the JAX server's, so the
server runs without a vocabulary download; swap in a real tokenizer for
real checkpoints.

    python -m dstack_tpu_torch.native_server --preset smol-1b --port 9000
"""

import argparse
import codecs
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dstack_tpu_torch.utils.tracecontext import ensure_request_trace
from dstack_tpu_torch.workloads.config import PRESETS
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.serving import (
    EngineOverloadedError,
    ServingEngine,
    prometheus_metrics,
)
from dstack_tpu_torch.workloads.transformer import init_params


class Engine:
    """Model + serving engine + byte tokenizer."""

    # Prompts are bucketed to powers of two as in the JAX server, so both
    # servers hand the engine the same prompt shapes.
    MIN_BUCKET = 32

    def __init__(self, preset: str, max_new_tokens: int,
                 checkpoint_dir: str = "", quantize: str = "none",
                 device: DeviceLike = None, slots: int = 8,
                 steps_per_sync: int = 4, max_prefills_per_chunk: int = 4,
                 prefill_chunk_tokens: int = 128, kv_block_size: int = 16,
                 max_pending: int = 16, seed: int = 0, params=None):
        self.config = PRESETS[preset]
        if max_new_tokens >= self.config.max_seq_len:
            raise ValueError(
                f"--max-new-tokens {max_new_tokens} must be <"
                f" max_seq_len {self.config.max_seq_len} for {preset}"
            )
        self.max_new_tokens = max_new_tokens
        self.device = resolve_device(device)
        t0 = time.monotonic()
        weights_via = "given"
        if params is None and checkpoint_dir:
            from dstack_tpu_torch.workloads.weights import load_packed

            params = load_packed(checkpoint_dir, self.device)
            if params is None:
                raise ValueError(
                    f"no packed export under {checkpoint_dir}/packed"
                    " (the port reads checkpoint.save_packed exports only)"
                )
            weights_via = "packed"
        elif params is None:
            params = init_params(self.config, seed, self.device)
            weights_via = "init"
        if quantize == "int8":
            from dstack_tpu_torch.workloads.quant import quantize_params

            params = quantize_params(params)
        self.weights_seconds = time.monotonic() - t0
        self.weights_via = weights_via
        self.serving = ServingEngine(
            self.config, params, slots=slots, temperature=0.8,
            max_pending=max_pending, steps_per_sync=steps_per_sync,
            max_prefills_per_chunk=max_prefills_per_chunk,
            prefill_chunk_tokens=prefill_chunk_tokens,
            kv_block_size=kv_block_size, device=self.device,
        )
        self.params = self.serving.params  # detached: serving builds no graph

    def encode(self, text: str):
        ids = [min(b, self.config.vocab_size - 1) for b in text.encode()] or [0]
        limit = self.config.max_seq_len - self.max_new_tokens
        ids = ids[-limit:] if limit > 0 else ids[:1]
        # Bucket to a power of two: pad short prompts left with newline
        # bytes, truncate the OLDEST bytes down to the bucket otherwise.
        bucket = self.MIN_BUCKET
        while bucket * 2 <= len(ids):
            bucket *= 2
        bucket = min(bucket, limit if limit > 0 else bucket)
        if len(ids) < bucket:
            ids = [10] * (bucket - len(ids)) + ids
        else:
            ids = ids[-bucket:]
        return ids

    def decode(self, ids) -> str:
        return bytes(int(t) % 256 for t in ids).decode("utf-8", errors="replace")

    def chat_stream(self, messages, max_tokens=None, temperature=None,
                    top_p=None, usage_out=None, traceparent=None,
                    x_request_id=None):
        """Yield decoded text fragments as tokens land. Malformed
        per-request fields fall back to the server defaults; UTF-8 is
        decoded incrementally so multi-byte characters reassemble."""
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
        prompt = "\n".join(
            f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages
        )
        tokens = self.encode(prompt + "\nassistant:")
        if usage_out is not None:
            usage_out["prompt_tokens"] = len(tokens)
            usage_out["completion_tokens"] = 0
        out = self.serving.submit(tokens, max_new_tokens=budget,
                                  temperature=temp, top_p=nucleus,
                                  traceparent=traceparent,
                                  x_request_id=x_request_id)
        dec = codecs.getincrementaldecoder("utf-8")("replace")
        try:
            while True:
                tok = out.get()
                if isinstance(tok, BaseException):
                    raise RuntimeError(f"generation failed: {tok}")
                if tok is None:
                    tail = dec.decode(b"", True)
                    if tail:
                        yield tail
                    return
                if usage_out is not None:
                    usage_out["completion_tokens"] += 1
                piece = dec.decode(bytes([int(tok) % 256]))
                if piece:
                    yield piece
        finally:
            # Consumer gone mid-stream: stop decoding into a dead queue.
            self.serving.cancel(out)

    def chat(self, messages, max_tokens=None, temperature=None, top_p=None,
             usage_out=None, traceparent=None, x_request_id=None) -> str:
        return "".join(self.chat_stream(messages, max_tokens, temperature,
                                        top_p, usage_out=usage_out,
                                        traceparent=traceparent,
                                        x_request_id=x_request_id))


def make_server(engine: Engine, host: str, port: int,
                model_name: str = "dstack-tpu-torch-native"):
    """(server, ready): a ThreadingHTTPServer bound to host:port serving
    `engine`, and the Event that flips /readyz to 200."""
    ready = threading.Event()

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

        def _stream(self, req) -> None:
            """OpenAI-style SSE: one delta chunk per decoded piece. The
            first piece is pulled before the 200 is committed, so a
            submit-time error is a clean JSON error."""
            tp, rid = self._trace_identity()
            try:
                pieces = engine.chat_stream(
                    req.get("messages", []), req.get("max_tokens"),
                    req.get("temperature"), req.get("top_p"),
                    traceparent=tp, x_request_id=rid,
                )
                first = next(pieces)
            except StopIteration:
                first, pieces = "", iter(())
            except EngineOverloadedError as e:
                return self._send_overloaded(e)
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
                return self._send(200, {"object": "list", "data": [{
                    "id": model_name, "object": "model", "created": 0,
                    "owned_by": "dstack-tpu",
                }]})
            if path == "/metrics":
                stats = engine.serving.stats()
                accept = self.headers.get("Accept", "")
                if "format=prometheus" in query or "text/plain" in accept:
                    body = prometheus_metrics(stats).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                return self._send(200, stats)
            self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path.rstrip("/") != "/v1/chat/completions":
                return self._send(404, {"error": "not found"})
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                return self._send(400, {"error": f"bad json: {e}"})
            if req.get("stream"):
                return self._stream(req)
            usage = {}
            tp, rid = self._trace_identity()
            try:
                text = engine.chat(req.get("messages", []), req.get("max_tokens"),
                                   req.get("temperature"), req.get("top_p"),
                                   usage_out=usage, traceparent=tp, x_request_id=rid)
            except EngineOverloadedError as e:
                return self._send_overloaded(e)
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:
                return self._send(500, {"error": str(e)})
            self._send(200, {
                "id": "chatcmpl-native",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": model_name,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": "length",
                }],
                "usage": {**usage, "total_tokens": sum(usage.values())},
            })

    class ModelHTTPServer(ThreadingHTTPServer):
        # A deeper accept backlog than BaseServer's 5: bursts must reach
        # admission control (429), not a kernel-level refusal.
        request_queue_size = 64
        daemon_threads = True

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
                             " package or the port's fine_tune;"
                             " without it weights are random from --seed")
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
    args = parser.parse_args(argv)
    try:
        engine = Engine(
            args.preset, args.max_new_tokens, args.checkpoint_dir,
            quantize=args.quantize, device=args.device, slots=args.slots,
            steps_per_sync=args.steps_per_sync,
            max_prefills_per_chunk=args.max_prefills_per_chunk,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            kv_block_size=args.kv_block_size, max_pending=args.max_pending,
            seed=args.seed,
        )
    except ValueError as e:
        raise SystemExit(f"invalid serving configuration: {e}")
    server, ready = make_server(engine, args.host, args.port, args.model_name)
    print(f"native model server (torch, {engine.device}): {args.model_name}"
          f" on :{server.server_address[1]}", flush=True)
    if args.no_warmup:
        ready.set()
    else:
        start_warmup(engine, ready)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.serving.close()


if __name__ == "__main__":
    main()
