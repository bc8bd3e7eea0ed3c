"""Two-process prefill/decode disaggregation drill (the port of
`dstack_tpu.workloads.serving_disagg`).

`python -m dstack_tpu_torch.workloads.serving_disagg` spawns a DECODE
worker and a PREFILL worker as separate OS processes, wires them with the
kv_transfer seam over localhost TCP, and drives temperature-0 generations
at deliberately awkward lengths — prompts that end mid-chunk, decodes
that cross KV block boundaries, a one-token request that completes on the
prefill tier — then holds the split streams against a unified engine in
the parent, and checks zero block residue on both pools after clean ends,
a cancel mid-handoff, a stale-epoch rejection and trace continuity across
the two processes.

Streams: on the CPU (f32) the split streams must equal the unified ones
token for token. On the card the decode tier batches other slots together
than the unified engine, and the paged kernel's split plan follows the
batch, so bf16 may round a near-tie the other way: a stream that differs
must do so first where the dense plain forward's f32 logits put the two
tokens within NEAR_TIE_TOL of max |logit|, and every token of it must be
within NEAR_TIE_TOL of the dense argmax on its own prefix.

Weights: every process (the parent's unified engine and both workers)
draws them from the same seed with the port's own initializer on its own
device, and the drill checks that the three sets are equal (a sha1 of
every leaf's bytes). On CUDA the parent builds the kernel library into
the kernel cache before it spawns the workers, so neither pays the build.

`--device` defaults to CUDA. `--mesh-model N` makes each worker
tensor-parallel: a worker is rank 0 of its own group of N ranks and
starts ranks 1..N-1 itself (sharding.join_ranks), over `--dist-backend`
(nccl, one rank per card, by default on CUDA; gloo on the CPU and for
ranks that share a card). The prefill tier gathers every rank's KV heads
into the handoff, so the frame is the unsharded tier's, and each rank of
the decode tier keeps its heads of it. The parent's unified reference
stays on one device.

Control plane: each worker listens on a control socket speaking the
kv_transfer framing (length-prefixed JSON, no arrays). The prefill worker
takes {generate, cancel, stats, trace, digest, close}; the decode worker
pushes {token, done, error} events per handed-off request and takes
{stats, trace, digest, bump_epoch, close}. One connection per worker,
owned by the parent.
"""

import argparse
import hashlib
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from dstack_tpu_torch.workloads import compile_cache
from dstack_tpu_torch.workloads.kv_transfer import recv_msg, send_msg

_REPO_ROOT = str(Path(__file__).resolve().parents[2])
# The near-tie rule's tolerance on the card, by activation dtype.
NEAR_TIE_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ControlConn:
    """One framed-JSON control link; sends are locked so worker pump
    threads and command replies can share the socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()

    def send(self, header: Dict[str, Any]) -> None:
        with self._send_lock:
            send_msg(self._sock, header)

    def recv(self) -> Dict[str, Any]:
        return recv_msg(self._sock)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


# -- model and engines ---------------------------------------------------------


def params_digest(params) -> str:
    """sha1 over every leaf's name, dtype, shape and bytes."""
    from dstack_tpu_torch.workloads.weights import flatten_params

    h = hashlib.sha1()
    for name, t in sorted(flatten_params(params), key=lambda kv: kv[0]):
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _build_engine(args, role: str, kv_transfer=None, argv=()):
    """Engine construction shared by both workers and the parent's unified
    reference: weights from the seed on the process's own device. With
    `--mesh-model N` the worker is rank 0 of N (`argv`, its own command
    line, starts the others) and the engine is tensor-parallel; on ranks
    1.. this follows rank 0's engine until it closes and returns engine
    None. Returns (engine, params, the follower processes started)."""
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.serving import ServingEngine, run_follower
    from dstack_tpu_torch.workloads.transformer import init_params

    config = PRESETS[args.preset]
    mesh, followers, device = None, [], args.device
    if args.mesh_model > 1:
        sharding.check_heads(args.mesh_model, config)
        mesh, followers = sharding.join_ranks(
            args.mesh_model, args.rank, args.dist_init, args.dist_backend, args.device,
            ["-m", "dstack_tpu_torch.workloads.serving_disagg", *argv])
        device = mesh.device
    params = init_params(config, args.seed, device)
    kw = dict(
        slots=args.slots,
        max_len=args.max_len,
        steps_per_sync=args.steps_per_sync,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        kv_block_size=args.kv_block_size,
        spec_enable=args.spec,
        role=role,
        kv_transfer=kv_transfer,
    )
    if mesh is not None and mesh.rank > 0:
        run_follower(mesh, config, params, **kw)
        return None, params, followers
    return ServingEngine(config, params, mesh=mesh, device=device, **kw), params, followers


def _accept_control(port: int) -> ControlConn:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)
    conn, _ = srv.accept()
    srv.close()
    return ControlConn(conn)


def _common_reply(engine, params, msg) -> Optional[Dict[str, Any]]:
    """The replies both workers give: trace and digest (None otherwise)."""
    kind = msg.get("kind")
    if kind == "trace":
        return {"kind": "trace_reply", "id": msg.get("id"),
                "trace": _jsonable(engine.request_trace(msg.get("id")))}
    if kind == "digest":
        return {"kind": "digest_reply", "digest": params_digest(params)}
    return None


def run_decode_worker(args, argv=()) -> None:
    from dstack_tpu_torch.workloads.kv_transfer import TransferServer
    from dstack_tpu_torch.workloads.sharding import stop_followers

    engine, params, followers = _build_engine(args, role="decode", argv=argv)
    if engine is None:
        return  # a follower rank: its leader closed the engine
    engine.warmup()
    ctrl = _accept_control(args.control_port)

    def _pump(rid: int, out: "queue.Queue[object]") -> None:
        try:
            while True:
                tok = out.get(timeout=300)
                if tok is None:
                    ctrl.send({"kind": "done", "id": rid})
                    return
                if isinstance(tok, BaseException):
                    ctrl.send({"kind": "error", "id": rid, "error": str(tok)})
                    return
                ctrl.send({"kind": "token", "id": rid, "t": int(tok)})
        except OSError:
            return  # control link gone; the drill is over

    def on_handoff(h) -> None:
        out = engine.submit_prefilled(h)
        threading.Thread(target=_pump, args=(h.request_id, out), daemon=True).start()

    server = TransferServer("127.0.0.1", args.transfer_port, on_handoff,
                            epoch=engine.handoff_epoch)
    try:
        while True:
            msg = ctrl.recv()
            kind = msg.get("kind")
            reply = _common_reply(engine, params, msg)
            if reply is not None:
                ctrl.send(reply)
            elif kind == "stats":
                ctrl.send({
                    "kind": "stats_reply",
                    "stats": _jsonable(engine.stats()),
                    "transfer": {
                        "handoffs_accepted": server.handoffs_accepted,
                        "stale_rejected": server.stale_rejected,
                        "bytes_received": server.bytes_received,
                    },
                })
            elif kind == "bump_epoch":
                # Engine and transfer server bump in lockstep: the engine
                # enforces the fence, the server announces it.
                epoch = engine.bump_handoff_epoch()
                server.bump_epoch()
                ctrl.send({"kind": "bump_reply", "epoch": epoch})
            elif kind == "close":
                ctrl.send({"kind": "bye"})
                return
    except (ConnectionError, OSError):
        return
    finally:
        server.close()
        engine.close()
        stop_followers(followers)
        ctrl.close()


def run_prefill_worker(args, argv=()) -> None:
    if args.nice:
        # The isolation mechanism on a shared host: the prefill worker runs
        # CPU-deprioritised, so a prefill flood cannot take the cycles of a
        # co-located decode worker's loop.
        os.nice(args.nice)
    from dstack_tpu_torch.workloads.kv_transfer import TransferClient
    from dstack_tpu_torch.workloads.sharding import stop_followers

    if args.rank > 0:
        _build_engine(args, role="prefill", argv=argv)
        return  # a follower rank: rank 0 ships the handoffs
    client = TransferClient("127.0.0.1", args.connect_port,
                            retry_stale=not args.no_retry_stale)
    engine, params, followers = _build_engine(args, role="prefill", kv_transfer=client,
                                              argv=argv)
    engine.warmup()
    ctrl = _accept_control(args.control_port)
    outs: Dict[int, "queue.Queue[object]"] = {}

    def _wait(rid: int, out: "queue.Queue[object]", max_new: int) -> None:
        toks: List[int] = []
        try:
            while True:
                tok = out.get(timeout=300)
                if tok is None:
                    break
                if isinstance(tok, BaseException):
                    ctrl.send({"kind": "prefill_error", "id": rid, "error": str(tok)})
                    return
                toks.append(int(tok))
            if max_new <= 1:
                # One-token requests complete locally (never handed off).
                ctrl.send({"kind": "prefill_tokens", "id": rid, "tokens": toks})
            else:
                ctrl.send({"kind": "prefill_done", "id": rid})
        except OSError:
            return
        finally:
            outs.pop(rid, None)

    try:
        while True:
            msg = ctrl.recv()
            kind = msg.get("kind")
            reply = _common_reply(engine, params, msg)
            if reply is not None:
                ctrl.send(reply)
            elif kind == "generate":
                rid = int(msg["id"])
                out = engine.submit(
                    [int(t) for t in msg["prompt"]], int(msg["max_new_tokens"]),
                    temperature=float(msg.get("temperature", 0.0)),
                    top_p=float(msg.get("top_p", 1.0)),
                    request_id=rid,
                    traceparent=msg.get("traceparent"),
                    x_request_id=msg.get("x_request_id"),
                )
                outs[rid] = out
                threading.Thread(target=_wait,
                                 args=(rid, out, int(msg["max_new_tokens"])),
                                 daemon=True).start()
            elif kind == "cancel":
                out = outs.get(int(msg["id"]))
                if out is not None:
                    engine.cancel(out)
            elif kind == "stats":
                ctrl.send({
                    "kind": "stats_reply",
                    "stats": _jsonable(engine.stats()),
                    "transfer": {
                        "handoffs_sent": client.handoffs_sent,
                        "stale_rejects_seen": client.stale_rejects_seen,
                        "bytes_sent": client.bytes_sent,
                        "epoch": client.epoch,
                    },
                })
            elif kind == "close":
                ctrl.send({"kind": "bye"})
                return
    except (ConnectionError, OSError):
        return
    finally:
        engine.close()
        stop_followers(followers)
        client.close()
        ctrl.close()


# -- parent-side worker handle ------------------------------------------------


def worker_argv(role: str, control_port: int, *, device: Optional[str] = None,
                preset: str = "tiny", spec: bool = False, slots: int = 4,
                mesh_model: int = 1, dist_backend: Optional[str] = None,
                max_len: int = 256, steps_per_sync: int = 4,
                prefill_chunk_tokens: int = 128, kv_block_size: int = 16,
                transfer_port: Optional[int] = None,
                connect_port: Optional[int] = None,
                nice: int = 0, retry_stale: bool = True, seed: int = 0) -> List[str]:
    """One worker's command line. `device` None leaves `--device` out, so
    the worker takes the default device and, under `--mesh-model N`, its
    rank r takes cuda:r (sharding.join_ranks)."""
    argv = [
        sys.executable, "-m", "dstack_tpu_torch.workloads.serving_disagg",
        "--worker", role,
        "--preset", preset,
        "--control-port", str(control_port),
        "--slots", str(slots),
        "--max-len", str(max_len),
        "--steps-per-sync", str(steps_per_sync),
        "--prefill-chunk-tokens", str(prefill_chunk_tokens),
        "--kv-block-size", str(kv_block_size),
        "--seed", str(seed),
        "--mesh-model", str(mesh_model),
    ]
    if device is not None:
        argv += ["--device", device]
    if dist_backend:
        argv += ["--dist-backend", dist_backend]
    if spec:
        argv.append("--spec")
    if role == "decode":
        argv += ["--transfer-port", str(transfer_port)]
    else:
        argv += ["--connect-port", str(connect_port)]
        if nice:
            argv += ["--nice", str(nice)]
        if not retry_stale:
            argv.append("--no-retry-stale")
    return argv


class WorkerProc:
    """Spawn and control one worker process (its command line from
    `worker_argv`, which takes the keywords). Token and completion events
    go to per-request queues through a reader thread; command replies
    (stats_reply, bump_reply, trace_reply, digest_reply, bye) to a reply
    queue."""

    _EVENT_KINDS = ("token", "done", "error",
                    "prefill_done", "prefill_tokens", "prefill_error")

    def __init__(self, role: str, **kw):
        self.role = role
        self.control_port = _free_port()
        self.transfer_port = kw.get("transfer_port")
        argv = worker_argv(role, self.control_port, **kw)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p
        )
        self.proc = subprocess.Popen(argv, env=env, cwd=_REPO_ROOT)
        self._conn: Optional[ControlConn] = None
        self._replies: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self._streams: Dict[int, "queue.Queue[Dict[str, Any]]"] = {}
        self._streams_lock = threading.Lock()

    def connect(self, timeout: float = 240.0) -> None:
        """Block until the worker's control socket accepts (engine built
        and warmed up)."""
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"{self.role} worker exited rc={self.proc.returncode}"
                    " before accepting control connection"
                )
            try:
                sock = socket.create_connection(
                    ("127.0.0.1", self.control_port), timeout=2.0)
                sock.settimeout(None)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{self.role} worker control port never came up")
                time.sleep(0.25)
        self._conn = ControlConn(sock)
        threading.Thread(target=self._read_loop, daemon=True).start()

    def _read_loop(self) -> None:
        try:
            while True:
                msg = self._conn.recv()
                msg["t_recv"] = time.monotonic()  # stamped at receipt
                if msg.get("kind") in self._EVENT_KINDS:
                    self.stream(int(msg["id"])).put(msg)
                else:
                    self._replies.put(msg)
        except (ConnectionError, OSError):
            return

    def stream(self, rid: int) -> "queue.Queue[Dict[str, Any]]":
        with self._streams_lock:
            q = self._streams.get(rid)
            if q is None:
                q = self._streams[rid] = queue.Queue()
            return q

    def request(self, header: Dict[str, Any], timeout: float = 120.0) -> Dict[str, Any]:
        self._conn.send(header)
        return self._replies.get(timeout=timeout)

    def send(self, header: Dict[str, Any]) -> None:
        self._conn.send(header)

    def stats(self) -> Dict[str, Any]:
        return self.request({"kind": "stats"})

    def close(self) -> None:
        try:
            if self._conn is not None:
                self.request({"kind": "close"}, timeout=30.0)
        except Exception:
            pass
        finally:
            if self._conn is not None:
                self._conn.close()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


def collect_stream(worker: WorkerProc, rid: int, timeout: float = 300.0) -> List[int]:
    """Drain one decode-worker token stream to its done event."""
    q = worker.stream(rid)
    toks: List[int] = []
    while True:
        ev = q.get(timeout=timeout)
        kind = ev["kind"]
        if kind == "token":
            toks.append(int(ev["t"]))
        elif kind == "done":
            return toks
        elif kind == "error":
            raise RuntimeError(f"decode-side stream {rid}: {ev['error']}")


def wait_prefill(worker: WorkerProc, rid: int, timeout: float = 300.0) -> Dict[str, Any]:
    """Wait for the prefill worker's handoff resolution for `rid`."""
    return worker.stream(rid).get(timeout=timeout)


# -- the drill ---------------------------------------------------------------


def _drain(out) -> List[int]:
    toks: List[int] = []
    while True:
        t = out.get(timeout=300)
        if t is None:
            return toks
        if isinstance(t, BaseException):
            raise t
        toks.append(int(t))


def dense_logits(config, params, tokens) -> torch.Tensor:
    """The dense plain forward's f32 logits (V,) after `tokens`."""
    from dstack_tpu_torch.workloads.generate import _forward_cached, init_cache

    dev = params["embed"].device
    with torch.no_grad():
        logits, _ = _forward_cached(config, params, torch.tensor([list(tokens)], device=dev),
                                    init_cache(config, 1, len(tokens), dev))
    return logits[0].float()


def own_prefix_gaps(config, params, prompt, stream) -> List[float]:
    """At each position of a temperature-0 stream, the dense plain
    forward's f32 gap between its largest logit and the stream's token,
    over max |logit|, read on the stream's own prefix (prompt +
    stream[:j]): 0 where the token is the dense argmax. One causal forward
    over prompt + stream[:-1] reads every prefix's logits at once."""
    from dstack_tpu_torch.workloads.transformer import forward

    if not stream:
        return []
    dev = params["embed"].device
    tokens = torch.tensor([list(prompt) + list(stream[:-1])], device=dev)
    with torch.no_grad():
        logits = forward(config, params, tokens)[0, len(prompt) - 1:].float()
    got = logits.gather(1, torch.tensor(list(stream), device=dev)[:, None])[:, 0]
    return ((logits.max(1).values - got) / logits.abs().amax(1)).tolist()


def near_tie(config, params, prompt, ref, got, tol) -> Dict[str, Any]:
    """Two temperature-0 streams of one prompt held by the near-tie rule:
    equal, or at the first position where they differ the dense plain
    forward's f32 logits put the two tokens within `tol` x max |logit|
    of each other (bf16 rounds a batch of other rows or another KV split
    differently, so a near-tie may flip). A stream shorter or longer than
    the other fails at the first position one of them lacks. Past a flip
    the two streams go their own ways, so `got` is also held on its own
    prefix: every token of it within `tol` of the dense argmax there
    (`worst`, the largest such gap). A stream from a corrupted KV cache
    may flip first at a near-tie; it does not stay within `tol` after."""
    worst = max(own_prefix_gaps(config, params, prompt, got), default=0.0)
    at = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if at is None:
        if len(ref) == len(got):
            return dict(diverged=False, worst=worst, ok=worst <= tol)
        return dict(diverged=True, at=min(len(ref), len(got)), gap=None, worst=worst,
                    ok=False)
    logits = dense_logits(config, params, list(prompt) + list(ref[:at]))
    gap = float((logits[ref[at]] - logits[got[at]]).abs() / logits.abs().max())
    return dict(diverged=True, at=at, gap=gap, worst=worst, ok=gap <= tol and worst <= tol)


def run_drill(device: Optional[str] = None, mesh_model: int = 1, spec: bool = False,
              preset: str = "tiny", verbose: bool = True,
              dist_backend: Optional[str] = None) -> Dict[str, Any]:
    """Returns a report dict; raises AssertionError on any failed check."""
    from dstack_tpu_torch.workloads.device import resolve_device

    def log(msg: str) -> None:
        if verbose:
            print(f"[drill] {msg}", flush=True)

    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.sharding import check_backend, check_heads

    named = None if device is None else torch.device(device)
    if mesh_model > 1:
        # Refused here, before any worker starts, for the device the caller
        # named (none: each worker's rank r on cuda:r).
        check_heads(mesh_model, PRESETS[preset])
        check_backend(dist_backend or ("gloo" if named is not None and named.type == "cpu"
                                       else "nccl"), mesh_model, named)
    dev = resolve_device(device)
    max_len = 256
    # Awkward on purpose: 32 = exactly two 16-blocks; 29 ends mid-block;
    # 130 crosses the 128-token chunk budget with a remainder of 2;
    # budgets cross block boundaries mid-decode.
    scenarios = [
        {"prompt": list(range(1, 33)), "max_new": 35},    # block-aligned
        {"prompt": list(range(3, 32)), "max_new": 20},    # mid-block end
        {"prompt": [5 + (i % 90) for i in range(130)], "max_new": 24},
        {"prompt": list(range(7, 24)), "max_new": 1},     # prefill-local
        {"prompt": list(range(2, 50)), "max_new": 47},    # long decode
    ]
    args = argparse.Namespace(
        preset=preset, seed=0, mesh_model=1, rank=0, slots=4,
        max_len=max_len, steps_per_sync=4, prefill_chunk_tokens=128,
        kv_block_size=16, spec=spec, device=str(dev))
    compile_cache.prebuild(str(dev))

    log(f"reference: unified engine in the parent (device={dev}, spec={spec})")
    ref_engine, params, _ = _build_engine(args, role="unified")
    config = ref_engine.config
    try:
        ref = [_drain(ref_engine.submit(sc["prompt"], sc["max_new"]))
               for sc in scenarios]
    finally:
        ref_engine.close()
    digest = params_digest(params)
    log(f"reference lens: {[len(r) for r in ref]}")

    transfer_port = _free_port()
    kw = dict(device=device, preset=preset, spec=spec, max_len=max_len,
              mesh_model=mesh_model, dist_backend=dist_backend)
    log(f"spawning decode + prefill workers (mesh_model={mesh_model})")
    dec = WorkerProc("decode", transfer_port=transfer_port, **kw)
    pre = WorkerProc("prefill", connect_port=transfer_port, **kw)
    report: Dict[str, Any] = {"device": str(dev), "preset": preset,
                              "n_layers": config.n_layers, "spec": spec,
                              "mesh_model": mesh_model, "checks": {}}
    try:
        dec.connect()
        pre.connect()
        # Both tiers drew their weights from the same seed on their own
        # device: the three sets must be equal.
        digests = [digest] + [w.request({"kind": "digest"})["digest"] for w in (pre, dec)]
        log(f"params sha1 parent/prefill/decode: {[d[:12] for d in digests]}")
        assert len(set(digests)) == 1, digests
        report["checks"]["params_equal"] = True
        log("workers up; running scenarios")
        t0 = time.monotonic()
        for rid, sc in enumerate(scenarios):
            # A distinct caller-minted traceparent each, so the continuity
            # check below pins that both tiers kept the caller's trace_id.
            pre.send({"kind": "generate", "id": rid, "prompt": sc["prompt"],
                      "max_new_tokens": sc["max_new"],
                      "traceparent": f"00-{rid + 1:032x}-{rid + 1:016x}-01",
                      "x_request_id": f"drill-{rid}"})
        got: List[Optional[List[int]]] = [None] * len(scenarios)
        for rid, sc in enumerate(scenarios):
            res = wait_prefill(pre, rid)
            if res["kind"] == "prefill_tokens":
                got[rid] = [int(t) for t in res["tokens"]]
            elif res["kind"] == "prefill_done":
                got[rid] = collect_stream(dec, rid)
            else:
                raise AssertionError(f"scenario {rid} failed: {res}")
        report["scenarios_seconds"] = time.monotonic() - t0
        exact = got == ref
        report["checks"]["bit_exact"] = exact
        log(f"disagg lens: {[len(g) for g in got]}; bit-exact: {exact}")
        if dev.type == "cpu":
            assert exact, [(i, a[:6], b[:6])
                           for i, (a, b) in enumerate(zip(got, ref)) if a != b]
        else:
            tol = NEAR_TIE_TOL[config.activation_dtype]
            ties = [near_tie(config, params, sc["prompt"], r, g, tol)
                    for sc, r, g in zip(scenarios, ref, got)]
            report["checks"]["near_tie"] = ties
            log(f"near-tie rule (tol {tol:g}): {ties}")
            assert all(t["ok"] for t in ties), ties

        # Trace continuity: one trace spanning both processes.
        log("trace continuity across tiers")
        pt = pre.request({"kind": "trace", "id": 0})["trace"]
        dt = dec.request({"kind": "trace", "id": 0})["trace"]
        assert pt is not None and dt is not None, (pt, dt)
        assert pt["trace_id"] == dt["trace_id"] == f"{1:032x}", (
            pt["trace_id"], dt["trace_id"])
        assert pt["x_request_id"] == "drill-0"
        p_phases = [p["phase"] for p in pt["phases"]]
        d_phases = [p["phase"] for p in dt["phases"]]
        assert p_phases == ["queue_wait", "prefill", "kv_ship"], p_phases
        assert d_phases == ["queue_wait", "kv_adopt", "decode"], d_phases
        for tier, tr in (("prefill", pt), ("decode", dt)):
            assert tr["status"] == "ok", (tier, tr["status"])
            drift = abs(sum(p["duration_s"] for p in tr["phases"]) - tr["total_seconds"])
            assert drift < 1e-9, (tier, drift)
        assert pt["counters"]["kv_payload_bytes"] == dt["counters"]["kv_payload_bytes"] > 0
        assert dt["counters"]["decode_steps"] >= 1
        report["checks"]["trace_continuity"] = True

        # Cancel mid-handoff: a long prompt cancelled at once.
        log("cancel mid-handoff")
        pre.send({"kind": "generate", "id": 77,
                  "prompt": [3 + (i % 80) for i in range(140)], "max_new_tokens": 30})
        pre.send({"kind": "cancel", "id": 77})
        res = wait_prefill(pre, 77, timeout=120)
        assert res["kind"] == "prefill_done", res
        # Either outcome is legal: dropped before the handoff (the prefill
        # trace ends "cancelled"), or handed off and decoded to its end
        # unaware of the cancel ("ok"); zero residue must hold after both.
        status = pre.request({"kind": "trace", "id": 77})["trace"]["status"]
        report["checks"]["cancel_resolution"] = status
        assert status in ("cancelled", "ok"), status
        if status == "ok":
            collect_stream(dec, 77)

        # Stale epoch: bump the decode epoch; the next handoff is rejected
        # once, and the client's single retry with the new epoch lands.
        log("stale-epoch rejection")
        bump = dec.request({"kind": "bump_epoch"})
        assert bump["kind"] == "bump_reply", bump
        pre.send({"kind": "generate", "id": 88, "prompt": list(range(9, 60)),
                  "max_new_tokens": 12})
        res = wait_prefill(pre, 88)
        assert res["kind"] == "prefill_done", res
        toks = collect_stream(dec, 88)
        assert len(toks) == 12, len(toks)
        stale_seen = pre.stats()["transfer"]["stale_rejects_seen"]
        stale_rej = dec.stats()["transfer"]["stale_rejected"]
        log(f"stale rejects: client saw {stale_seen}, server counted {stale_rej}")
        report["checks"]["stale_reject_recovered"] = stale_seen >= 1 and stale_rej >= 1
        assert stale_seen >= 1 and stale_rej >= 1

        # Zero block residue on both pools (the prefix cache holds blocks
        # at ref 1, so in_use == cached is the no-leak condition).
        deadline = time.monotonic() + 10
        while True:
            pre_stats, dec_stats = pre.stats(), dec.stats()
            clean = all(st["stats"]["kv_blocks_in_use"] == st["stats"]["kv_blocks_cached"]
                        for st in (pre_stats, dec_stats))
            if clean or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        for name, st in (("prefill", pre_stats), ("decode", dec_stats)):
            s = st["stats"]
            log(f"{name}: in_use={s['kv_blocks_in_use']} cached={s['kv_blocks_cached']}"
                f" role={s['role']}")
            assert s["kv_blocks_in_use"] == s["kv_blocks_cached"], (
                name, s["kv_blocks_in_use"], s["kv_blocks_cached"])
        report["checks"]["zero_residue"] = True
        s = pre_stats["stats"]
        assert s["kv_handoffs_sent_total"] >= 5, s["kv_handoffs_sent_total"]
        assert s["kv_transfer_bytes_total"] > 0
        assert s["kv_transfer_bytes_total"] == dec_stats["stats"]["kv_transfer_bytes_total"]
        report["handoffs_sent"] = s["kv_handoffs_sent_total"]
        report["transfer_bytes"] = s["kv_transfer_bytes_total"]
        # The prefill tier's kv_transfer_seconds (pack to ack, across the
        # two processes).
        hist = s["kv_transfer_hist"]
        report["transfer_seconds_mean"] = hist["sum"] / hist["count"]
        report["transfer_gb_per_s"] = s["kv_transfer_bytes_total"] / hist["sum"] / 1e9
        report["ok"] = True
        log("drill OK")
        return report
    finally:
        pre.close()
        dec.close()


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--worker", choices=["decode", "prefill"],
                        help="internal: run as a worker process")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu'"
                             " runs the plain PyTorch path)")
    parser.add_argument("--preset", default="tiny")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="tensor-parallel ranks per worker (each worker"
                             " starts its ranks 1..N-1 itself)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="transport between a worker's ranks: nccl (default"
                             " on CUDA, one rank per card) or gloo (default on"
                             " the CPU; ranks that share a card)")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dist-init", default="", help=argparse.SUPPRESS)
    parser.add_argument("--spec", action="store_true",
                        help="speculative decoding on (drafter KV rides the"
                             " handoff)")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-len", type=int, default=256)
    parser.add_argument("--steps-per-sync", type=int, default=4)
    parser.add_argument("--prefill-chunk-tokens", type=int, default=128)
    parser.add_argument("--kv-block-size", type=int, default=16)
    parser.add_argument("--control-port", type=int, default=0)
    parser.add_argument("--transfer-port", type=int, default=0,
                        help="decode worker: port the transfer server binds")
    parser.add_argument("--connect-port", type=int, default=0,
                        help="prefill worker: decode transfer port to dial")
    parser.add_argument("--nice", type=int, default=0,
                        help="prefill worker: CPU-deprioritise by this"
                             " niceness (the bench's isolation mechanism)")
    parser.add_argument("--no-retry-stale", action="store_true",
                        help="prefill worker: fail handoffs on stale-epoch"
                             " rejects instead of refreshing and retrying")
    parser.add_argument("--out", default="", help="write the drill report JSON here")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if args.worker == "decode":
        run_decode_worker(args, argv)
        return
    if args.worker == "prefill":
        run_prefill_worker(args, argv)
        return
    report = run_drill(device=args.device, mesh_model=args.mesh_model, spec=args.spec,
                       preset=args.preset, dist_backend=args.dist_backend)
    blob = json.dumps(report, indent=2, default=str)
    if args.out:
        Path(args.out).write_text(blob)
    print(blob)


if __name__ == "__main__":
    main()
