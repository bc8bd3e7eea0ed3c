"""KV-block handoff seam between a prefill worker and a decode engine (the
port of `dstack_tpu.workloads.kv_transfer`, wire-compatible with it).

Prefill/decode disaggregation: a prefill-role `ServingEngine` runs
chunked prefill on its own card, then ships each finished request's KV
blocks — the pool rows its block table points at, gathered per block,
never as a dense `(max_len, KV, hd)` view — plus the allocator-side
metadata (prompt, first sampled token, sampling params, budget) to the
decode engine, which allocates fresh blocks from ITS pool, scatters the
payload in, and goes straight to decode. Block ids are local to each
pool; the logical prefix is what transfers, so the two allocators stay
independently refcount-coherent.

Epoch fencing: the DECODE side owns a monotonically increasing handoff
epoch, announced in the `hello` it sends on every new connection and
bumped whenever its pool state is reset. Every handoff is stamped with
the epoch the prefill side last saw; the decode side rejects stale
stamps (`reject` with the current epoch, counted in `stale_rejected`)
instead of admitting KV computed against a dead pool generation.

Wire format (one TCP stream, strictly request/response from the prefill
side): every message is an 8-byte big-endian length + a JSON header
(`separators=(",", ":")`); a `handoff` header carries an `arrays`
manifest (name / shape / dtype) and the raw array bytes follow the
header in manifest order. No pickling. The frames are byte for byte the
JAX package's, so a JAX prefill tier can hand off to a port decode tier
and the reverse:

- dtypes travel under numpy's names (`"bfloat16"`, `"float32"`), never
  `str(torch.bfloat16)`;
- arrays are host torch tensors; their bytes leave through a `uint8`
  view and come back through `torch.frombuffer`, so bf16 crosses as raw
  bytes with neither numpy's nor `ml_dtypes`' bfloat16 in the process.
"""

import json
import math
import os
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

_LEN = struct.Struct(">Q")
# A single handoff is bounded by pool-geometry arrays (L, n_blocks, bs,
# KV, hd); 1 GiB headroom rejects garbage or hostile lengths before any
# allocation. Raise or lower it per call (`recv_msg(..., max_bytes=...)`)
# or process-wide through DSTACK_TPU_KV_MAX_FRAME_BYTES.
MAX_MSG_BYTES = 1 << 30
MAX_FRAME_ENV = "DSTACK_TPU_KV_MAX_FRAME_BYTES"

# Manifest dtype names (numpy's) <-> torch dtypes.
_DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


class FrameTooLargeError(ConnectionError):
    """A length prefix or manifest entry exceeds the frame budget. A
    ConnectionError: a corrupt or hostile length poisons the stream, which
    is dropped, never read again."""

    def __init__(self, what: str, nbytes: int, limit: int):
        super().__init__(
            f"kv_transfer {what} of {nbytes} bytes exceeds the"
            f" {limit}-byte frame limit (set {MAX_FRAME_ENV} or pass"
            f" max_bytes to raise it)"
        )
        self.nbytes = nbytes
        self.limit = limit


def max_frame_bytes(override: Optional[int] = None) -> int:
    """Effective frame budget: explicit override > env > default."""
    if override is not None:
        return int(override)
    raw = os.environ.get(MAX_FRAME_ENV)
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return MAX_MSG_BYTES


class KVHandoff(NamedTuple):
    """One finished prefill, ready for decode-side admission. `k`, `v`
    (and the drafter's `draft_k`, `draft_v` when speculating) are host
    tensors (L, n_blocks, block_size, KV, hd)."""

    request_id: int
    epoch: int
    prompt: List[int]
    first_token: int          # sampled by the prefill finalize chunk
    max_new_tokens: int
    temperature: float
    top_p: float
    k: torch.Tensor
    v: torch.Tensor
    draft_k: Optional[torch.Tensor] = None
    draft_v: Optional[torch.Tensor] = None
    # W3C trace context minted at ingress: the decode side continues the
    # same trace_id across processes.
    traceparent: Optional[str] = None

    @property
    def n_blocks(self) -> int:
        return int(self.k.shape[1])

    @property
    def payload_bytes(self) -> int:
        arrays = [self.k, self.v]
        if self.draft_k is not None:
            arrays += [self.draft_k, self.draft_v]
        return sum(a.numel() * a.element_size() for a in arrays)


class StaleEpochError(RuntimeError):
    """Handoff stamped with an epoch the decode side no longer serves."""

    def __init__(self, got: int, current: int):
        super().__init__(
            f"stale handoff epoch {got} (decode side is at {current})"
        )
        self.got = got
        self.current = current


# -- array manifests ----------------------------------------------------------


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype, as the manifest carries it."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"kv_transfer cannot ship dtype {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"kv_transfer manifest has unknown dtype {name!r}") from None


def _raw(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in row-major order, as numpy's tobytes() of the
    same array gives them (through a uint8 view: bf16 needs no numpy
    dtype)."""
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy())


def pack_arrays(
    named: List[Tuple[str, torch.Tensor]],
) -> Tuple[List[Dict[str, Any]], Tuple[bytes, ...]]:
    """Tensors -> (manifest, raw buffers) in manifest order. The inverse
    of `unpack_arrays`; `send_msg` puts the same bytes on the wire."""
    manifest = [
        {"name": name, "shape": list(a.shape), "dtype": dtype_name(a.dtype)}
        for name, a in named
    ]
    buffers = tuple(_raw(a).tobytes() for _, a in named)
    return manifest, buffers


def _from_bytes(raw, dtype: torch.dtype, shape: Tuple[int, ...]) -> torch.Tensor:
    if math.prod(shape) == 0:
        return torch.empty(shape, dtype=dtype)
    if isinstance(raw, bytes):
        raw = bytearray(raw)  # frombuffer wants a writable buffer
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def unpack_arrays(
    manifest: List[Dict[str, Any]], buffers: Tuple[Any, ...],
) -> Dict[str, torch.Tensor]:
    """(manifest, raw buffers) -> host tensors by name, views over the
    buffers where they are writable."""
    out: Dict[str, torch.Tensor] = {}
    for spec, raw in zip(manifest, buffers):
        shape = tuple(int(d) for d in spec["shape"])
        out[spec["name"]] = _from_bytes(raw, torch_dtype(spec["dtype"]), shape)
    return out


# -- framing ------------------------------------------------------------------


def _read_exact(sock: socket.socket, n: int,
                limit: Optional[int] = None) -> bytearray:
    if limit is not None and n > limit:
        raise FrameTooLargeError("read", n, limit)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        # MSG_WAITALL: one blocking call (and one release of the GIL) for
        # the whole frame where the socket allows it.
        k = sock.recv_into(view[got:], n - got, socket.MSG_WAITALL)
        if not k:
            raise ConnectionError("kv_transfer peer closed mid-message")
        got += k
    return buf


def send_msg(sock: socket.socket, header: Dict[str, Any],
             payloads: Tuple[torch.Tensor, ...] = ()) -> int:
    """Write one framed message; returns bytes put on the wire."""
    raw = json.dumps(header, separators=(",", ":")).encode()
    parts = [_LEN.pack(len(raw)), raw]
    parts += [_raw(a) for a in payloads]
    blob = b"".join(parts)
    sock.sendall(blob)
    return len(blob)


def recv_msg(sock: socket.socket, *,
             max_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Read one framed header; array payloads (if any) are attached under
    `_arrays` as host tensors in manifest order.

    Every length that could trigger an allocation — the header prefix and
    each manifest entry's byte count — is checked against the frame budget
    (`max_bytes` > DSTACK_TPU_KV_MAX_FRAME_BYTES > 1 GiB) BEFORE any read,
    raising FrameTooLargeError. Sizes are exact Python ints (math.prod),
    so a crafted shape cannot wrap around into a small 'valid' size."""
    limit = max_frame_bytes(max_bytes)
    (n,) = _LEN.unpack(_read_exact(sock, _LEN.size))
    if n > limit:
        raise FrameTooLargeError("header", n, limit)
    header = json.loads(_read_exact(sock, n).decode())
    manifest = header.get("arrays", ())
    arrays = []
    for spec in manifest:
        shape = tuple(int(d) for d in spec["shape"])
        dtype = torch_dtype(spec["dtype"])
        nbytes = math.prod(shape) * dtype.itemsize
        if nbytes > limit:
            raise FrameTooLargeError(
                f"array {spec.get('name')!r}", nbytes, limit
            )
        arrays.append(_from_bytes(_read_exact(sock, nbytes), dtype, shape))
    header["_arrays"] = arrays
    return header


def pack_handoff(h: KVHandoff) -> Tuple[Dict[str, Any], Tuple[torch.Tensor, ...]]:
    named: List[Tuple[str, torch.Tensor]] = [("k", h.k), ("v", h.v)]
    if h.draft_k is not None:
        named += [("draft_k", h.draft_k), ("draft_v", h.draft_v)]
    manifest = [
        {"name": name, "shape": list(a.shape), "dtype": dtype_name(a.dtype)}
        for name, a in named
    ]
    header = {
        "kind": "handoff",
        "request_id": h.request_id,
        "epoch": h.epoch,
        "prompt": list(h.prompt),
        "first_token": int(h.first_token),
        "max_new_tokens": int(h.max_new_tokens),
        "temperature": float(h.temperature),
        "top_p": float(h.top_p),
        "arrays": manifest,
    }
    if h.traceparent is not None:
        header["traceparent"] = h.traceparent
    return header, tuple(a for _, a in named)


def unpack_handoff(header: Dict[str, Any]) -> KVHandoff:
    by_name = {
        spec["name"]: arr
        for spec, arr in zip(header.get("arrays", ()), header["_arrays"])
    }
    return KVHandoff(
        request_id=int(header["request_id"]),
        epoch=int(header["epoch"]),
        prompt=[int(t) for t in header["prompt"]],
        first_token=int(header["first_token"]),
        max_new_tokens=int(header["max_new_tokens"]),
        temperature=float(header["temperature"]),
        top_p=float(header["top_p"]),
        k=by_name["k"],
        v=by_name["v"],
        draft_k=by_name.get("draft_k"),
        draft_v=by_name.get("draft_v"),
        traceparent=header.get("traceparent"),
    )


# -- decode side --------------------------------------------------------------


class TransferServer:
    """Decode-side listener: one thread per prefill connection, each
    handoff checked against the CURRENT epoch before `on_handoff`
    (typically `ServingEngine.submit_prefilled`) runs; the ack goes out
    only after the callback returns, so a prefill worker that sees the ack
    knows the decode side owns the request and may drop its block refs."""

    def __init__(self, host: str, port: int,
                 on_handoff: Callable[[KVHandoff], None],
                 *, epoch: int = 1):
        self._on_handoff = on_handoff
        self._epoch = epoch
        self._lock = threading.Lock()
        self._stop = False
        self.stale_rejected = 0        # monotonic, feeds /metrics
        self.handoffs_accepted = 0
        self.bytes_received = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def bump_epoch(self) -> int:
        """Invalidate every in-flight handoff (pool generation changed).
        Connected prefill workers learn the new epoch from the next
        reject; new connections from the hello."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _reject(self, conn: socket.socket, rid: int, epoch: int) -> None:
        with self._lock:
            self.stale_rejected += 1
        send_msg(conn, {"kind": "reject", "reason": "stale_epoch",
                        "request_id": rid, "epoch": epoch})

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                send_msg(conn, {"kind": "hello", "epoch": self.epoch})
                while not self._stop:
                    header = recv_msg(conn)
                    if header.get("kind") != "handoff":
                        send_msg(conn, {"kind": "error",
                                        "reason": "unexpected message"})
                        continue
                    h = unpack_handoff(header)
                    current = self.epoch
                    if h.epoch != current:
                        self._reject(conn, h.request_id, current)
                        continue
                    try:
                        self._on_handoff(h)
                    except StaleEpochError as e:
                        # Raced a bump between the check and admission.
                        self._reject(conn, h.request_id, e.current)
                        continue
                    with self._lock:
                        self.handoffs_accepted += 1
                        self.bytes_received += h.payload_bytes
                    send_msg(conn, {"kind": "ack",
                                    "request_id": h.request_id})
        except (ConnectionError, OSError, json.JSONDecodeError):
            return  # peer went away; the accept loop keeps serving

    def close(self) -> None:
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass


# -- prefill side -------------------------------------------------------------


class TransferClient:
    """Prefill-side sender. `send()` stamps the handoff with the epoch
    learned from the decode side's hello, blocks for the ack, and retries
    ONCE on a stale-epoch reject with the refreshed epoch; a second reject
    means the decode side is churning and the caller fails the request.
    Thread-safe."""

    def __init__(self, host: str, port: int, *, timeout: float = 60.0,
                 retry_stale: bool = True):
        self._addr = (host, port)
        self._timeout = timeout
        self._retry_stale = retry_stale
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.epoch = 0
        self.bytes_sent = 0            # monotonic, feeds /metrics
        self.handoffs_sent = 0
        self.stale_rejects_seen = 0

    def _connect(self) -> None:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.settimeout(self._timeout)
        hello = recv_msg(sock)
        if hello.get("kind") != "hello":
            sock.close()
            raise ConnectionError(
                f"expected hello from decode side, got {hello.get('kind')!r}"
            )
        self._sock = sock
        self.epoch = int(hello["epoch"])

    def _send_once(self, h: KVHandoff) -> Dict[str, Any]:
        if self._sock is None:
            self._connect()
        header, payloads = pack_handoff(h._replace(epoch=self.epoch))
        try:
            self.bytes_sent += send_msg(self._sock, header, payloads)
            return recv_msg(self._sock)
        except (ConnectionError, OSError):
            # One reconnect per attempt: a decode-side restart closed the
            # stream; the fresh hello carries the new epoch.
            self._close_sock()
            self._connect()
            header, payloads = pack_handoff(h._replace(epoch=self.epoch))
            self.bytes_sent += send_msg(self._sock, header, payloads)
            return recv_msg(self._sock)

    def send(self, h: KVHandoff) -> None:
        """Deliver one handoff; raises StaleEpochError after a reject on
        the refreshed epoch, ConnectionError when the decode side is
        unreachable."""
        with self._lock:
            for attempt in range(2):
                reply = self._send_once(h)
                kind = reply.get("kind")
                if kind == "ack":
                    self.handoffs_sent += 1
                    return
                if kind == "reject" and reply.get("reason") == "stale_epoch":
                    self.stale_rejects_seen += 1
                    stamped = self.epoch
                    self.epoch = int(reply["epoch"])
                    if attempt == 0 and self._retry_stale:
                        continue
                    raise StaleEpochError(stamped, self.epoch)
                raise ConnectionError(
                    f"unexpected kv_transfer reply: {reply!r}"
                )

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_sock()
