"""The port's KV handoff seam (dstack_tpu_torch/workloads/kv_transfer.py)
against the JAX seam: frames byte for byte equal in f32 and bf16, a JAX
client handing off to a port server and a port client to a JAX server
over localhost, and the cases of tests/test_kv_transfer.py (epoch
fencing, reconnects, the frame budget) on the port's copy."""

import socket
import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import free_port
from dstack_tpu.workloads import kv_transfer as J
from dstack_tpu_torch.workloads import kv_transfer as T
from dstack_tpu_torch.workloads.kv_transfer import (
    MAX_FRAME_ENV,
    MAX_MSG_BYTES,
    FrameTooLargeError,
    KVHandoff,
    StaleEpochError,
    TransferClient,
    TransferServer,
    max_frame_bytes,
    pack_arrays,
    pack_handoff,
    recv_msg,
    send_msg,
    unpack_arrays,
    unpack_handoff,
)

TRACEPARENT = "00-" + "5a" * 16 + "-" + "1b" * 8 + "-01"


def _np(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _torch(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bf16 included) -> a torch tensor of the same bytes."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pair(dtype="float32", draft=False, traceparent=None, rid=7, blocks=3, epoch=1):
    """The same handoff as a JAX KVHandoff (numpy) and a port one (torch)."""
    shape = (2, blocks, 16, 2, 32)  # (L, n_blocks, bs, KV, hd)
    k, v = _np(shape, rid, dtype), _np(shape, rid + 100, dtype)
    dk = _np(shape, rid + 200, dtype) if draft else None
    dv = _np(shape, rid + 300, dtype) if draft else None
    meta = dict(request_id=rid, epoch=epoch, prompt=list(range(1, 40)), first_token=11,
                max_new_tokens=8, temperature=0.7, top_p=0.9, traceparent=traceparent)
    jh = J.KVHandoff(k=k, v=v, draft_k=dk, draft_v=dv, **meta)
    th = T.KVHandoff(k=_torch(k), v=_torch(v), draft_k=None if dk is None else _torch(dk),
                     draft_v=None if dv is None else _torch(dv), **meta)
    return jh, th


def _wire(mod, h) -> bytes:
    a, b = socket.socketpair()
    header, payloads = mod.pack_handoff(h)
    n = mod.send_msg(a, header, payloads)
    a.close()
    chunks = []
    while True:
        c = b.recv(1 << 20)
        if not c:
            break
        chunks.append(c)
    b.close()
    blob = b"".join(chunks)
    assert len(blob) == n
    return blob


def _assert_same(th: KVHandoff, got: KVHandoff) -> None:
    assert (got.request_id, got.prompt, got.first_token, got.max_new_tokens,
            got.temperature, got.top_p, got.traceparent) == (
        th.request_id, th.prompt, th.first_token, th.max_new_tokens,
        th.temperature, th.top_p, th.traceparent)
    for name in ("k", "v", "draft_k", "draft_v"):
        a, b = getattr(th, name), getattr(got, name)
        if a is None:
            assert b is None
        else:
            assert b.dtype == a.dtype and torch.equal(b, a), name


# -- byte for byte against the JAX seam ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("draft,traceparent", [(False, None), (True, TRACEPARENT)])
def test_frames_are_byte_identical_to_the_jax_seam(dtype, draft, traceparent):
    jh, th = _pair(dtype, draft, traceparent)
    blob = _wire(T, th)
    assert blob == _wire(J, jh)
    (n,) = struct.unpack(">Q", blob[:8])
    assert b'"dtype":"%s"' % dtype.encode() in blob[8:8 + n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_reads_jax_frames_and_jax_reads_port_frames(dtype):
    jh, th = _pair(dtype, draft=True, traceparent=TRACEPARENT)
    a, b = socket.socketpair()
    threading.Thread(target=lambda: a.sendall(_wire(J, jh))).start()
    _assert_same(th, unpack_handoff(recv_msg(b)))
    threading.Thread(target=lambda: a.sendall(_wire(T, th))).start()
    back = J.unpack_handoff(J.recv_msg(b))
    a.close(), b.close()
    assert back.k.dtype == jh.k.dtype
    for name in ("k", "v", "draft_k", "draft_v"):
        np.testing.assert_array_equal(getattr(back, name), getattr(jh, name))


def test_pack_arrays_matches_the_jax_manifest_and_buffers():
    named_np = [
        ("f32", np.arange(12, dtype=np.float32).reshape(3, 4)),
        ("bf16", np.linspace(-2, 2, 8).astype(ml_dtypes.bfloat16).reshape(2, 4)),
        ("i32", np.array([[1, -2], [3, -4]], dtype=np.int32)),
        ("i64", np.array([1 << 40, -3], dtype=np.int64)),
        ("u8", np.array([0, 255], dtype=np.uint8)),
        ("flag", np.array([True, False, True])),
        ("scalar", np.float32(3.5).reshape(())),
        ("empty", np.zeros((4, 0), dtype=np.float32)),
    ]
    named_t = [(n, _torch(a)) for n, a in named_np]
    manifest, buffers = pack_arrays(named_t)
    assert (manifest, buffers) == J.pack_arrays(named_np)
    got = unpack_arrays(manifest, buffers)
    assert list(got) == [n for n, _ in named_np]
    for name, t in named_t:
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert torch.equal(got[name], t), name


# -- across the packages over localhost ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_client_hands_off_to_a_port_server(dtype):
    received = []
    server = TransferServer("127.0.0.1", free_port(), received.append)
    client = J.TransferClient("127.0.0.1", server.port)
    try:
        jh, th = _pair(dtype, draft=True, traceparent=TRACEPARENT)
        client.send(jh)  # returns after the port server's ack
        assert len(received) == 1
        _assert_same(th, received[0])
        assert server.handoffs_accepted == 1
        assert server.bytes_received == th.payload_bytes == jh.payload_bytes
        assert client.epoch == 1
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_client_hands_off_to_a_jax_server(dtype):
    received = []
    server = J.TransferServer("127.0.0.1", free_port(), received.append)
    client = TransferClient("127.0.0.1", server.port)
    try:
        jh, th = _pair(dtype, draft=True, traceparent=TRACEPARENT)
        client.send(th)
        assert len(received) == 1
        got = received[0]
        assert got.traceparent == TRACEPARENT and got.prompt == jh.prompt
        for name in ("k", "v", "draft_k", "draft_v"):
            assert getattr(got, name).dtype == getattr(jh, name).dtype
            assert getattr(got, name).tobytes() == getattr(jh, name).tobytes(), name
        assert client.bytes_sent == server.bytes_received + len(_wire(T, th)) - th.payload_bytes
    finally:
        client.close()
        server.close()


# -- the cases of tests/test_kv_transfer.py ---------------------------------------


@pytest.mark.parametrize("dtype,draft", [("float32", True), ("bfloat16", False)])
def test_framing_roundtrip_over_socketpair(dtype, draft):
    a, b = socket.socketpair()
    _, h = _pair(dtype, draft)
    header, payloads = pack_handoff(h)
    t = threading.Thread(target=send_msg, args=(a, header, payloads))
    t.start()
    got = unpack_handoff(recv_msg(b))
    t.join()
    a.close(), b.close()
    _assert_same(h, got)
    assert got.payload_bytes == h.payload_bytes
    assert got.n_blocks == 3


def test_loopback_delivery_and_counters():
    received = []
    server = TransferServer("127.0.0.1", free_port(), received.append)
    client = TransferClient("127.0.0.1", server.port)
    try:
        _, h = _pair()
        client.send(h)  # blocking: returns only after the ack
        assert len(received) == 1
        assert torch.equal(received[0].k, h.k)
        assert client.handoffs_sent == 1
        assert server.handoffs_accepted == 1
        assert server.bytes_received >= h.payload_bytes
        assert client.bytes_sent >= h.payload_bytes
        assert client.epoch == 1  # learned from the hello
    finally:
        client.close()
        server.close()


def test_stale_epoch_reject_then_refresh_retry():
    """A bump between stamp and delivery rejects once; the client learns
    the new epoch from the reject and its single retry lands."""
    received = []
    server = TransferServer("127.0.0.1", free_port(), received.append, epoch=1)
    client = TransferClient("127.0.0.1", server.port)
    try:
        client.send(_pair(rid=1)[1])  # learns epoch 1
        server.bump_epoch()
        client.send(_pair(rid=2)[1])  # stale stamp -> retried
        assert [h.request_id for h in received] == [1, 2]
        assert received[1].epoch == 2          # restamped on retry
        assert server.stale_rejected == 1
        assert client.stale_rejects_seen == 1
        assert client.epoch == 2
    finally:
        client.close()
        server.close()


def test_a_second_stale_reject_raises_after_the_one_retry():
    """Reject, one retry, reject again: StaleEpochError (the decode side
    is churning), with nothing admitted."""
    calls = []
    srv = {}

    def churn(h):
        calls.append(h.epoch)
        srv["s"].bump_epoch()
        raise StaleEpochError(h.epoch, srv["s"].epoch)

    server = TransferServer("127.0.0.1", free_port(), churn, epoch=1)
    srv["s"] = server
    client = TransferClient("127.0.0.1", server.port)
    try:
        with pytest.raises(StaleEpochError) as e:
            client.send(_pair()[1])
        assert calls == [1, 2]  # the first stamp and the retry's
        assert (e.value.got, e.value.current) == (2, 3)
        assert client.stale_rejects_seen == 2 and server.stale_rejected == 2
        assert server.handoffs_accepted == 0
    finally:
        client.close()
        server.close()


def test_stale_epoch_raises_without_retry():
    server = TransferServer("127.0.0.1", free_port(), lambda h: None, epoch=1)
    client = TransferClient("127.0.0.1", server.port, retry_stale=False)
    try:
        client._connect()  # hello: learns epoch 1
        server.bump_epoch()
        with pytest.raises(StaleEpochError) as e:
            client.send(_pair()[1])
        assert e.value.got == 1 and e.value.current == 2
        assert server.handoffs_accepted == 0
        assert server.stale_rejected == 1
    finally:
        client.close()
        server.close()


def test_callback_stale_raise_is_rejected_not_crashed():
    calls = []
    srv = {}

    def cb(h):
        calls.append(h.request_id)
        if len(calls) == 1:
            srv["s"].bump_epoch()
            raise StaleEpochError(h.epoch, srv["s"].epoch)

    server = TransferServer("127.0.0.1", free_port(), cb, epoch=1)
    srv["s"] = server
    client = TransferClient("127.0.0.1", server.port, retry_stale=False)
    try:
        with pytest.raises(StaleEpochError):
            client.send(_pair(rid=1)[1])
        assert server.stale_rejected == 1
        assert client.epoch == 2       # the reject carried the new epoch
        client.send(_pair(rid=2)[1])   # the same connection still serves
        assert calls == [1, 2]
        assert server.handoffs_accepted == 1
    finally:
        client.close()
        server.close()


def test_client_reconnects_after_server_side_drop():
    received = []
    server = TransferServer("127.0.0.1", free_port(),
                            lambda h: received.append(h.request_id))
    client = TransferClient("127.0.0.1", server.port)
    try:
        client.send(_pair(rid=1)[1])
        client._sock.close()
        time.sleep(0.05)
        client.send(_pair(rid=2)[1])
        assert received == [1, 2]
    finally:
        client.close()
        server.close()


def test_garbage_header_rejected_before_any_allocation():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    try:
        cli.sendall(b"\x48\x65\x6c\x6c\x6f\x21\x21\x21")  # ~5.2 EB as a length
        with pytest.raises(FrameTooLargeError) as e:
            recv_msg(conn)
        (expect,) = struct.unpack(">Q", b"\x48\x65\x6c\x6c\x6f\x21\x21\x21")
        assert e.value.nbytes == expect
        assert e.value.limit == MAX_MSG_BYTES
    finally:
        cli.close(), conn.close(), srv.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oversized_manifest_entry_rejected_before_read(dtype, monkeypatch):
    """A plausible header declaring an absurd array: the per-entry check
    fires before any payload byte is read or any buffer allocated."""
    allocs = []
    real = T._read_exact
    monkeypatch.setattr(T, "_read_exact",
                        lambda s, n, limit=None: allocs.append(n) or real(s, n, limit))
    a, b = socket.socketpair()
    header = {"arrays": [{"name": "w", "shape": [1 << 20, 1 << 20], "dtype": dtype}]}
    t = threading.Thread(target=send_msg, args=(a, header))
    t.start()
    try:
        with pytest.raises(FrameTooLargeError, match="'w'"):
            recv_msg(b)
        assert allocs[0] == 8 and len(allocs) == 2  # the prefix and the header
    finally:
        t.join()
        a.close(), b.close()


def test_explicit_limit_param_rejects_small_frames():
    a, b = socket.socketpair()
    header, payloads = pack_handoff(_pair()[1])
    t = threading.Thread(target=send_msg, args=(a, header, payloads))
    t.start()
    try:
        with pytest.raises(FrameTooLargeError):
            recv_msg(b, max_bytes=1024)
    finally:
        t.join()
        a.close(), b.close()


def test_env_knob_and_precedence(monkeypatch):
    assert max_frame_bytes() == MAX_MSG_BYTES
    monkeypatch.setenv(MAX_FRAME_ENV, "4096")
    assert max_frame_bytes() == 4096
    assert max_frame_bytes(override=128) == 128  # the parameter beats the env
    a, b = socket.socketpair()
    header, payloads = pack_handoff(_pair()[1])
    t = threading.Thread(target=send_msg, args=(a, header, payloads))
    t.start()
    try:
        with pytest.raises(FrameTooLargeError) as e:
            recv_msg(b)  # the env's 4096 bytes, below one k array
        assert e.value.limit == 4096
    finally:
        t.join()
        a.close(), b.close()
    monkeypatch.setenv(MAX_FRAME_ENV, "not-a-number")
    assert max_frame_bytes() == MAX_MSG_BYTES  # garbage env ignored


def test_within_limit_frames_still_flow():
    a, b = socket.socketpair()
    _, h = _pair()
    header, payloads = pack_handoff(h)
    t = threading.Thread(target=send_msg, args=(a, header, payloads))
    t.start()
    got = unpack_handoff(recv_msg(b, max_bytes=64 << 20))
    t.join()
    a.close(), b.close()
    assert torch.equal(got.k, h.k)


def test_an_unknown_dtype_is_refused_both_ways():
    with pytest.raises(TypeError):
        pack_arrays([("c", torch.zeros(2, dtype=torch.complex64))])
    with pytest.raises(TypeError):
        unpack_arrays([{"name": "x", "shape": [1], "dtype": "float8"}], (b"\x00",))
