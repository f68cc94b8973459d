"""The port's wire protocol (``repro_torch.core.space.wire``): twins of the
reference's ``tests/test_wire.py`` — framing round-trips (zero-copy
ndarrays, empty batches, unicode, scoped keys, predicates), partial-read
recovery over deliberately fragmented writes, and the malformed-frame
guards — then the tensor codec: float32, bf16, int64, bool, 0-d,
non-contiguous and empty tensors, nested in dicts and tuples, each body one
out-of-band segment of host bytes, rebuilt on the device the reader names.
Frames without tensors are the reference's, byte for byte, and each
package decodes the other's."""

import pickle
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from repro.core.space import wire as ref_wire
from repro_torch.core.space import ANY, FieldIn, FieldLE, NsSubject, NsSubjectPred
from repro_torch.core.space.api import match
from repro_torch.core.space.scoped import scope_pattern, task_take_pattern
from repro_torch.core.space.wire import (IOV_MAX, FrameError, MAX_FRAME,
                                         decode_msg, encode_segments, recv_msg,
                                         send_msg)


def roundtrip(msg, device="cpu"):
    segs = encode_segments(msg)
    body = b"".join(bytes(s) for s in segs[1:])
    return decode_msg(body, device)


# ------------------------------------------------------------ round-trips
def test_roundtrip_plain():
    msg = (1, "put", (("w", 0), [1, 2, 3]), "handler", None, 0.5)
    assert roundtrip(msg) == msg


def test_roundtrip_large_ndarray_zero_copy():
    a = np.arange(1 << 16, dtype=np.float32).reshape(256, 256)
    segs = encode_segments((7, "ok", a))
    # Zero-copy framing: the array body travels as its own raw segment,
    # NOT inside the pickle bytes — the pickle segment stays tiny.
    assert len(segs) == 4          # prefix, header, pickle, one raw buffer
    assert len(segs[2]) < 1024     # pickle without the array body
    assert len(segs[3]) == a.nbytes
    _rid, _st, out = roundtrip((7, "ok", a))
    np.testing.assert_array_equal(out, a)
    assert out.dtype == a.dtype and out.shape == a.shape


def test_roundtrip_many_arrays():
    arrays = [np.random.default_rng(i).normal(size=(17, 3)) for i in range(9)]
    out = roundtrip(("batch", arrays))
    for got, want in zip(out[1], arrays):
        np.testing.assert_array_equal(got, want)


def test_roundtrip_empty_batch_and_unicode():
    assert roundtrip((2, "ok", [])) == (2, "ok", [])
    msg = (3, "put", (("tâche-θ", 0, "数据"), {"λ": "ü"}), None, None, None)
    assert roundtrip(msg) == msg


def test_roundtrip_noncontiguous_array_falls_back():
    a = np.arange(64, dtype=np.float64).reshape(8, 8)[:, ::2]   # strided
    assert not a.flags["C_CONTIGUOUS"]
    _rid, out = roundtrip((1, a))
    np.testing.assert_array_equal(out, a)


def test_roundtrip_scoped_keys_and_predicates():
    key = (NsSubject("tenant0", "w"), 3)
    out = roundtrip(("put", (key, 1.0)))
    assert out[1][0] == key
    assert isinstance(out[1][0][0], NsSubject)
    assert out[1][0][0].namespace == "tenant0"
    # ANY must come back as THE singleton — match() is identity-based.
    out = roundtrip(("read", (("w", ANY),)))
    assert out[1][0][1] is ANY
    # Predicate patterns (the scoped/task-take forms) survive pickling
    # and still match.
    pat = roundtrip(scope_pattern("t1", (ANY, ANY)))
    assert isinstance(pat[0], NsSubjectPred)
    assert pat[0](NsSubject("t1", "w")) and not pat[0](NsSubject("t2", "w"))
    takepat = roundtrip(task_take_pattern(["t1", "t2"]))
    assert takepat[0](NsSubject("t1", "task"))
    assert not takepat[0](NsSubject("t3", "task"))
    assert not takepat[0]("task")     # DEFAULT_NAMESPACE not in the set


def test_field_predicates_cross_the_wire():
    fi, fle = roundtrip((FieldIn([3, 7]), FieldLE(5)))
    assert isinstance(fi, FieldIn) and isinstance(fle, FieldLE)
    assert fi(3) and fi(7) and not fi(4)
    assert fle(5) and fle(-1) and not fle(6)
    assert not fle("not-comparable")  # TypeError → no match, like lambdas
    assert match(("losshist", fle), ("losshist", 2))
    assert not match(("task", fi), ("task", 9))


# -------------------------------------------------------- socket transport
def _socketpair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def test_send_recv_over_socketpair():
    a, b = _socketpair()
    try:
        msgs = [(1, "x" * 10), (2, np.ones(1000)), (3, [None, ANY])]
        for m in msgs:
            send_msg(a, m)
        for m in msgs:
            got = recv_msg(b)
            if isinstance(m[1], np.ndarray):
                np.testing.assert_array_equal(got[1], m[1])
            else:
                assert got == m or (got[0] == m[0] and got[1][1] is ANY)
    finally:
        a.close()
        b.close()


def test_partial_read_recovery():
    """A frame dribbled in 7-byte fragments decodes identically —
    recv_msg must loop over short reads, never assume one recv = one
    frame. The twin also dribbles a tensor."""
    a, b = _socketpair()
    try:
        payload = (42, "ok", np.arange(257, dtype=np.int64), torch.arange(33.0))
        wire = b"".join(bytes(s) for s in encode_segments(payload))
        done = threading.Event()

        def dribble():
            for i in range(0, len(wire), 7):
                a.sendall(wire[i:i + 7])
            done.set()

        t = threading.Thread(target=dribble, daemon=True)
        t.start()
        got = recv_msg(b)
        assert got[0] == 42
        np.testing.assert_array_equal(got[2], payload[2])
        assert torch.equal(got[3], payload[3])
        assert done.wait(5.0)
    finally:
        a.close()
        b.close()


def test_two_frames_in_one_stream():
    a, b = _socketpair()
    try:
        blob = b"".join(bytes(s) for s in encode_segments((1, "a")))
        blob += b"".join(bytes(s) for s in encode_segments((2, "b")))
        a.sendall(blob)
        assert recv_msg(b) == (1, "a")
        assert recv_msg(b) == (2, "b")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_frame_with_more_buffers_than_iov_max_sends(kind):
    """A pouch-sized put_many/snapshot frame can carry thousands of
    out-of-band segments — more iovecs than one ``sendmsg`` accepts. The
    sender must chunk the gather write instead of failing the whole frame
    with EMSGSIZE. The twin runs it with ndarrays (the reference's case)
    and with tensors, each of which is one segment too."""
    n = IOV_MAX + 200
    make = (lambda i: np.full(2, i, dtype=np.int32)) if kind == "ndarray" else \
        (lambda i: torch.full((2,), i, dtype=torch.int32))
    arrays = [make(i) for i in range(n)]
    msg = (9, "put_many", arrays)
    assert len(encode_segments(msg)) > IOV_MAX
    a, b = _socketpair()
    try:
        got = {}

        def reader():
            got["msg"] = recv_msg(b)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        send_msg(a, msg)
        t.join(10.0)
        assert not t.is_alive()
        rid, op, out = got["msg"]
        assert (rid, op) == (9, "put_many") and len(out) == n
        np.testing.assert_array_equal(np.asarray(out[-1]), np.asarray(arrays[-1]))
    finally:
        a.close()
        b.close()


def test_eof_mid_frame_raises_connection_error():
    a, b = _socketpair()
    wire = b"".join(bytes(s) for s in encode_segments((1, "x" * 100)))
    a.sendall(wire[: len(wire) // 2])
    a.close()
    with pytest.raises(ConnectionError):
        recv_msg(b)
    b.close()


# ------------------------------------------------------------- guard rails
def test_oversize_length_prefix_rejected():
    a, b = _socketpair()
    try:
        a.sendall(struct.pack("<I", MAX_FRAME + 1) + b"junk")
        with pytest.raises(FrameError):
            recv_msg(b)
    finally:
        a.close()
        b.close()


def test_truncated_header_rejected():
    with pytest.raises(FrameError):
        decode_msg(b"\x01")


def test_length_mismatch_rejected():
    segs = encode_segments((1, "hello"))
    body = b"".join(bytes(s) for s in segs[1:])
    with pytest.raises(FrameError):
        decode_msg(body + b"trailing-garbage")


def test_concurrent_senders_interleave_whole_frames():
    """The send lock must serialize *frames*, not bytes: two threads
    hammering one socket may interleave frames in any order but never
    corrupt one."""
    a, b = _socketpair()
    lock = threading.Lock()
    n_each = 50
    try:
        def sender(tag):
            for i in range(n_each):
                send_msg(a, (tag, i, np.full(64, i)), lock=lock)

        ts = [threading.Thread(target=sender, args=(tag,), daemon=True)
              for tag in ("t1", "t2")]
        for t in ts:
            t.start()
        seen = {"t1": 0, "t2": 0}
        for _ in range(2 * n_each):
            tag, i, arr = recv_msg(b)
            assert arr[0] == i          # frame internally consistent
            seen[tag] += 1
        assert seen == {"t1": n_each, "t2": n_each}
        for t in ts:
            t.join(5.0)
    finally:
        a.close()
        b.close()


def test_any_pickles_to_singleton():
    assert pickle.loads(pickle.dumps(ANY)) is ANY


# ------------------------------------------------------------ tensor codec
def _tensor(kind: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(5)
    base = torch.randn(6, 10, generator=g)
    return {"float32": base, "bfloat16": base.to(torch.bfloat16),
            "int64": (base * 100).to(torch.int64), "bool": base > 0,
            "0-d": base[2, 3], "non-contiguous": base[:, ::3].t(),
            "empty": base[:0]}[kind]


KINDS = ["float32", "bfloat16", "int64", "bool", "0-d", "non-contiguous", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_a_tensor_crosses_as_one_segment_of_its_host_bytes(kind):
    t = _tensor(kind)
    segs = encode_segments((5, "ok", t))
    assert len(segs) == 4 and len(segs[3]) == t.numel() * t.element_size()
    assert len(segs[2]) < 256                     # no storage in the pickle
    got = roundtrip((5, "ok", t))[2]
    assert type(got) is torch.Tensor and got.dtype == t.dtype
    assert got.shape == t.shape and got.is_contiguous()
    assert torch.equal(got, t)
    assert not got.requires_grad


def test_tensors_nested_in_dicts_and_tuples():
    route = {"experts": _tensor("int64"), "gates": _tensor("float32")}
    msg = (3, "put_many", [(("route", 0, 0, 8), route), (("w", 1), (_tensor("bfloat16"), 7))])
    got = roundtrip(msg)
    (k0, v0), (k1, v1) = got[2]
    assert k0 == ("route", 0, 0, 8) and set(v0) == {"experts", "gates"}
    assert all(torch.equal(v0[f], route[f]) for f in route)
    assert torch.equal(v1[0], msg[2][1][1][0]) and v1[1] == 7


def test_a_tensor_is_rebuilt_on_the_device_the_reader_names(monkeypatch):
    """``decode_msg(body, device)`` builds every tensor there; here the
    device is the CPU named three ways, and a tensor that requires grad
    crosses as its data."""
    t = _tensor("float32").requires_grad_()
    body = b"".join(bytes(s) for s in encode_segments({"v": t})[1:])
    for dev in ("cpu", torch.device("cpu"), "cpu:0"):
        got = decode_msg(body, dev)["v"]
        assert got.device == torch.device("cpu") and torch.equal(got, t.detach())
    # The decoder's rebuild gets the reader's device, not the writer's.
    seen = []
    real = torch.empty

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **{**kw, "device": "cpu"})

    monkeypatch.setattr(torch, "empty", spy)
    decode_msg(body, "meta")
    assert seen == [torch.device("meta")]


def test_a_rebuilt_tensor_owns_its_memory():
    """The decoded tensor does not alias the receive buffer: writing the
    buffer afterwards leaves the value alone."""
    t = _tensor("float32")
    body = bytearray(b"".join(bytes(s) for s in encode_segments(t)[1:]))
    got = decode_msg(body)
    body[-t.numel() * 4:] = bytes(t.numel() * 4)
    assert torch.equal(got, t)


@pytest.mark.parametrize("msg", [
    (1, "put", (("w", 0), np.arange(12.0).reshape(3, 4)), "manager", None, 0.5),
    (2, "ok", [(("task", "e1t3"), {"n": 3}), (("x", 1), np.ones(7, np.float32))]),
    (0, "inv", (("wver", 2),)),
])
def test_frames_without_tensors_are_the_references_byte_for_byte(msg):
    ours = b"".join(bytes(s) for s in encode_segments(msg))
    theirs = b"".join(bytes(s) for s in ref_wire.encode_segments(msg))
    assert ours == theirs
    body = ours[4:]
    for got in (decode_msg(body), ref_wire.decode_msg(body)):
        assert repr(got) == repr(msg)
