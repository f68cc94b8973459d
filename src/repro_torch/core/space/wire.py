"""Length-prefixed binary framing for the remote tuple space, with a tensor
codec (port of ``repro/core/space/wire.py``).

One *frame* carries one message (a request, a response, or an
unsolicited invalidation) and is laid out so array payloads travel as
raw bytes, never through a pickle byte-copy:

    [u32 body_len]
    [u32 n_buffers][u64 pickle_len][u64 buf_len x n_buffers]   header
    [pickle bytes (protocol 5, out-of-band buffers elided)]
    [raw buffer bytes ...]

Encoding uses pickle protocol 5 with a ``buffer_callback``: every
contiguous ndarray (or other buffer-protocol object) inside the message
is *elided* from the pickle stream and appended as its own raw segment.
:func:`send_msg` hands the segment list to ``socket.sendmsg`` as a
gather write — one syscall per frame for typical sizes. :func:`recv_msg`
reads the body into one buffer and reconstructs arrays over zero-copy
``memoryview`` slices of it (``pickle.loads(..., buffers=...)``).

**Tensors.** ``torch.Tensor`` pickles through torch's own storage
reducer, which copies the storage into the pickle stream and, for a CUDA
tensor, names the device it lived on (which a reader without that device
cannot load). The encoder's pickler therefore overrides the reduction of
every tensor (``reducer_override``): a tensor crosses as its contiguous
host bytes — one out-of-band :class:`pickle.PickleBuffer` of ``uint8`` —
plus its dtype name and shape, so bf16 (which numpy lacks) travels as raw
bytes like any other dtype, and 0-d and non-contiguous tensors as their
contiguous copy. The decoder rebuilds each tensor **on the reading end's
device** (``device`` on :func:`decode_msg` / :func:`recv_msg`): a worker
on the card reads its weights there, and the cloud's embedded server
lands a worker's gradient on the card where its Manager reads it. Both
copies are synchronous (``.cpu()`` before the bytes are framed, a
blocking host-to-device copy on decode), so a frame never carries bytes
that are still in flight.

Host bytes rather than CUDA IPC handles: the process fleet SIGKILLs
workers mid-task, and memory exported by a killed producer would vanish
under its reader (and a private store server holds no CUDA context at
all). A value in the space must outlive the process that wrote it.

The framing is transport-agnostic: anything with ``sendmsg``/
``recv_into`` works (tests drive it over ``socket.socketpair`` with
deliberately fragmented writes to exercise partial-read recovery).

Differs from the reference in the tensor codec and the ``device``
argument of :func:`decode_msg` and :func:`recv_msg`.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
from typing import Any

import torch

__all__ = ["FrameError", "IOV_MAX", "MAX_FRAME", "decode_msg",
           "encode_segments", "recv_exact", "recv_msg", "send_msg"]

_LEN = struct.Struct("<I")
_HDR = struct.Struct("<IQ")
_BUF = struct.Struct("<Q")


def _iov_max() -> int:
    """The kernel's per-``sendmsg`` iovec cap (Linux: typically 1024).
    A frame with more out-of-band buffers than this must be sent in
    several ``sendmsg`` calls — exceeding the cap fails the whole send
    with ``EMSGSIZE``, which callers would misread as a dead
    connection."""
    try:
        n = os.sysconf("SC_IOV_MAX")
    except (AttributeError, OSError, ValueError):
        n = -1
    return n if n > 0 else 1024


#: Max segments handed to one ``sendmsg`` call (see :func:`_iov_max`).
IOV_MAX = _iov_max()

#: Upper bound on one frame's body — a corrupted/foreign length prefix
#: must fail loudly instead of allocating gigabytes.
MAX_FRAME = 1 << 31


class FrameError(ConnectionError):
    """Malformed frame (bad length prefix / truncated header)."""


# ------------------------------------------------------------ tensor codec
def _tensor(raw, dtype: str, shape: tuple, device=None) -> torch.Tensor:
    """Rebuild a tensor from its host bytes on ``device`` (the decoder
    binds it; see :class:`_Unpickler`). One synchronous copy out of the
    frame buffer, so the tensor owns aligned memory of its own."""
    out = torch.empty(shape, dtype=getattr(torch, dtype),
                      device=torch.device("cpu") if device is None else device)
    if out.numel():
        view = memoryview(raw)
        if view.readonly:             # in-band bytes: frombuffer wants it writable
            view = memoryview(bytearray(view))
        out.view(-1).view(torch.uint8).copy_(
            torch.frombuffer(view, dtype=torch.uint8))
    return out


def _reduce_tensor(t: torch.Tensor):
    host = t.detach().cpu().contiguous()          # blocking device-to-host copy
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return _tensor, (pickle.PickleBuffer(raw), str(host.dtype).removeprefix("torch."),
                     tuple(host.shape))


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, *, buffers, device) -> None:
        super().__init__(file, buffers=buffers)
        self._device = device

    def find_class(self, module, name):
        if module == __name__ and name == "_tensor":
            device = self._device
            return lambda raw, dtype, shape: _tensor(raw, dtype, shape, device)
        return super().find_class(module, name)


def _dumps(msg: Any, buffer_callback=None) -> bytes:
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(msg)
    return f.getvalue()


# ---------------------------------------------------------------- framing
def encode_segments(msg: Any) -> list[Any]:
    """Encode ``msg`` into the frame's segment list (bytes/memoryviews),
    ready for a gather write. Array bodies are referenced, not copied;
    tensors are referenced as their host bytes."""
    raw: list[Any] = []

    def _grab(pb: pickle.PickleBuffer) -> None:
        raw.append(pb.raw())              # flat view, zero-copy

    try:
        pk = _dumps(msg, buffer_callback=_grab)
    except BufferError:
        # A non-contiguous buffer slipped through: fall back to in-band
        # pickling for the whole message (correct, just not zero-copy).
        raw = []
        pk = _dumps(msg)
    header = (_HDR.pack(len(raw), len(pk))
              + b"".join(_BUF.pack(len(r)) for r in raw))
    body_len = len(header) + len(pk) + sum(len(r) for r in raw)
    if body_len > MAX_FRAME:
        raise FrameError(f"frame body {body_len} exceeds MAX_FRAME")
    return [_LEN.pack(body_len), header, pk, *raw]


def decode_msg(body, device: str | torch.device = "cpu") -> Any:
    """Decode one frame body (everything after the u32 length prefix);
    tensors are rebuilt on ``device``."""
    view = memoryview(body)
    if len(view) < _HDR.size:
        raise FrameError("truncated frame header")
    n_bufs, pk_len = _HDR.unpack_from(view, 0)
    off = _HDR.size
    lens = []
    for _ in range(n_bufs):
        if off + _BUF.size > len(view):
            raise FrameError("truncated buffer-length table")
        lens.append(_BUF.unpack_from(view, off)[0])
        off += _BUF.size
    if off + pk_len + sum(lens) != len(view):
        raise FrameError("frame body length mismatch")
    pk = view[off:off + pk_len]
    off += pk_len
    bufs = []
    for ln in lens:
        bufs.append(view[off:off + ln])
        off += ln
    return _Unpickler(io.BytesIO(pk), buffers=bufs,
                      device=torch.device(device)).load()


def send_msg(sock, msg: Any, lock=None) -> None:
    """Frame and send ``msg``; gather write, partial-send safe. ``lock``
    (when given) serializes concurrent senders on one socket."""
    segs = [memoryview(s).cast("B") for s in encode_segments(msg)
            if len(s)]
    if lock is not None:
        with lock:
            _send_segments(sock, segs)
    else:
        _send_segments(sock, segs)


def _send_segments(sock, segs: list) -> None:
    while segs:
        try:
            # Never hand the kernel more than IOV_MAX iovecs — a large
            # put_many/snapshot frame can carry thousands of array
            # segments, and an over-long vector fails outright with
            # EMSGSIZE. The outer loop drains whatever remains.
            sent = sock.sendmsg(segs[:IOV_MAX])
        except AttributeError:            # transport without sendmsg
            for s in segs:
                sock.sendall(s)
            return
        while sent > 0:
            if sent >= len(segs[0]):
                sent -= len(segs[0])
                segs.pop(0)
            else:
                segs[0] = segs[0][sent:]
                sent = 0


def recv_exact(sock, n: int) -> bytearray:
    """Read exactly ``n`` bytes (looping over short reads) into one
    buffer; raises ``ConnectionError`` on EOF mid-frame."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("connection closed mid-frame")
        got += r
    return buf


def recv_msg(sock, device: str | torch.device = "cpu") -> Any:
    """Read one complete frame and decode it, tensors onto ``device``.
    Raises ``ConnectionError`` on clean EOF at a frame boundary too —
    callers treat any read failure as connection loss."""
    prefix = recv_exact(sock, _LEN.size)
    (body_len,) = _LEN.unpack(prefix)
    if body_len > MAX_FRAME:
        raise FrameError(f"frame length {body_len} exceeds MAX_FRAME")
    return decode_msg(recv_exact(sock, body_len), device)
