"""``RemoteBackend`` — the client half of the distributed tuple space
(port of ``repro/core/space/remote.py``): speaks the full
:class:`~repro_torch.core.space.api.SpaceBackend` protocol to a :class:`~repro_torch.core.space.server.TSServer` over the
length-prefixed binary wire protocol (:mod:`~repro_torch.core.space.wire`).

Performance model:

- **Pipelining** — requests carry ids and responses are correlated, so
  many threads share one connection without head-of-line blocking on
  the server's blocking ops (each parks in its own server-side waiter).
- **Batched framing** — ``put_many`` and ``take_batch`` are each ONE
  frame / one gather-write syscall regardless of batch size, so a
  handler's pouch drain costs two wire round-trips total (asserted by
  the ``round_trips`` counter in the tests).
- **Zero-copy arrays** — ndarray payloads travel as raw buffer segments
  (pickle protocol 5 out-of-band buffers), one copy end to end; tensors
  as their host bytes, rebuilt on this client's ``device`` (see
  :mod:`~repro_torch.core.space.wire`).
- **Read-through cache** — subjects named in ``cache_subjects`` (the
  version-keyed immutable families: ``("w", l)``/``("wver", l)``-style)
  are cached on first read and served locally afterwards — hot weight
  reads stop round-tripping entirely (the cached tensors live on the
  client's device). Coherence comes from server-push
  invalidation frames that share the response FIFO: any response that
  could observe a mutation is delivered *after* that mutation's
  invalidation, so data that flows through the TS (task issued after
  weight commit → handler reads weights) is never served stale. The
  FIFO alone is not enough, though: the demux thread drains frames, but
  the *store* into the cache happens later on the requesting thread —
  a response that observed pre-commit state could be stored after the
  commit's invalidation was already drained. An **invalidation
  generation** closes that window: the demux thread bumps a counter on
  every invalidation (and on reconnect), each read records the counter
  before its request frame is sent, and the store is skipped (under the
  same lock the demux thread invalidates with) if the counter moved
  while the request was in flight.

Deadline semantics (satellite 2): blocking ops take *relative* timeouts
at the API (protocol contract), are pinned to an **absolute client
deadline** on entry, and converted to a **server-relative timeout at
frame-encode time** (:func:`server_timeout`) — so queueing/wire latency
before the encode never extends the server-side wait, and the Manager's
``barrier_quantum`` slicing cannot over-wait by accumulated round-trip
drift.

Address resolution: an explicit ``addr`` wins; else ``$REPRO_TS_ADDR``
(``host:port``); else a **private server subprocess** is spawned
(``python -m repro_torch.core.space.server --spec <server_spec>``, on the
CPU) and reaped when the backend is closed or garbage-collected.

Differs from the reference in ``device`` (where the client rebuilds the
tensors it reads; ``None`` means CUDA, as everywhere in the port), in the private server's launch (the
port's server module, with the port's source root on ``PYTHONPATH``), and
in a failed (re)connect, which raises :class:`RemoteSpaceError` like every
other connection failure (the reference lets the socket's
``ConnectionRefusedError`` through).
"""

from __future__ import annotations

import itertools
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Iterable

import torch

from repro_torch.core.space.api import (Key, Pattern, TSTimeout, is_concrete,
                                  validate_key)
from repro_torch.core.space.checked import get_role
from repro_torch.core.space.raced import _get_ctx
from repro_torch.core.space.scoped import NsSubject
from repro_torch.core.space.wire import recv_msg, send_msg
from repro_torch.device import resolve_device

__all__ = ["ADDR_ENV", "DEFAULT_CACHE_SUBJECTS", "RemoteBackend",
           "RemoteOpError", "RemoteSpaceError", "server_timeout"]

#: Environment variable naming an already-running server (``host:port``).
ADDR_ENV = "REPRO_TS_ADDR"

#: Subjects cached read-through by default when a RemoteBackend is built
#: from a spec string: the committed-weight families — written once per
#: version, read by every handler task, invalidated on commit
#: (delete + re-put both journal, both push invalidations).
DEFAULT_CACHE_SUBJECTS = ("w", "b", "wver")

#: Extra client-side wait beyond the server deadline before declaring
#: the connection dead — covers wire + scheduling latency of the
#: response frame, never extends the server-side wait itself.
RESPONSE_GRACE = 30.0

#: Builtin exceptions re-raised by name from server error responses.
_ERROR_TYPES = {"TypeError": TypeError, "ValueError": ValueError,
                "KeyError": KeyError, "RuntimeError": RuntimeError}

#: Read-through cache entry cap — the version-keyed weight families this
#: cache exists for are O(layers); blowing past this means someone is
#: caching an unbounded family, so shed everything rather than grow.
_CACHE_CAP = 1024


class RemoteSpaceError(ConnectionError):
    """The server connection failed (send/receive/handshake)."""


class RemoteOpError(RuntimeError):
    """The server raised a non-builtin exception executing an op."""


def server_timeout(deadline: float | None) -> float | None:
    """Absolute client deadline → server-relative timeout, evaluated at
    frame-encode time (the satellite-2 conversion point): whatever
    client-side latency elapsed since the blocking call started is
    already subtracted, so the server never waits past the caller's
    deadline. ``None`` = wait forever (both sides)."""
    if deadline is None:
        return None
    return max(deadline - time.monotonic(), 0.0)


def _deadline(timeout: float | None) -> float | None:
    return None if timeout is None else time.monotonic() + timeout


def _plain_subject(key: tuple) -> Any:
    s = key[0] if key else None
    return s.subject if isinstance(s, NsSubject) else s


class _Pending:
    __slots__ = ("event", "status", "payload")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.status: str | None = None
        self.payload: Any = None


def _reap(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=2.0)
    if proc.stdout is not None:
        proc.stdout.close()


class RemoteBackend:
    """SpaceBackend client over a socket (see module docstring).

    ``cache_subjects`` opts concrete-pattern reads of those (plain)
    subjects into the invalidation-coherent read-through cache. Tensors
    the client reads are rebuilt on ``device`` (``None`` means CUDA, which
    raises without a card).
    """

    def __init__(self, addr: str | tuple | None = None,
                 server_spec: str = "sharded",
                 cache_subjects: Iterable[Any] | None = None,
                 journal=None, device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.journal = journal
        self.server_spec = server_spec
        if cache_subjects is None:
            cache_subjects = DEFAULT_CACHE_SUBJECTS
        self.cache_subjects = frozenset(cache_subjects)
        #: Request frames sent that await a response — the wire-cost
        #: observable the batched-framing gate asserts on.
        self.round_trips = 0
        self.cache_hits = 0
        self.reconnects = 0
        self._cache: dict[tuple, tuple] = {}
        self._cache_enabled = False
        #: Invalidation generation (see module docstring): bumped under
        #: ``_inv_lock`` by the demux thread on every invalidation frame
        #: and on reconnect; a read that started before the bump must
        #: not store its (possibly pre-mutation) result.
        self._inv_gen = 0
        self._inv_lock = threading.Lock()
        self._sock = None
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._clock = threading.Lock()
        self._pending: dict[int, _Pending] = {}
        self._req_ids = itertools.count(1)
        self._closed = False
        self._proc: subprocess.Popen | None = None
        self._finalizer = None
        if addr is None:
            addr = os.environ.get(ADDR_ENV) or None
        if addr is None:
            self._spawn_private = True
            self._addr: tuple | None = None
        else:
            self._spawn_private = False
            if isinstance(addr, str):
                host, _, port = addr.rpartition(":")
                addr = (host or "127.0.0.1", int(port))
            self._addr = (addr[0], int(addr[1]))
        self._ensure_conn()

    # ---------------------------------------------------------- connection
    def _spawn_server(self) -> None:
        import repro_torch
        src_root = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        # -c instead of -m: the package __init__ imports .server, and
        # runpy warns when the -m target is already in sys.modules.
        launcher = ("import sys; from repro_torch.core.space.server import main; "
                    "sys.exit(main(sys.argv[1:]))")
        proc = subprocess.Popen(
            [sys.executable, "-c", launcher,
             "--spec", self.server_spec, "--port", "0"],
            stdout=subprocess.PIPE, env=env, text=True)
        line = proc.stdout.readline() if proc.stdout is not None else ""
        if not line.startswith("ADDR "):
            _reap(proc)
            raise RemoteSpaceError(
                f"private TS server failed to start (spec="
                f"{self.server_spec!r}): {line!r}")
        host, _, port = line[5:].strip().rpartition(":")
        self._addr = (host, int(port))
        self._proc = proc
        # GC / interpreter-exit safety net: never leak a server process.
        self._finalizer = weakref.finalize(self, _reap, proc)

    def _ensure_conn(self) -> None:
        if self._sock is not None or self._closed:
            return
        with self._clock:
            if self._sock is not None:
                return
            if self._spawn_private and (
                    self._proc is None or self._proc.poll() is not None):
                if self._proc is not None:   # died: replace (fresh store)
                    _reap(self._proc)
                self._spawn_server()
            try:
                s = socket.create_connection(self._addr, timeout=10.0)
            except OSError as e:
                raise RemoteSpaceError(
                    f"cannot connect to the tuple-space server at "
                    f"{self._addr}: {e}") from e
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            recv = threading.Thread(target=self._recv_loop, args=(s,),
                                    name="ts-remote-recv", daemon=True)
            with self._inv_lock:
                self._inv_gen += 1
                self._cache.clear()
            self._cache_enabled = False
            self._sock = s
            recv.start()
        if self.cache_subjects:
            plain = [s.subject if isinstance(s, NsSubject) else s
                     for s in self.cache_subjects]
            self._request("sub", (plain,))
            self._cache_enabled = True

    def _conn_broken(self, sock) -> None:
        with self._clock:
            if self._sock is sock:
                self._sock = None
                self._cache_enabled = False
                with self._inv_lock:
                    self._inv_gen += 1       # kill in-flight cache stores
                    self._cache.clear()
                self.reconnects += 1
        # shutdown first: close() alone won't wake our receiver thread
        # blocked in recv (the in-flight syscall pins the file
        # description open on Linux).
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for p in pending:
            p.status = "conn"
            p.payload = "tuple-space server connection lost"
            p.event.set()

    def _recv_loop(self, sock) -> None:
        try:
            while True:
                msg = recv_msg(sock, self.device)
                req_id = msg[0]
                if req_id == 0:
                    if msg[1] == "inv":
                        with self._inv_lock:
                            self._inv_gen += 1
                            for k in msg[2]:
                                self._cache.pop(k, None)
                    continue
                with self._plock:
                    p = self._pending.pop(req_id, None)
                if p is not None:
                    p.status, p.payload = msg[1], msg[2]
                    p.event.set()
        except (OSError, ConnectionError):
            self._conn_broken(sock)

    # ------------------------------------------------------------- request
    def _request(self, op: str, args: tuple,
                 deadline: float | None = None) -> Any:
        if self._closed:
            raise RemoteSpaceError("backend is closed")
        self._ensure_conn()
        sock = self._sock
        if sock is None:
            raise RemoteSpaceError("no tuple-space server connection")
        p = _Pending()
        req_id = next(self._req_ids)
        with self._plock:
            self._pending[req_id] = p
        # Encode-time deadline conversion (satellite 2): the server gets
        # the *remaining* budget, measured right here.
        msg = (req_id, op, args, get_role(), _get_ctx(),
               server_timeout(deadline))
        try:
            send_msg(sock, msg, lock=self._wlock)
        except (OSError, ConnectionError) as e:
            with self._plock:
                self._pending.pop(req_id, None)
            self._conn_broken(sock)
            raise RemoteSpaceError(f"send failed: {e}") from e
        self.round_trips += 1
        wait = (None if deadline is None
                else max(deadline - time.monotonic(), 0.0) + RESPONSE_GRACE)
        if not p.event.wait(wait):
            with self._plock:
                self._pending.pop(req_id, None)
            raise RemoteSpaceError(
                f"{op} response overdue (server deadline + "
                f"{RESPONSE_GRACE}s grace)")
        if p.status == "ok":
            return p.payload
        if p.status == "timeout":
            raise TSTimeout(p.payload)
        if p.status == "conn":
            raise RemoteSpaceError(p.payload)
        name, text = p.payload
        raise _ERROR_TYPES.get(name, RemoteOpError)(text)

    def _journal(self, op: str, key: Key) -> None:
        if self.journal is not None:
            self.journal(op, key)

    # ------------------------------------------------------------ caching
    def _cache_lookup(self, pattern: Pattern) -> tuple | None:
        if (self._cache_enabled and is_concrete(pattern)
                and _plain_subject(pattern) in self.cache_subjects):
            hit = self._cache.get(pattern)
            if hit is not None:
                self.cache_hits += 1
            return hit
        return None

    def _cache_store(self, pattern: Pattern, result: tuple | None,
                     gen: int) -> None:
        """Insert a read result — unless an invalidation (or reconnect)
        was processed since ``gen`` was sampled before the request was
        sent, in which case the result may predate the mutation and
        caching it would serve stale data for the whole next version
        window. Taken under ``_inv_lock`` so the insert cannot interleave
        with the demux thread's bump-and-evict."""
        if (result is not None and self._cache_enabled
                and is_concrete(pattern)
                and _plain_subject(pattern) in self.cache_subjects):
            with self._inv_lock:
                if self._inv_gen != gen:
                    return                   # invalidated while in flight
                if len(self._cache) >= _CACHE_CAP:
                    self._cache.clear()
                self._cache[result[0]] = (result[0], result[1])

    # ---------------------------------------------------------------- put
    def put(self, key: Key, value: Any) -> None:
        validate_key(key)
        self._request("put", (key, value))
        self._journal("put", key)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        batch = list(items)
        for k, _v in batch:
            validate_key(k)
        self._request("put_many", (batch,))     # ONE frame per pouch
        for k, _v in batch:
            self._journal("put", k)

    def delete(self, pattern: Pattern) -> int:
        n = self._request("delete", (pattern,))
        if n:
            self._journal("del", pattern)
        return n

    # ----------------------------------------------------------- blocking
    def read(self, pattern: Pattern,
             timeout: float | None = None) -> tuple[Key, Any]:
        hit = self._cache_lookup(pattern)
        if hit is not None:
            return hit
        gen = self._inv_gen                  # sample BEFORE the request
        result = self._request("read", (pattern,), _deadline(timeout))
        self._cache_store(pattern, result, gen)
        return result

    def get(self, pattern: Pattern,
            timeout: float | None = None) -> tuple[Key, Any]:
        result = self._request("get", (pattern,), _deadline(timeout))
        self._journal("get", result[0])
        return result

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None) -> list[tuple[Key, Any]]:
        result = self._request("take_batch", (pattern, max_n),
                               _deadline(timeout))  # ONE frame per drain
        for k, _v in result:
            self._journal("get", k)
        return result

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int:
        return self._request("wait_count", (pattern, n), _deadline(timeout))

    # ------------------------------------------------------- non-blocking
    def try_read(self, pattern: Pattern) -> tuple[Key, Any] | None:
        hit = self._cache_lookup(pattern)
        if hit is not None:
            return hit
        gen = self._inv_gen                  # sample BEFORE the request
        result = self._request("try_read", (pattern,))
        self._cache_store(pattern, result, gen)
        return result

    def try_get(self, pattern: Pattern) -> tuple[Key, Any] | None:
        result = self._request("try_get", (pattern,))
        if result is not None:
            self._journal("get", result[0])
        return result

    # ------------------------------------------------------ introspection
    def count(self, pattern: Pattern) -> int:
        return self._request("count", (pattern,))

    def keys(self, pattern: Pattern) -> list[Key]:
        return self._request("keys", (pattern,))

    def stats(self) -> dict[str, int]:
        s = dict(self._request("stats", ()))
        s["remote_round_trips"] = self.round_trips
        s["remote_cache_hits"] = self.cache_hits
        s["remote_reconnects"] = self.reconnects
        return s

    def snapshot(self) -> dict[Key, Any]:
        return self._request("snapshot", ())

    # ----------------------------------------------------------- lifecycle
    def ping(self) -> str:
        return self._request("ping", ())

    def close(self) -> None:
        self._closed = True
        sock = self._sock
        if sock is not None:
            self._conn_broken(sock)
        if self._proc is not None:
            _reap(self._proc)
            if self._finalizer is not None:
                self._finalizer.detach()
            self._proc = None
