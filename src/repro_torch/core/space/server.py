"""The tuple-space server — hosts any :class:`SpaceBackend` stack behind
the :mod:`~repro_torch.core.space.wire` protocol on a local socket, so
handlers become *processes* (or, later, hosts) with zero program changes
(port of ``repro/core/space/server.py``).

Design:

- **One reader thread per connection** executes non-blocking ops inline
  and spawns a short-lived dispatch thread per *blocking* op
  (``read``/``get``/``take_batch``/``wait_count``), so a parked waiter
  never stalls the connection — requests pipeline, responses may
  complete out of order and are correlated by request id.
- **Blocking stays server-side**: the waiter parks in the hosted
  backend's own condvars; the client sends a server-relative timeout
  (already converted from its absolute deadline at frame-encode time)
  and simply waits for the response frame. Waits run in bounded
  ``WAITER_SLICE`` re-checks of the connection, so a client that dies
  mid-wait (SIGKILLed process-fleet worker) frees its parked waiter
  threads within one slice instead of leaking them for the run.
- **Sanitizers stack server-side**: host ``checked+sharded`` (or
  ``raced+checked+sharded``) and every remote op is checked exactly like
  a local one — each request carries the client thread's role tag and
  race context, which the dispatching server thread re-assumes.
- **Write-through invalidation**: clients subscribe to subject families
  they cache (``("w", l)``/``("wver", l)``-style immutable-version
  tuples). The server chains the backend's journal hook and enqueues an
  invalidation frame to every subscribed connection *at mutation time*
  — since each connection's outbound frames are a single FIFO queue, an
  invalidation is always delivered before any response that could have
  observed the mutation, which is what makes the client cache coherent
  for data that flows through the TS (see ``remote.py``).

- **Tensors land on the server's device**: every incoming frame is
  decoded with the server's ``device`` (:mod:`~repro_torch.core.space.wire`
  rebuilds tensors there), so the values the hosted backend holds live
  where its in-process readers expect them — the cloud's embedded server
  uses the cloud's device, and a worker's gradient lands on the card
  where the Manager reads it.

Standalone entrypoint (spawned by :class:`~repro_torch.core.space.remote.
RemoteBackend` when no ``REPRO_TS_ADDR`` is set)::

    python -m repro_torch.core.space.server --spec checked+sharded --port 0

Differs from the reference in ``device`` (``TSServer(..., device=)`` and
``--device``, default ``cpu``: a private store server holds host memory
and no CUDA context), in the module paths, and in :meth:`TSServer.close`,
which shuts its listening socket down so the port is released at once
(the reference's keeps listening until one more client connects).
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Any

import torch

from repro_torch.core.space.api import TSTimeout
from repro_torch.core.space.checked import set_role
from repro_torch.core.space.raced import _set_ctx
from repro_torch.core.space.scoped import NsSubject
from repro_torch.core.space.wire import recv_msg, send_msg
from repro_torch.device import resolve_device

__all__ = ["TSServer", "main"]

#: Ops that may park on a backend condvar — dispatched on a side thread
#: so the connection keeps pipelining.
BLOCKING_OPS = frozenset({"read", "get", "take_batch", "wait_count"})

#: Parked blocking ops wait in bounded slices of this many seconds,
#: re-checking their connection between slices — so a waiter whose
#: client died (the process fleet SIGKILLs workers mid-blocking-take)
#: unparks within one slice instead of sitting in the hosted backend's
#: condvar forever (``timeout=None`` has no natural wake-up, and
#: ``_Conn.close()`` wakes the reader/writer but cannot reach threads
#: parked inside the backend). A satisfied wait still wakes instantly —
#: the slicing only bounds how long a *dead* connection's waiter lives.
WAITER_SLICE = 0.5

#: Builtin exception types re-raised by name on the client (everything
#: else surfaces as RemoteOpError with the original repr).
_SAFE_ERRORS = ("TypeError", "ValueError", "KeyError", "RuntimeError")


def _plain_subject(key: tuple) -> Any:
    s = key[0] if key else None
    return s.subject if isinstance(s, NsSubject) else s


class _Conn:
    """One client connection: socket + FIFO outbound queue + writer."""

    def __init__(self, sock: socket.socket, server: "TSServer") -> None:
        self.sock = sock
        self.server = server
        self.subs: frozenset = frozenset()
        self.closed = False
        self._cond = threading.Condition()
        self._outq: deque = deque()
        self._writer = threading.Thread(target=self._write_loop,
                                        name="ts-conn-writer", daemon=True)
        self._reader = threading.Thread(target=self._read_loop,
                                        name="ts-conn-reader", daemon=True)

    def start(self) -> None:
        self._writer.start()
        self._reader.start()

    # ------------------------------------------------------------- outbound
    def enqueue(self, msg: Any) -> None:
        """FIFO-append one outbound frame. Called from dispatch threads
        (responses) AND from mutator threads via the journal hook
        (invalidations) — the single queue is what guarantees
        invalidation-before-dependent-response ordering."""
        with self._cond:
            if self.closed:
                return
            self._outq.append(msg)
            self._cond.notify()

    def _write_loop(self) -> None:
        while True:
            with self._cond:
                while not self._outq and not self.closed:
                    self._cond.wait()
                if self.closed and not self._outq:
                    return
                batch = list(self._outq)
                self._outq.clear()
            try:
                for msg in batch:
                    send_msg(self.sock, msg)
            except (OSError, ConnectionError):
                self.close()
                return

    # -------------------------------------------------------------- inbound
    def _read_loop(self) -> None:
        try:
            while not self.closed:
                msg = recv_msg(self.sock, self.server.device)
                self._dispatch(msg)
        except (OSError, ConnectionError):
            pass
        finally:
            self.close()

    def _dispatch(self, msg: Any) -> None:
        req_id, op, args, role_name, ctx, timeout = msg
        if op in BLOCKING_OPS:
            th = threading.Thread(
                target=self._execute,
                args=(req_id, op, args, role_name, ctx, timeout),
                name=f"ts-wait-{op}", daemon=True)
            th.start()
        else:
            self._execute(req_id, op, args, role_name, ctx, timeout)

    def _execute(self, req_id, op, args, role_name, ctx, timeout) -> None:
        # Re-assume the client thread's identity for the server-side
        # sanitizer stack (role for CheckedBackend, context for
        # RacedBackend). Dispatch threads are per-request; the reader
        # thread re-sets both on every inline op, so no restore needed.
        set_role(role_name)
        _set_ctx(ctx)
        try:
            if op in BLOCKING_OPS:
                result = self._run_blocking(op, args, timeout)
            else:
                result = self.server.run_op(self, op, args, timeout)
            self.enqueue((req_id, "ok", result))
        except TSTimeout as e:
            self.enqueue((req_id, "timeout", str(e)))
        except BaseException as e:  # noqa: BLE001 — surface, don't die
            self.enqueue((req_id, "error",
                          (type(e).__name__, f"{type(e).__name__}: {e}")))
        finally:
            set_role(None)
            _set_ctx(None)

    def _run_blocking(self, op, args, timeout):
        """Execute a blocking op as a sequence of ``WAITER_SLICE``-bounded
        waits so the parked thread notices a dead connection (see
        ``WAITER_SLICE``). Each slice that times out consumed nothing
        from the backend (the blocking ops take-or-raise atomically), so
        retrying preserves the op's semantics; the total wait honors the
        client's server-relative ``timeout`` (``None`` = forever —
        bounded only by connection lifetime)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is None:
                slice_t = WAITER_SLICE
            else:
                slice_t = min(max(deadline - time.monotonic(), 0.0),
                              WAITER_SLICE)
            try:
                return self.server.run_op(self, op, args, slice_t)
            except TSTimeout:
                if self.closed:
                    # Client is gone: abandon the wait. The response
                    # would be dropped by enqueue() anyway — raising
                    # here (vs. parking forever) is what frees the
                    # dispatch thread and its backend waiter slot.
                    raise
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise

    def close(self) -> None:
        with self._cond:
            if self.closed:
                return
            self.closed = True
            self._cond.notify_all()
        # shutdown BEFORE close: our own reader thread is blocked in
        # recv on this socket, and a bare close() from another thread
        # defers the fd release (and the FIN!) until that recv returns —
        # the peer would never learn the connection died. shutdown sends
        # the FIN now and wakes the blocked recv.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._drop_conn(self)


class TSServer:
    """Hosts a backend (instance or spec string) on ``host:port``
    (``port=0`` = ephemeral). ``start()`` returns once listening;
    ``addr`` is the bound ``(host, port)``. Tensors in incoming frames
    are rebuilt on ``device``."""

    def __init__(self, backend: Any = "sharded",
                 host: str = "127.0.0.1", port: int = 0,
                 device: str | torch.device = "cpu") -> None:
        self.device = resolve_device(device)
        if isinstance(backend, str):
            if backend.startswith("remote"):
                raise ValueError(
                    f"TSServer cannot host spec {backend!r} — a server "
                    f"hosting a remote client would recurse")
            from repro_torch.core.space.facade import make_backend
            backend = make_backend(backend)
        self.backend = backend
        self._host = host
        self._port = port
        self._sock: socket.socket | None = None
        self._conns: list[_Conn] = []
        self._lock = threading.Lock()
        self._watched: frozenset = frozenset()
        self.closed = False
        self._chain_journal()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "TSServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        self._sock = s
        self.addr = s.getsockname()
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="ts-server-accept",
                                          daemon=True)
        self._acceptor.start()
        return self

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self.closed:
            try:
                sock, _peer = self._sock.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, self)
            with self._lock:
                if self.closed:
                    sock.close()
                    return
                self._conns.append(conn)
            conn.start()

    def close(self) -> None:
        self.closed = True
        if self._sock is not None:
            # shutdown BEFORE close, as for a connection: the acceptor is
            # blocked in accept() on this socket, and a bare close() from
            # another thread leaves the socket listening (its port bound,
            # new clients still connecting) until that accept returns.
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()

    def _drop_conn(self, conn: _Conn) -> None:
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
            self._rebuild_watched_locked()

    # ------------------------------------------------------- invalidation
    def _chain_journal(self) -> None:
        prev = getattr(self.backend, "journal", None)

        def hook(op, key, _prev=prev, _notify=self._notify):
            if _prev is not None:
                _prev(op, key)
            _notify(op, key)

        # Preserve the facade's re-wrap protocol (see TupleSpace.__init__):
        # a facade wrapped around this backend later must chain from the
        # ORIGINAL hook, but our notify must keep firing — so the tag
        # points at this hook itself, not at prev.
        hook._ts_base_hook = hook  # type: ignore[attr-defined]
        self.backend.journal = hook

    def _rebuild_watched_locked(self) -> None:
        watched: set = set()
        for c in self._conns:
            watched |= c.subs
        self._watched = frozenset(watched)

    def subscribe(self, conn: _Conn, subjects) -> int:
        with self._lock:
            conn.subs = frozenset(subjects)
            self._rebuild_watched_locked()
        return len(conn.subs)

    def _notify(self, _op: str, key: tuple) -> None:
        """Journal observer: runs at mutation time (under backend locks)
        — must stay tiny. Enqueues an invalidation frame for ``key`` to
        every connection subscribed to its plain subject."""
        watched = self._watched
        if not watched:
            return
        plain = _plain_subject(key)
        if plain not in watched:
            return
        with self._lock:
            conns = [c for c in self._conns if plain in c.subs]
        for c in conns:
            c.enqueue((0, "inv", (key,)))

    # ------------------------------------------------------------ dispatch
    def run_op(self, conn: _Conn, op: str, args: tuple, timeout):
        b = self.backend
        if op == "put":
            return b.put(args[0], args[1])
        if op == "put_many":
            return b.put_many(args[0])
        if op == "delete":
            return b.delete(args[0])
        if op == "try_read":
            return b.try_read(args[0])
        if op == "try_get":
            return b.try_get(args[0])
        if op == "read":
            return b.read(args[0], timeout)
        if op == "get":
            return b.get(args[0], timeout)
        if op == "take_batch":
            return b.take_batch(args[0], args[1], timeout)
        if op == "wait_count":
            return b.wait_count(args[0], args[1], timeout)
        if op == "count":
            return b.count(args[0])
        if op == "keys":
            return b.keys(args[0])
        if op == "stats":
            return b.stats()
        if op == "snapshot":
            return b.snapshot()
        if op == "sub":
            return self.subscribe(conn, args[0])
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown remote op {op!r}")


def main(argv=None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        description="ACAN tuple-space server")
    ap.add_argument("--spec", default="sharded",
                    help="hosted backend spec, e.g. checked+sharded:8")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (announced on stdout)")
    ap.add_argument("--device", default="cpu",
                    help="where incoming tensors are stored (cpu | cuda)")
    args = ap.parse_args(argv)

    srv = TSServer(args.spec, host=args.host, port=args.port,
                   device=args.device).start()
    # The spawn handshake: the parent reads this line to learn the port.
    print(f"ADDR {srv.addr[0]}:{srv.addr[1]}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())
    stop.wait()
    srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
