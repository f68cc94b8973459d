"""The port's RemoteBackend ⇄ TSServer: twins of the reference's
``tests/test_remote.py`` — the full SpaceBackend protocol over the wire,
blocking ops with server-side waiters, deadline conversion, pipelined
concurrent waiters across connections, the batched-framing round-trip
budget, the invalidation-coherent read-through cache, server
restart/reconnect surfaces, role/context transmission for server-side
sanitizers, and the facade's numpy key canonicalization — then what the
port adds: tensors stored on the server's device and read back on the
client's, and the two repairs of the reference (a closed server releases
its port at once; a failed reconnect raises ``RemoteSpaceError``).

``test_server_restart_errors_then_reconnects`` is pinned: where the
reference sleeps 0.1 s and then expects the next read to fail, the twin
waits until the client has seen its connection drop. The reference's
outcome depended on that race: when the read went out on the dead
connection before the client noticed, no reconnect woke the closed
server's acceptor, the port stayed bound, and the restart failed to bind
for its whole 5 s.

Every client here is asked for ``device="cpu"``, which the reference's
have no argument for: the port's clients rebuild what they read on CUDA
unless told otherwise."""

import socket
import threading
import time

import numpy as np
import pytest

import torch

from repro_torch.core.space import (ANY, RemoteBackend, RemoteSpaceError, TSServer,
                                    TSTimeout, TupleSpace, canonicalize_key,
                                    make_backend, role)
from repro_torch.core.space.remote import server_timeout
from repro_torch.core.space.server import WAITER_SLICE


@pytest.fixture
def server():
    srv = TSServer("sharded:4").start()
    yield srv
    srv.close()


@pytest.fixture
def rb(server):
    backend = RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
    yield backend
    backend.close()


# ------------------------------------------------------------- basic ops
def test_full_protocol_surface(rb):
    rb.put(("w", 0), np.arange(4.0))
    rb.put_many([(("task", i), f"t{i}") for i in range(5)])
    k, v = rb.read(("w", 0))
    assert k == ("w", 0) and v[2] == 2.0
    assert rb.try_read(("nope", 0)) is None
    assert rb.count(("task", ANY)) == 5
    assert sorted(rb.keys(("task", ANY))) == [("task", i) for i in range(5)]
    k, v = rb.get(("task", 0))
    assert v == "t0"
    assert rb.try_get(("task", 1))[1] == "t1"
    assert rb.delete(("task", 2)) == 1
    batch = rb.take_batch(("task", ANY), 10, timeout=1.0)
    assert sorted(v for _, v in batch) == ["t3", "t4"]
    assert rb.wait_count(("w", ANY), 1, timeout=1.0) >= 1
    snap = rb.snapshot()
    assert ("w", 0) in snap
    assert rb.stats()["puts"] >= 6


def test_fifo_take_order_preserved(rb):
    for i in range(8):
        rb.put(("task", i), i)
    got = [v for _, v in rb.take_batch(("task", ANY), 8, timeout=1.0)]
    assert got == list(range(8))      # global_seq FIFO survives the wire


def test_blocking_read_woken_by_later_put(rb, server):
    out = []
    th = threading.Thread(
        target=lambda: out.append(rb.read(("late", 0), timeout=5.0)))
    th.start()
    time.sleep(0.1)
    other = RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
    other.put(("late", 0), "v")
    th.join(3.0)
    other.close()
    assert out and out[0][1] == "v"


def test_concurrent_blocking_waiters_across_connections(server):
    """N waiters parked across two connections each get exactly one of N
    tuples — server-side waiter parking must not wedge the connection's
    pipeline (each blocking op runs on its own dispatch thread)."""
    clients = [RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
               for _ in range(2)]
    results = []
    lock = threading.Lock()

    def waiter(c):
        got = c.get(("job", ANY), timeout=5.0)
        with lock:
            results.append(got)

    threads = [threading.Thread(target=waiter, args=(clients[i % 2],))
               for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    feeder = RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
    feeder.put_many([(("job", i), i) for i in range(6)])
    for t in threads:
        t.join(5.0)
    for c in clients + [feeder]:
        c.close()
    assert sorted(v for _, v in results) == list(range(6))


# ------------------------------------------------- deadlines (satellite 2)
def test_server_timeout_conversion_unit():
    assert server_timeout(None) is None
    now = time.monotonic()
    remaining = server_timeout(now + 2.0)
    assert 1.9 < remaining <= 2.0
    # A deadline already in the past must clamp to zero, not go negative
    # (a negative server timeout would mean "wait forever" in some APIs —
    # exactly the over-wait the conversion exists to prevent).
    assert server_timeout(now - 5.0) == 0.0


def test_timeout_is_relative_to_call_entry(rb):
    t0 = time.monotonic()
    with pytest.raises(TSTimeout):
        rb.get(("never", 0), timeout=0.3)
    elapsed = time.monotonic() - t0
    assert 0.25 < elapsed < 2.0     # honored server-side, no over-wait


def test_wait_count_timeout(rb):
    rb.put(("d", 0), 1)
    with pytest.raises(TSTimeout):
        rb.wait_count(("d", ANY), 3, timeout=0.2)
    assert rb.wait_count(("d", ANY), 1, timeout=0.2) == 1


# --------------------------------------------- batched framing (tentpole)
def test_pouch_drain_two_round_trips(rb):
    """The acceptance gate: one put_many + one take_batch = exactly two
    request frames, regardless of batch size."""
    rb.put_many([(("task", i), np.full(128, i)) for i in range(64)])
    before = rb.round_trips
    rb.put_many([(("r", i), np.full(64, i)) for i in range(64)])
    out = rb.take_batch(("task", ANY), 64, timeout=1.0)
    assert len(out) == 64
    assert rb.round_trips - before == 2


def test_error_propagation(rb):
    with pytest.raises(TypeError):
        rb.put("not-a-tuple", 1)    # client-side validate_key, no wire trip
    # A server-side error comes back typed by name over the wire and the
    # connection survives it.
    with pytest.raises(ValueError):
        rb._request("frobnicate", ())
    rb.ping()


# ------------------------------------------------------ read-through cache
def test_cache_hit_skips_round_trip(server):
    rb = RemoteBackend(addr=server.addr, cache_subjects={"w"}, device="cpu")
    try:
        rb.put(("w", 1), np.arange(3.0))
        rb.read(("w", 1))
        before = rb.round_trips
        for _ in range(5):
            k, v = rb.read(("w", 1))
        assert rb.round_trips == before       # all served locally
        assert rb.cache_hits >= 5
        assert v[1] == 1.0
    finally:
        rb.close()


def test_cache_invalidated_by_version_bump(server):
    """Write-through invalidation: a mutation by ANOTHER client must
    evict this client's cached entry (the ``("w", l)``/``("wver", l)``
    commit cycle)."""
    reader = RemoteBackend(addr=server.addr, cache_subjects={"w", "wver"}, device="cpu")
    writer = RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
    try:
        writer.put(("w", 0), np.zeros(4))
        writer.put(("wver", 0), 0)
        assert reader.read(("w", 0))[1][0] == 0.0
        assert reader.read(("wver", 0))[1] == 0
        # commit: delete + re-put (both journal, both must invalidate)
        writer.delete(("w", 0))
        writer.put(("w", 0), np.ones(4))
        writer.put(("wver", 0), 1)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if (reader.read(("wver", 0))[1] == 1
                    and reader.read(("w", 0))[1][0] == 1.0):
                break
            time.sleep(0.01)
        assert reader.read(("wver", 0))[1] == 1
        assert reader.read(("w", 0))[1][0] == 1.0
    finally:
        reader.close()
        writer.close()


def test_cache_store_skipped_when_invalidated_in_flight(server):
    """The stale-store race: a read response that observed pre-commit
    state must NOT enter the cache when the commit's invalidation was
    drained while the request was in flight — the demux thread bumps the
    generation on every invalidation, and a store whose pre-send sample
    no longer matches is dropped."""
    rb = RemoteBackend(addr=server.addr, cache_subjects={"w"}, device="cpu")
    try:
        rb.put(("w", 5), 1.0)
        gen = rb._inv_gen
        result = rb._request("read", (("w", 5),))
        with rb._inv_lock:                 # what _recv_loop does on 'inv'
            rb._inv_gen += 1
        rb._cache_store(("w", 5), result, gen)
        assert ("w", 5) not in rb._cache   # invalidated mid-flight: dropped
        gen = rb._inv_gen
        result = rb._request("read", (("w", 5),))
        rb._cache_store(("w", 5), result, gen)
        assert ("w", 5) in rb._cache       # quiescent: stored
    finally:
        rb.close()


def test_cache_coherence_under_commit_race(server):
    """Hammer the commit cycle (delete + re-put by another client)
    against a caching reader: the reader must never observe the value
    going backwards — a regression would mean a stale entry was stored
    after its invalidation frame was drained and then served for the
    whole next version window."""
    reader = RemoteBackend(addr=server.addr, cache_subjects={"w"}, device="cpu")
    writer = RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
    writer.put(("w", 0), 0)
    stop = threading.Event()

    def commit_loop():
        v = 0
        while not stop.is_set():
            v += 1
            writer.delete(("w", 0))
            writer.put(("w", 0), v)

    th = threading.Thread(target=commit_loop, daemon=True)
    th.start()
    last = -1
    try:
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            hit = reader.try_read(("w", 0))
            if hit is None:
                continue                   # between delete and re-put
            assert hit[1] >= last, (
                f"served stale cached value {hit[1]} after observing {last}")
            last = hit[1]
    finally:
        stop.set()
        th.join(3.0)
        reader.close()
        writer.close()
    assert last >= 0


def test_cache_never_serves_nonconcrete_patterns(server):
    rb = RemoteBackend(addr=server.addr, cache_subjects={"w"}, device="cpu")
    try:
        rb.put(("w", 0), 1.0)
        rb.read(("w", 0))
        before = rb.round_trips
        rb.read(("w", ANY))               # wildcard: must round-trip
        assert rb.round_trips == before + 1
    finally:
        rb.close()


# ------------------------------------------------- restart / reconnection
def _until(cond, seconds: float = 5.0) -> bool:
    """Wait for ``cond()`` (polled every 10 ms) for at most ``seconds``."""
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_server_restart_errors_then_reconnects():
    srv = TSServer("sharded:2").start()
    host, port = srv.addr
    rb = RemoteBackend(addr=(host, port), cache_subjects=(), device="cpu")
    rb.put(("w", 0), 1)
    srv.close()
    # The client learns of the drop from its receiver thread: wait for
    # that, not for a fixed time.
    assert _until(lambda: rb.reconnects >= 1)
    # Broken connection surfaces as RemoteSpaceError, not a hang.
    with pytest.raises(RemoteSpaceError):
        rb.read(("w", 0), timeout=1.0)
    # Server comes back on the same port at once (the closed server's
    # port is released); the next op reconnects.
    srv2 = TSServer("sharded:2", host=host, port=port).start()
    try:
        assert _until(lambda: _pings(rb))
        assert rb.ping() == "pong"
        assert rb.reconnects >= 1
        # State lived in the dead server: gone. The client surface is
        # explicit about that (fresh store), not silently stale.
        assert rb.try_read(("w", 0)) is None
    finally:
        rb.close()
        srv2.close()


def _pings(rb) -> bool:
    try:
        return rb.ping() == "pong"
    except RemoteSpaceError:
        return False


def test_dead_connection_unparks_server_waiters(server):
    """A waiter parked with ``timeout=None`` must not outlive its
    connection: when the client dies mid-blocking-take (the process
    fleet SIGKILLs workers), the server-side dispatch thread unparks
    within one ``WAITER_SLICE`` re-check instead of leaking in the
    hosted backend's condvar for the life of the run."""
    def wait_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("ts-wait-")]

    rb = RemoteBackend(addr=server.addr, cache_subjects=(), device="cpu")
    errs = []

    def waiter():
        try:
            rb.get(("never-arrives", 0), timeout=None)
        except RemoteSpaceError as e:
            errs.append(e)

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not wait_threads():
        time.sleep(0.02)
    assert wait_threads(), "waiter never parked server-side"
    rb.close()                     # hard client death: FIN both ways
    th.join(5.0)
    assert errs, "client-side waiter did not fail on connection loss"
    deadline = time.monotonic() + 3 * WAITER_SLICE + 2.0
    while time.monotonic() < deadline and wait_threads():
        time.sleep(0.05)
    assert not wait_threads(), "server leaked parked waiter threads"


def test_pending_waiter_fails_fast_on_server_death():
    srv = TSServer("sharded:2").start()
    rb = RemoteBackend(addr=srv.addr, cache_subjects=(), device="cpu")
    errs = []

    def waiter():
        try:
            rb.get(("never", 0), timeout=30.0)
        except (RemoteSpaceError, TSTimeout) as e:
            errs.append(e)

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    time.sleep(0.2)
    srv.close()
    th.join(5.0)               # NOT 30 — the death must fail the waiter
    rb.close()
    assert not th.is_alive()
    assert errs and isinstance(errs[0], RemoteSpaceError)


# ------------------------------------- server-side sanitizers (role/ctx)
def test_roles_transmitted_to_server_side_checked(server):
    """A checked stack on the SERVER must attribute remote ops to the
    client thread's role — the request carries it."""
    srv = TSServer("checked+sharded:2").start()
    try:
        rb = RemoteBackend(addr=srv.addr, cache_subjects=(), device="cpu")
        checked = srv.backend
        from repro_torch.core.space.schema import KeySchema
        from repro_torch.core.space.api import Key  # noqa: F401
        checked.registry.register(KeySchema(
            subject="guarded", fields=(), producers=frozenset({"manager"}),
            consumers=frozenset({"manager"}), deleters=frozenset({"manager"}),
            lifecycle="persistent"))
        with role("handler"):
            rb.put(("guarded",), 1)          # wrong role → recorded
        with role("manager"):
            rb.put(("guarded",), 2)          # right role → clean
        report = checked.protocol_report()
        assert report["violations"] == 1
        assert "handler" in report["violation_samples"][0]
        rb.close()
    finally:
        srv.close()


# ----------------------------------------------- spec / facade integration
def test_make_backend_remote_spec_spawns_private_server():
    b = make_backend("remote+sharded:2", device="cpu")
    try:
        assert isinstance(b, RemoteBackend)
        b.put(("w", 0), np.arange(8.0))
        assert b.read(("w", 0))[1][5] == 5.0
    finally:
        b.close()


def test_make_backend_remote_client_side_wrappers():
    from repro_torch.core.space import InstrumentedBackend
    b = make_backend("instrumented+remote+sharded:2", device="cpu")
    try:
        assert isinstance(b, InstrumentedBackend)
        assert isinstance(b.inner, RemoteBackend)
        assert b.inner.server_spec == "sharded:2"
    finally:
        b.inner.close()


def test_remote_spec_rejects_recursion():
    with pytest.raises(ValueError):
        TSServer("remote+sharded")


# --------------------------------------- numpy canonicalization (sat. 1)
def test_numpy_scalar_key_fields_canonicalized():
    assert canonicalize_key(("loss", 1, np.int64(3))) == ("loss", 1, 3)
    assert type(canonicalize_key(("x", np.float32(0.5)))[1]) is float
    same = ("plain", 1, "s")
    assert canonicalize_key(same) is same          # fast path: no copy


def test_facade_canonicalizes_numpy_aliased_keys():
    """The regression the satellite names: ``("loss", d, np.int64(s))``
    and ``("loss", d, s)`` must be ONE key through the facade — puts
    alias, reads alias, deletes alias."""
    ts = TupleSpace(backend="local")
    ts.put(("loss", 0, np.int64(3)), 0.25)
    assert ts.count(("loss", 0, 3)) == 1
    hit = ts.try_read(("loss", 0, np.int64(3)))
    assert hit is not None and type(hit[0][2]) is int
    ts.put(("loss", 0, 3), 0.5)                    # overwrite, not alias
    assert ts.count(("loss", ANY, ANY)) == 1
    assert ts.delete(("loss", np.int64(0), 3)) == 1


def test_facade_canonicalizes_put_many_and_batch_ops():
    ts = TupleSpace(backend="local")
    ts.put_many([(("task", np.int32(i)), i) for i in range(4)])
    got = ts.take_batch(("task", ANY), 4, timeout=1.0)
    assert [type(k[1]) for k, _ in got] == [int] * 4


# ------------------------------------------------------------ the port's own
def test_a_closed_server_releases_its_port_at_once():
    """Repaired in the port: the reference's ``close()`` leaves the socket
    listening while its acceptor is blocked in accept, so a client still
    connects and the port cannot be bound again until one does."""
    srv = TSServer("sharded:2").start()
    host, port = srv.addr
    srv.close()
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection((host, port), timeout=2.0).close()
    TSServer("sharded:2", host=host, port=port).start().close()


def test_a_failed_connect_raises_remote_space_error():
    """Repaired in the port: no server at the address is a
    ``RemoteSpaceError`` (the reference lets ``ConnectionRefusedError``
    through), from the constructor as from a reconnect."""
    srv = TSServer("sharded:2").start()
    addr = srv.addr
    srv.close()
    with pytest.raises(RemoteSpaceError, match="cannot connect"):
        RemoteBackend(addr=addr, cache_subjects=(), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_tensors_land_on_the_servers_device_and_come_back_on_the_clients(server, dtype):
    rb = RemoteBackend(addr=server.addr, cache_subjects={"w"}, device="cpu")
    try:
        t = (torch.arange(24.0).reshape(4, 6) * 1.5).to(dtype)
        rb.put(("w", 0), t)
        rb.put(("g", 0), {"ids": t[0], "t": (t, 3)})
        held = server.backend.try_read(("w", 0))[1]
        assert type(held) is torch.Tensor and held.device == server.device
        got = rb.read(("w", 0))[1]
        assert got.dtype == dtype and torch.equal(got, t)
        assert rb.read(("w", 0))[1] is got            # served from the cache
        g = rb.get(("g", 0))[1]
        assert torch.equal(g["ids"], t[0]) and torch.equal(g["t"][0], t) and g["t"][1] == 3
    finally:
        rb.close()


def test_the_device_is_resolved_up_front(monkeypatch):
    """A client or server asked for CUDA on a host without a card raises
    before it connects or listens, instead of storing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSServer("sharded", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        RemoteBackend(addr=("127.0.0.1", 9), device="cuda")


@pytest.mark.parametrize("build", [lambda: RemoteBackend(addr=("127.0.0.1", 9)),
                                   lambda: make_backend("remote+checked+sharded:4"),
                                   lambda: TupleSpace(backend="checked+remote:local")])
def test_a_remote_client_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch, build):
    """No device means CUDA, as everywhere in the port: without a card a
    client raises before it spawns or connects to anything, rather than
    rebuilding what it reads on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


@pytest.mark.parametrize("spec", ["remote:sharded", "instrumented+remote+sharded:2",
                                  "instrumented:remote:sharded:2"])
def test_make_backend_hands_the_device_to_the_client(spec):
    """``make_backend(spec, device=)`` reaches the remote client through
    every spelling of a client-side wrapper; the server stays on the CPU."""
    b = make_backend(spec, device="meta")
    client = b if isinstance(b, RemoteBackend) else b.inner
    try:
        assert isinstance(client, RemoteBackend)
        assert client.device == torch.device("meta")
        client.put(("w", 0), torch.ones(3))
        got = client.read(("w", 0))[1]
        assert got.device == torch.device("meta") and got.shape == (3,)
    finally:
        client.close()
