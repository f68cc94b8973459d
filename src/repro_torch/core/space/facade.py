"""The :class:`TupleSpace` facade — the ACAN coordination substrate
(paper §3) over a pluggable :class:`~repro_torch.core.space.api.SpaceBackend`.

Every component (Manager, Handlers, the elastic runner, the ACAN-over-JAX
step runner, examples) talks to this one class; the storage engine behind
it is chosen per instance::

    TupleSpace()                      # backend from $REPRO_TS_BACKEND
    TupleSpace(backend="sharded")     # explicit by name
    TupleSpace(backend="sharded:32")  # 32 shards
    TupleSpace(backend=LocalBackend())  # bring your own instance

``REPRO_TS_BACKEND`` accepts the same spec strings as
:func:`make_backend`: ``local`` (default), ``sharded``,
``sharded:<n_shards>``, and the stackable wrappers ``instrumented``,
``checked`` and ``raced`` — either legacy colon form
(``instrumented:sharded:4``) or ``+``-stacked (``checked+sharded:4``,
``raced+checked+sharded``); the leftmost wrapper is outermost.

``remote`` splits the stack across a process boundary:
everything right of ``remote`` is the spec the *server* hosts,
everything left of it wraps the client. ``remote+checked+sharded:4``
connects a :class:`~repro_torch.core.space.remote.RemoteBackend` to a server
hosting ``checked+sharded:4`` — spawned privately unless
``$REPRO_TS_ADDR`` names a running one. ``remote`` alone hosts the
default ``sharded``.

The facade is also the **key canonicalization point**: numpy
scalar key fields (``np.int64(3)``, ``np.float32(0.5)``, ...) are
converted to their Python equivalents on the way in, so
``("loss", d, np.int64(s))`` and ``("loss", d, s)`` are one key — not
two aliased tuples that hash apart, match apart, and serialize apart
over the wire.

The facade owns the hash-chained :class:`~repro_torch.core.ledger.Ledger`
(paper §4: "all updates can be logged in an immutable blockchain") and
wires ``ledger.append`` into the backend's journal hook, so every
mutation is recorded regardless of backend — the recovery trace Manager
restarts rely on.

Port of the reference's ``repro/core/space/facade.py``: the same code,
with a ``device`` on :func:`make_backend` and :class:`TupleSpace` (where a
``remote`` client rebuilds the tensors it reads; ``None`` means CUDA, as
everywhere in the port), which the reference has no use for.
"""

from __future__ import annotations

import os
from typing import Any, Iterable

import numpy as np

from repro_torch.core.ledger import Ledger
from repro_torch.core.space.api import Key, Pattern, SpaceBackend
from repro_torch.core.space.checked import CheckedBackend
from repro_torch.core.space.crashpoint import CrashPointBackend
from repro_torch.core.space.instrumented import InstrumentedBackend
from repro_torch.core.space.local import LocalBackend
from repro_torch.core.space.raced import RacedBackend
from repro_torch.core.space.remote import RemoteBackend
from repro_torch.core.space.sharded import ShardedBackend

#: Environment variable consulted when no backend is passed explicitly.
BACKEND_ENV = "REPRO_TS_BACKEND"

#: Stackable transparent wrappers accepted in wrapper specs (colon or
#: ``+``-stacked form). The leftmost name in a stack is the outermost.
_WRAPPERS = {"instrumented": InstrumentedBackend, "checked": CheckedBackend,
             "raced": RacedBackend, "crashpoint": CrashPointBackend}


def make_backend(spec: str | None = None, journal=None,
                 device=None) -> SpaceBackend:
    """Build a backend from a spec string (see module docstring).

    ``None``/empty falls back to ``$REPRO_TS_BACKEND``, then ``local``.
    A ``remote`` client rebuilds the tensors it reads on ``device``
    (``None`` means CUDA, which raises without a card).
    """
    if spec is None or spec == "":
        spec = os.environ.get(BACKEND_ENV, "") or "local"
    head, _, rest = spec.partition(":")
    head = head.strip().lower()
    if "+" in head:
        # Wrapper stack: "checked+sharded:4" / "instrumented+checked+local".
        parts = [p.strip() for p in head.split("+") if p.strip()]
        if "remote" in parts:
            # Everything right of "remote" ships to the server as its
            # hosted spec; everything left of it wraps the client.
            cut = parts.index("remote")
            server_spec = "+".join(parts[cut + 1:]) + (
                (":" + rest) if rest else "")
            backend: SpaceBackend = RemoteBackend(
                server_spec=server_spec or "sharded", journal=journal,
                device=device)
            wrappers = parts[:cut]
        else:
            backend = make_backend(
                parts[-1] + ((":" + rest) if rest else ""), journal=journal)
            wrappers = parts[:-1]
        for name in reversed(wrappers):
            if name not in _WRAPPERS:
                raise ValueError(f"unknown tuple-space wrapper {name!r} "
                                 f"in spec {spec!r}")
            backend = _WRAPPERS[name](backend)
        return backend
    if head == "remote":
        # Colon form: "remote:checked+sharded:4" — rest is the server spec.
        return RemoteBackend(server_spec=rest or "sharded", journal=journal,
                             device=device)
    if head == "local":
        return LocalBackend(journal=journal)
    if head == "sharded":
        if rest:
            return ShardedBackend(n_shards=int(rest), journal=journal)
        return ShardedBackend(journal=journal)
    if head in _WRAPPERS:
        return _WRAPPERS[head](make_backend(rest or "local", journal=journal,
                                            device=device))
    raise ValueError(
        f"unknown tuple-space backend {spec!r} "
        f"(expected local | sharded[:n] | instrumented[:spec] | "
        f"checked[+spec] | raced[+spec] | crashpoint[+spec])")


def canonicalize_key(key):
    """Replace numpy scalar fields with their Python equivalents
    (``np.int64(3)`` → ``3``); the single normalization point for keys
    and patterns entering the space through the facade. Without this,
    ``("loss", d, np.int64(s))`` hashes/equals like ``("loss", d, s)``
    inside one dict but pickles differently over the wire and trips the
    key-schema lint's field-type expectations — one key, two spellings.

    Non-tuple inputs and tuples without numpy scalars pass through
    untouched (fast path: no allocation).
    """
    if isinstance(key, tuple) and any(
            isinstance(f, np.generic) for f in key):
        return tuple(f.item() if isinstance(f, np.generic) else f
                     for f in key)
    return key


class TupleSpace:
    """Thread-safe tuple space with blocking pattern-matched access.

    A thin facade: all storage, matching, and blocking semantics live in
    the backend (see :class:`~repro_torch.core.space.api.SpaceBackend`). The
    facade adds the ledger hook and backend selection.
    """

    def __init__(self, ledger: Ledger | None = None,
                 backend: SpaceBackend | str | None = None,
                 device=None) -> None:
        self.ledger = ledger if ledger is not None else Ledger()
        if backend is None or isinstance(backend, str):
            backend = make_backend(backend, journal=self.ledger.append,
                                   device=device)
        else:
            # A pre-wired hook must keep firing, but this facade's ledger
            # must record too — a silently dead ledger would still verify()
            # as intact. Chain depth stays bounded under repeated wrapping:
            # a hook installed here is tagged with the pre-facade hook it
            # wraps, and a re-wrap chains from that original hook instead
            # of stacking closures (the newest facade's ledger takes over
            # recording; the original hook is preserved).
            existing = getattr(backend, "journal", None)
            base_hook = getattr(existing, "_ts_base_hook", existing)

            def hook(op, key, _prev=base_hook, _append=self.ledger.append):
                if _prev is not None:
                    _prev(op, key)
                _append(op, key)

            hook._ts_base_hook = base_hook
            backend.journal = hook
        self.backend = backend

    # ------------------------------------------------------------------ put
    def put(self, key: Key, value: Any) -> None:
        self.backend.put(canonicalize_key(key), value)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        self.backend.put_many(
            [(canonicalize_key(k), v) for k, v in items])

    # ------------------------------------------------------------ accessors
    def read(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        """Blocking non-destructive match (paper's ``read(&pattern, &buffer)``)."""
        return self.backend.read(canonicalize_key(pattern), timeout)

    def get(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        """Blocking destructive match — once taken, other handlers no longer
        see the tuple (paper §4)."""
        return self.backend.get(canonicalize_key(pattern), timeout)

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None) -> list[tuple[Key, Any]]:
        """Block until ≥ 1 match, then destructively take up to ``max_n``,
        FIFO-ordered in global put order — the Handler's batched task
        pickup. Fixed-subject patterns drain under one lock acquisition;
        widened patterns guarantee per-tuple atomicity only."""
        return self.backend.take_batch(canonicalize_key(pattern), max_n,
                                       timeout)

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int:
        """Block until ≥ ``n`` live tuples match (woken on each arrival);
        returns the observed count — the Manager's pouch done-counter
        barrier."""
        return self.backend.wait_count(canonicalize_key(pattern), n, timeout)

    def try_read(self, pattern: Pattern) -> tuple[Key, Any] | None:
        return self.backend.try_read(canonicalize_key(pattern))

    def try_get(self, pattern: Pattern) -> tuple[Key, Any] | None:
        return self.backend.try_get(canonicalize_key(pattern))

    # ---------------------------------------------------------------- misc
    def count(self, pattern: Pattern) -> int:
        return self.backend.count(canonicalize_key(pattern))

    def keys(self, pattern: Pattern) -> list[Key]:
        return self.backend.keys(canonicalize_key(pattern))

    def delete(self, pattern: Pattern) -> int:
        """Remove all tuples matching pattern; returns count removed."""
        return self.backend.delete(canonicalize_key(pattern))

    def stats(self) -> dict[str, int]:
        return self.backend.stats()

    def snapshot(self) -> dict[Key, Any]:
        """A consistent copy of the full store (Manager restart support)."""
        return self.backend.snapshot()
