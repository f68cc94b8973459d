"""The ``SpaceBackend`` protocol — the pluggable storage/coordination API
behind the ACAN tuple space (paper §3, §4).

The paper's ACAN exposes three access methods over ``<key, value>`` tuples::

    put(key, value)            # non-blocking publish
    read(pattern) -> (k, v)    # BLOCKING, non-destructive match
    get(pattern)  -> (k, v)    # BLOCKING, destructive match (take)

Keys are non-empty tuples of hashable fields. A *pattern* is a tuple of the
same arity where :data:`ANY` matches any field value and a callable field
acts as a predicate. ``read``/``get`` block until a match appears, with an
optional timeout — timeouts are the paper's *only* failure signal (§1).

This module defines the data model (``ANY``, :func:`match`,
:class:`TSTimeout`) and the :class:`SpaceBackend` protocol that every
storage engine must implement. Conforming backends shipped in this
package:

- :class:`~repro_torch.core.space.local.LocalBackend` — single lock + condvar,
  one bucket per subject (the seed implementation, bug-fixed).
- :class:`~repro_torch.core.space.sharded.ShardedBackend` — subject-hashed
  shards with per-shard locks/condvars and a (subject, arity) index for
  high-throughput operation under thread contention.
- :class:`~repro_torch.core.space.instrumented.InstrumentedBackend` — a
  transparent wrapper adding latency/contention counters.

Backends are selected through :func:`repro_torch.core.space.make_backend`
(driven by the ``REPRO_TS_BACKEND`` environment variable) and consumed
through the :class:`repro_torch.core.space.TupleSpace` facade.

Beyond the paper's three primitives, the protocol exposes three *reactive*
blocking operations that let the control plane wait for events instead of
polling at a fixed cadence:

- ``take_batch(pattern, max_n, timeout)`` — block until at least one
  match exists, then take up to ``max_n`` matches in FIFO (global put)
  order. For a fixed-subject pattern the batch is drained atomically
  under one lock acquisition, so a Handler amortises the taking cost
  across many tasks; a subject-widened pattern spans shards and only
  guarantees per-tuple atomicity (each tuple still goes to exactly one
  taker) and FIFO order *within* the returned batch.
- ``wait_count(pattern, n, timeout)`` — block until at least ``n`` live
  tuples match, re-checking on each arrival; returns the observed count.
  This is the Manager's pouch *done-counter barrier*: one blocked waiter
  replaces thousands of per-tick ``try_read`` polls.
- ``read(pattern, timeout)`` — the paper's blocking non-destructive
  read, now also the Cloud's completion wait (block on
  ``("mstate", "finished")`` with the wall limit as deadline).

Shared semantic guarantees (the conformance suite in
``tests/test_tuplespace.py`` enforces these identically per backend):

- ``get`` is FIFO among matches in global ``put`` order, *including*
  across subjects/shards for widened (``ANY``/predicate-subject) patterns;
  re-putting a live key moves it to the back of the queue (its latest
  ``put`` defines its position);
- ``take_batch`` returns between 1 and ``max_n`` tuples, FIFO-ordered in
  global put order within the batch, and journals each removal like
  ``get``; it raises :class:`TSTimeout` only when *zero* matches appeared
  before the deadline;
- ``wait_count`` is level-triggered: it returns immediately when the
  count is already ≥ ``n`` (and always for ``n <= 0``) and never removes
  anything;
- ``read`` never removes; ``get``/``try_get`` remove atomically (no two
  takers receive the same tuple);
- ``delete``/``count``/``keys`` honour ``ANY`` and predicate subjects
  exactly like ``read``/``get`` pattern matching;
- every mutation is reported to the backend's ``journal`` hook (the
  hash-chained :class:`~repro_torch.core.ledger.Ledger` when used through the
  facade).

A verbatim copy of the reference's ``repro/core/space/api.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
from itertools import count as _seq_counter
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

__all__ = [
    "ANY", "FieldIn", "FieldLE", "Key", "Pattern", "Journal", "match",
    "TSTimeout", "SpaceBackend", "subject_is_fixed", "is_concrete",
    "validate_key",
]


class _Any:
    """Wildcard sentinel for pattern fields."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "ANY"


ANY = _Any()

Key = tuple
Pattern = tuple
#: Mutation hook ``(op, key)`` — "put" | "get" | "del"; the facade wires the
#: hash-chained Ledger in here. Must not call back into the space (it runs
#: under backend locks).
Journal = Callable[[str, Key], None]


def _field_matches(pat_field: Any, key_field: Any) -> bool:
    if pat_field is ANY:
        return True
    if callable(pat_field) and not isinstance(pat_field, type):
        try:
            return bool(pat_field(key_field))
        except Exception:
            return False
    return pat_field == key_field


def match(pattern: Pattern, key: Key) -> bool:
    """True iff ``key`` matches ``pattern`` (same arity, fieldwise match)."""
    if len(pattern) != len(key):
        return False
    return all(_field_matches(p, k) for p, k in zip(pattern, key))


def subject_is_fixed(subject: Any) -> bool:
    """True iff ``pattern[0]`` pins the subject bucket (a concrete value,
    not the ``ANY`` wildcard and not a predicate).

    This is the one place that decides bucket widening; every backend
    operation (``_find``, ``count``, ``keys``, ``delete``) routes through
    it so a predicate subject widens to *all* buckets everywhere — the
    seed implementation widened only for ``ANY`` in ``delete``/``count``/
    ``keys``, silently matching nothing for callable subjects.
    """
    return not (subject is ANY
                or (callable(subject) and not isinstance(subject, type)))


def is_concrete(pattern: Pattern) -> bool:
    """True iff every field is a concrete value — the pattern can only
    match the identical key, enabling O(1) dict hits in indexed backends."""
    return all(f is not ANY and not (callable(f) and not isinstance(f, type))
               for f in pattern)


def validate_key(key: Any) -> None:
    """The single key-type gate used by ``put`` *and* ``put_many``."""
    if not isinstance(key, tuple) or not key:
        raise TypeError(f"TS key must be a non-empty tuple, got {key!r}")


class FieldIn:
    """Picklable pattern-field predicate: matches fields in ``values``.

    Equivalent to ``lambda v: v in values`` but wire-safe — lambdas
    can't cross the remote backend's frame encoder (closures don't
    pickle), so runtime pattern predicates must be module-level callable
    classes like this one (and the scoped-namespace predicates)."""

    __slots__ = ("values",)

    def __init__(self, values: Any) -> None:
        self.values = frozenset(values)

    def __call__(self, v: Any) -> bool:
        return v in self.values

    def __repr__(self) -> str:
        return f"FieldIn({sorted(self.values)!r})"


class FieldLE:
    """Picklable pattern-field predicate: matches fields ``<= cut``
    (wire-safe replacement for ``lambda v: v <= cut``)."""

    __slots__ = ("cut",)

    def __init__(self, cut: Any) -> None:
        self.cut = cut

    def __call__(self, v: Any) -> bool:
        try:
            return bool(v <= self.cut)
        except TypeError:
            return False

    def __repr__(self) -> str:
        return f"FieldLE({self.cut!r})"


class TSTimeout(Exception):
    """A blocking read/get expired — the ACAN failure signal."""


#: Process-wide monotonically increasing tuple sequence. ``next()`` on an
#: ``itertools.count`` is atomic under the GIL, so backends can stamp
#: insertion order without taking a global lock — this is what makes FIFO
#: take-fairness hold *across* shards.
global_seq = _seq_counter(1)


@runtime_checkable
class SpaceBackend(Protocol):
    """Everything a tuple-space storage engine must provide.

    All methods are thread-safe. Blocking methods (``read``/``get``) honour
    ``timeout`` seconds (``None`` = wait forever) and raise
    :class:`TSTimeout` on expiry. ``journal`` is an optional mutation hook
    attribute (see :data:`Journal`).
    """

    journal: Journal | None

    # mutation ----------------------------------------------------------
    def put(self, key: Key, value: Any) -> None: ...
    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None: ...
    def delete(self, pattern: Pattern) -> int: ...

    # blocking access ---------------------------------------------------
    def read(self, pattern: Pattern,
             timeout: float | None = None) -> tuple[Key, Any]: ...
    def get(self, pattern: Pattern,
            timeout: float | None = None) -> tuple[Key, Any]: ...
    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None) -> list[tuple[Key, Any]]: ...
    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int: ...

    # non-blocking access -----------------------------------------------
    def try_read(self, pattern: Pattern) -> tuple[Key, Any] | None: ...
    def try_get(self, pattern: Pattern) -> tuple[Key, Any] | None: ...

    # introspection -----------------------------------------------------
    def count(self, pattern: Pattern) -> int: ...
    def keys(self, pattern: Pattern) -> list[Key]: ...
    def stats(self) -> dict[str, int]: ...
    def snapshot(self) -> dict[Key, Any]: ...
