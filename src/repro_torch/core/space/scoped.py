"""``ScopedSpace`` — per-program namespace views over one shared
tuple space (multi-tenant ACAN).

The paper's tuple space is the single coordination substrate for *all*
workloads, but every control-plane key the Manager writes —
``("task", tid)``, ``("done", ...)``, ``("mstate", "cursor")`` — and
every program's data-plane keys were global: two programs sharing one
space silently destroyed each other's in-flight tasks (the Manager's
untaken-task sweep deletes ``("task", ANY)``) and recovery cursors.

This module fixes that bug class at its root. A :class:`ScopedSpace` is
a thin handle over a :class:`~repro_torch.core.space.TupleSpace` that rewrites
the **subject** (first key field) of every key and pattern into an
:class:`NsSubject` — a ``(namespace, subject)`` pair — on the way in,
and strips it on the way out. Consequences:

- a tenant's fixed-subject patterns (the only kind the Manager and the
  programs use) *cannot* match another tenant's tuples: subject equality
  fails by construction, so the sweep/cursor collision class is gone;
- keys a caller gets back (``read``/``get``/``keys``/``take_batch``/
  ``snapshot``) are **unscoped** — programs keep indexing fields
  positionally (``k[3]:k[4]`` slices etc.) with no code change;
- the fused subject keeps the backend's performance model: distinct
  ``(namespace, subject)`` pairs hash to distinct shard buckets in
  :class:`~repro_torch.core.space.sharded.ShardedBackend` (unlike a prepended
  namespace *field*, which would funnel a whole program into the single
  bucket of its namespace), and fixed-subject fast paths (atomic
  ``take_batch`` drains, per-shard ``wait_count`` waiters, O(1)
  concrete-pattern hits) all still engage.

The **default namespace** (``""``) is a pure passthrough: keys, ledger
entries and backend traffic are byte-identical to a bare ``TupleSpace``,
which preserves the single-tenant §6.1 trajectory (and its recorded
ledger) bit-for-bit. Named namespaces are flat — scoping an already
scoped space re-scopes from the same root rather than nesting.

The shared handler fleet is the one component that deliberately crosses
namespaces: :func:`task_take_pattern` builds the subject-*predicate*
pattern that drains ``("task", tid)`` tuples of every (or a selected set
of) namespaces in one ``take_batch``, and :func:`key_namespace` tells
the handler which tenant a drained task belongs to, so it can execute
against that tenant's view and registry (capability-miss "store"
semantics unchanged — the re-put keeps the scoped key intact).

A verbatim copy of the reference's ``repro/core/space/scoped.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

from typing import Any, Iterable

from repro_torch.core.space.api import ANY, Key, Pattern

__all__ = [
    "DEFAULT_NAMESPACE", "NsInnerPred", "NsSubject", "NsSubjectPred",
    "ScopedSpace", "TaskSubjectPred", "as_scoped", "key_namespace",
    "scope_key", "scope_pattern", "task_take_pattern", "unscope_key",
]

#: The passthrough namespace: keys stay raw, single-tenant behaviour is
#: byte-identical to a bare TupleSpace.
DEFAULT_NAMESPACE = ""


class NsSubject(tuple):
    """A namespaced subject: a ``(namespace, subject)`` pair fused into
    the first key field. A tuple subclass, so it hashes/orders like the
    pair (backends treat subjects as opaque hashables) — but **equality
    is strict**: an ``NsSubject`` never equals a plain tuple, so a raw
    key whose subject happens to be the tuple ``("mlp", "task")`` cannot
    alias tenant ``mlp``'s scoped ``task`` bucket (overwriting its
    tuples on put, or deleting them while the instrumented audit
    attributes the delete to an innocent fixed subject). Python's
    subclass-operand priority makes this hold on both sides of ``==``.
    """

    __slots__ = ()

    def __new__(cls, namespace: str, subject: Any) -> "NsSubject":
        return super().__new__(cls, (namespace, subject))

    def __getnewargs__(self) -> tuple:
        # tuple's default protocol passes the *pair itself* as the single
        # __new__ argument, which would unpickle as
        # NsSubject(("ns", "subj"), <missing>) — spell the two-argument
        # constructor out so scoped keys survive the wire (RemoteBackend).
        return (self[0], self[1])

    @property
    def namespace(self) -> str:
        return self[0]

    @property
    def subject(self) -> Any:
        return self[1]

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, NsSubject):
            return tuple.__eq__(self, other)
        return False

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    # Same hash as the underlying pair (equal NsSubjects must hash
    # equal); colliding with an aliasing plain tuple in a dict bucket is
    # legal — strict __eq__ keeps the entries distinct.
    __hash__ = tuple.__hash__

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self[0]}::{self[1]!r}"


def scope_key(namespace: str, key: Key) -> Key:
    """Rewrite ``key``'s subject into the namespace (no-op for the
    default namespace)."""
    if not namespace:
        return key
    if not isinstance(key, tuple) or not key:
        # Let the backend's validate_key raise its canonical error.
        return key
    return (NsSubject(namespace, key[0]),) + key[1:]


def unscope_key(key: Key) -> Key:
    """Strip the namespace from a scoped key (no-op for raw keys)."""
    if key and isinstance(key[0], NsSubject):
        return (key[0].subject,) + key[1:]
    return key


def key_namespace(key: Key) -> str:
    """Namespace a (possibly scoped) key belongs to."""
    if key and isinstance(key[0], NsSubject):
        return key[0].namespace
    return DEFAULT_NAMESPACE


class NsSubjectPred:
    """Predicate: any subject of one namespace. A module-level callable
    class (not a closure) so scoped patterns pickle across the wire to a
    remote tuple-space server; value-equal instances compare equal."""

    __slots__ = ("namespace",)

    def __init__(self, namespace: str) -> None:
        self.namespace = namespace

    def __call__(self, s: Any) -> bool:
        return isinstance(s, NsSubject) and s[0] == self.namespace

    def __eq__(self, other: Any) -> bool:
        return (type(other) is NsSubjectPred
                and other.namespace == self.namespace)

    def __hash__(self) -> int:
        return hash((NsSubjectPred, self.namespace))

    def __getstate__(self) -> str:
        return self.namespace

    def __setstate__(self, state: str) -> None:
        self.namespace = state


class NsInnerPred:
    """Predicate: one namespace's subjects filtered by an inner subject
    predicate (itself picklable or not — callers who never cross the wire
    may pass closures as before)."""

    __slots__ = ("namespace", "inner")

    def __init__(self, namespace: str, inner: Any) -> None:
        self.namespace = namespace
        self.inner = inner

    def __call__(self, s: Any) -> bool:
        return (isinstance(s, NsSubject) and s[0] == self.namespace
                and bool(self.inner(s[1])))

    def __eq__(self, other: Any) -> bool:
        return (type(other) is NsInnerPred
                and other.namespace == self.namespace
                and other.inner == self.inner)

    def __hash__(self) -> int:
        return hash((NsInnerPred, self.namespace))

    def __getstate__(self) -> tuple:
        return (self.namespace, self.inner)

    def __setstate__(self, state: tuple) -> None:
        self.namespace, self.inner = state


class TaskSubjectPred:
    """The shared fleet's cross-namespace ``task`` subject predicate:
    matches the task bucket of every namespace (``namespaces=None``) or
    of a fixed set. Picklable (the handler fleet's take pattern must
    reach a remote server); value-equal instances compare equal."""

    __slots__ = ("namespaces",)

    def __init__(self, namespaces: frozenset | None) -> None:
        self.namespaces = namespaces

    def __call__(self, s: Any) -> bool:
        if self.namespaces is None:
            return (s[1] if isinstance(s, NsSubject) else s) == "task"
        if isinstance(s, NsSubject):
            return s[1] == "task" and s[0] in self.namespaces
        return s == "task" and DEFAULT_NAMESPACE in self.namespaces

    def __eq__(self, other: Any) -> bool:
        return (type(other) is TaskSubjectPred
                and other.namespaces == self.namespaces)

    def __hash__(self) -> int:
        return hash((TaskSubjectPred, self.namespaces))

    def __getstate__(self) -> frozenset | None:
        return self.namespaces

    def __setstate__(self, state: frozenset | None) -> None:
        self.namespaces = state


def scope_pattern(namespace: str, pattern: Pattern) -> Pattern:
    """Rewrite a pattern so it only matches ``namespace``'s tuples.

    Concrete subjects fuse into an :class:`NsSubject` (keeping every
    fixed-subject backend fast path); ``ANY``/predicate subjects become a
    predicate pinned to the namespace (widened patterns were already the
    slow path). Default-namespace patterns pass through unchanged — a
    fixed raw subject cannot equal any ``NsSubject``, so isolation from
    named tenants still holds for every pattern the control plane uses.
    """
    if not namespace:
        return pattern
    if not isinstance(pattern, tuple) or not pattern:
        return pattern
    subject = pattern[0]
    if subject is ANY:
        return (NsSubjectPred(namespace),) + pattern[1:]
    if callable(subject) and not isinstance(subject, type):
        return (NsInnerPred(namespace, subject),) + pattern[1:]
    return (NsSubject(namespace, subject),) + pattern[1:]


def task_take_pattern(namespaces: Iterable[str] | None = None) -> Pattern:
    """The shared fleet's cross-namespace task pattern: matches
    ``("task", tid)`` in every namespace (``None``) or in the given set
    (include :data:`DEFAULT_NAMESPACE` for raw, unscoped tasks)."""
    names = None if namespaces is None else frozenset(namespaces)
    return (TaskSubjectPred(names), ANY)


class ScopedSpace:
    """A namespace-scoped view over a shared :class:`TupleSpace`.

    Duck-types the full facade (every component takes either). All
    mutations/matches are confined to ``namespace``; returned keys are
    unscoped. ``ledger``/``backend``/``stats`` report the *shared* root —
    they are fleet-level observables, not per-tenant ones.
    """

    def __init__(self, ts, namespace: str) -> None:
        # Flat namespaces: re-scope from the root, never nest.
        self._ts = ts.root if isinstance(ts, ScopedSpace) else ts
        self.namespace = namespace

    # -------------------------------------------------------------- plumbing
    @property
    def root(self):
        """The underlying shared TupleSpace."""
        return self._ts

    @property
    def ledger(self):
        return self._ts.ledger

    @property
    def backend(self):
        return self._ts.backend

    def scoped(self, namespace: str) -> "ScopedSpace":
        """A sibling view of another namespace over the same root."""
        return ScopedSpace(self._ts, namespace)

    def _k(self, key: Key) -> Key:
        return scope_key(self.namespace, key)

    def _p(self, pattern: Pattern) -> Pattern:
        return scope_pattern(self.namespace, pattern)

    # ------------------------------------------------------------------ put
    def put(self, key: Key, value: Any) -> None:
        self._ts.put(self._k(key), value)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        self._ts.put_many((self._k(k), v) for k, v in items)

    # ------------------------------------------------------------ accessors
    def read(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        k, v = self._ts.read(self._p(pattern), timeout)
        return unscope_key(k), v

    def get(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        k, v = self._ts.get(self._p(pattern), timeout)
        return unscope_key(k), v

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None) -> list[tuple[Key, Any]]:
        return [(unscope_key(k), v)
                for k, v in self._ts.take_batch(self._p(pattern), max_n,
                                                timeout)]

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int:
        return self._ts.wait_count(self._p(pattern), n, timeout)

    def try_read(self, pattern: Pattern) -> tuple[Key, Any] | None:
        hit = self._ts.try_read(self._p(pattern))
        return None if hit is None else (unscope_key(hit[0]), hit[1])

    def try_get(self, pattern: Pattern) -> tuple[Key, Any] | None:
        hit = self._ts.try_get(self._p(pattern))
        return None if hit is None else (unscope_key(hit[0]), hit[1])

    # ---------------------------------------------------------------- misc
    def count(self, pattern: Pattern) -> int:
        return self._ts.count(self._p(pattern))

    def keys(self, pattern: Pattern) -> list[Key]:
        return [unscope_key(k) for k in self._ts.keys(self._p(pattern))]

    def delete(self, pattern: Pattern) -> int:
        return self._ts.delete(self._p(pattern))

    def stats(self) -> dict[str, int]:
        return self._ts.stats()

    def snapshot(self) -> dict[Key, Any]:
        """This namespace's slice of the store, with unscoped keys. (The
        default-namespace view returns the raw snapshot — every key,
        scoped or not — matching its passthrough contract.)"""
        if not self.namespace:
            return self._ts.snapshot()
        return {unscope_key(k): v for k, v in self._ts.snapshot().items()
                if key_namespace(k) == self.namespace}


def as_scoped(ts, namespace: str):
    """``ts`` itself for the default namespace (exact passthrough),
    otherwise a :class:`ScopedSpace` view."""
    return ts if not namespace else ScopedSpace(ts, namespace)
