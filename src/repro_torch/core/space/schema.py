"""Key-schema registry — the declared tuple-space protocol.

The paper's fault-tolerance argument rests on the tuple space being the
*only* shared state, which makes TS key discipline the repo's
correctness frontier: every key has an implicit contract (arity, field
types, which roles may put/read/delete it, and who must clean it up)
that previously lived only in docstring tables. This module makes those
contracts declarative:

- :class:`KeySchema` describes one subject: arity, per-field types and
  wildcard rules, producer/consumer/deleter roles among
  :data:`ROLES` = ``{manager, handler, executor, cloud, daemon}``, and a
  lifecycle class in :data:`LIFECYCLES`;
- :class:`SchemaRegistry` resolves concrete keys and patterns (including
  namespace-scoped :class:`~repro_torch.core.space.scoped.NsSubject` keys) to
  their schema;
- :data:`CONTROL_SCHEMAS` declares the control-plane keys the
  Manager/Handler plane itself owns; each
  :class:`~repro_torch.core.program.WorkloadProgram` declares its data-plane
  keys via the ``key_schemas()`` hook.

Consumers: the static lint pass (``tools/ts_lint.py``) checks literal
keys in source against the registry; the runtime sanitizer
(:class:`~repro_torch.core.space.checked.CheckedBackend`) validates every op
and runs the LSan-style shutdown leak check — any non-``persistent``
tuple still in the store at cloud shutdown is an orphan.

Lifecycle classes:

``persistent``
    May outlive the run (committed params, datasets, ``mstate``,
    history keys). Never reported as a leak.
``round_scoped``
    Must be removed by ``finish_round`` of its round.
``stage_scoped``
    Produced inside one stage, consumed by its combine, removed no
    later than ``finish_round``.
``taken_once``
    Removed by being (destructively) taken by its consumer; anything
    left at shutdown is an orphan (e.g. an untaken ``("task", tid)``).

A verbatim copy of the reference's ``repro/core/space/schema.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "CONTROL_SCHEMAS", "FieldSpec", "KeySchema", "LIFECYCLES", "ROLES",
    "SchemaRegistry", "FLOAT_TYPES", "INT_TYPES", "STR_TYPES",
]

#: The actor roles of the control plane (paper §4/§5 components).
ROLES = frozenset({"manager", "handler", "executor", "cloud", "daemon"})

#: Key lifecycle classes (see module docstring).
LIFECYCLES = ("persistent", "round_scoped", "stage_scoped", "taken_once")

#: Accepted concrete types per logical field kind. Keys built from numpy
#: slicing/indexing may carry numpy scalars — accept them alongside the
#: Python types.
INT_TYPES = (int, np.integer)
FLOAT_TYPES = (float, int, np.floating, np.integer)
STR_TYPES = (str,)


@dataclass(frozen=True)
class FieldSpec:
    """One non-subject key field: accepted concrete types (``None`` =
    anything) and whether patterns may wildcard it."""

    name: str
    types: tuple | None = None
    wildcard: bool = True


def int_field(name: str) -> FieldSpec:
    return FieldSpec(name, INT_TYPES)


def float_field(name: str) -> FieldSpec:
    return FieldSpec(name, FLOAT_TYPES)


def str_field(name: str) -> FieldSpec:
    return FieldSpec(name, STR_TYPES)


@dataclass(frozen=True)
class KeySchema:
    """The declared contract of one key subject."""

    subject: str
    fields: tuple[FieldSpec, ...]
    producers: frozenset[str]
    consumers: frozenset[str]
    deleters: frozenset[str]
    lifecycle: str
    description: str = ""

    def __post_init__(self) -> None:
        if self.lifecycle not in LIFECYCLES:
            raise ValueError(f"unknown lifecycle {self.lifecycle!r} "
                             f"for subject {self.subject!r}")
        for roleset in (self.producers, self.consumers, self.deleters):
            bad = set(roleset) - ROLES
            if bad:
                raise ValueError(f"unknown role(s) {sorted(bad)} "
                                 f"for subject {self.subject!r}")

    @property
    def arity(self) -> int:
        """Total key length, subject included."""
        return 1 + len(self.fields)

    @property
    def key_shape(self) -> str:
        """Human-readable key shape for docs: ``("done", op, layer, …)``."""
        parts = ", ".join([f'"{self.subject}"'] + [f.name for f in self.fields])
        return f"({parts})"


def _schema(subject: str, fields: tuple, producers: set, consumers: set,
            deleters: set, lifecycle: str, description: str = "") -> KeySchema:
    return KeySchema(subject=subject, fields=tuple(fields),
                     producers=frozenset(producers),
                     consumers=frozenset(consumers),
                     deleters=frozenset(deleters), lifecycle=lifecycle,
                     description=description)


class SchemaRegistry:
    """Schemas keyed by ``(namespace, subject)``.

    A namespace becomes **strict** once any schema is registered under
    it: unknown subjects are protocol violations only in strict
    namespaces, so a bare :class:`~repro_torch.core.space.TupleSpace` with a
    checked backend but no registered schemas stays fully transparent
    (the conformance suite and ad-hoc scripts keep working unchanged).
    """

    def __init__(self) -> None:
        self._by_key: dict[tuple[str, str], KeySchema] = {}
        self._strict_ns: set[str] = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ declare
    def register(self, schema: KeySchema, namespace: str = "") -> None:
        with self._lock:
            self._by_key[(namespace, schema.subject)] = schema
            self._strict_ns.add(namespace)

    def register_many(self, schemas, namespace: str = "") -> None:
        for s in schemas:
            self.register(s, namespace=namespace)

    # ------------------------------------------------------------ resolve
    @staticmethod
    def split_subject(subject) -> tuple[str, object]:
        """``(namespace, plain_subject)`` of a concrete key subject —
        unwraps :class:`~repro_torch.core.space.scoped.NsSubject`."""
        ns = getattr(subject, "namespace", None)
        if ns is not None and isinstance(subject, tuple):
            return ns, subject[1]
        return "", subject

    def lookup(self, subject) -> tuple[str, object, KeySchema | None]:
        """``(namespace, plain_subject, schema-or-None)``."""
        ns, subj = self.split_subject(subject)
        return ns, subj, self._by_key.get((ns, subj))

    def is_strict(self, namespace: str) -> bool:
        return namespace in self._strict_ns

    def namespaces(self) -> list[str]:
        return sorted(self._strict_ns)

    def schemas(self, namespace: str | None = None):
        """All ``((namespace, subject), schema)`` pairs, optionally
        filtered to one namespace."""
        items = sorted(self._by_key.items())
        if namespace is None:
            return items
        return [(k, s) for k, s in items if k[0] == namespace]

    def __len__(self) -> int:
        return len(self._by_key)


# --------------------------------------------------------------------------
# Control-plane schemas (manager.py / handler.py docstring tables, declared)
# --------------------------------------------------------------------------

CONTROL_SCHEMAS: tuple[KeySchema, ...] = (
    _schema("task", (str_field("tid"),),
            producers={"manager", "handler"},   # handler re-puts on "store"
            consumers={"handler"},
            deleters={"manager", "handler"},    # sweep / store-compensation
            lifecycle="taken_once",
            description="wire-format task; taken by handlers, swept by the "
                        "Manager on revival and at shutdown"),
    _schema("done", (str_field("op"), int_field("layer"),
                     int_field("data_id"), int_field("step"),
                     int_field("in_lo"), int_field("in_hi"),
                     int_field("out_lo"), int_field("out_hi")),
            producers={"handler"},
            consumers={"manager"},
            deleters={"manager", "handler"},    # finish_round / fence undo
            lifecycle="round_scoped",
            description="per-task completion mark (content-addressed)"),
    _schema("mstate", (str_field("name"),),
            producers={"manager"},
            consumers={"manager", "handler", "cloud", "daemon"},
            deleters={"manager"},
            lifecycle="persistent",
            description="Manager recovery state: cursor, rounds, epoch, "
                        "frontier, finished"),
    _schema("thist", (float_field("timeout"), int_field("round")),
            producers={"manager"},
            consumers={"manager", "cloud"},
            deleters={"manager"},
            lifecycle="persistent",
            description="GSS timeout trace (observability)"),
    _schema("losshist", (int_field("step"),),
            producers={"manager"},
            consumers={"manager", "cloud"},
            deleters={"manager"},
            lifecycle="persistent",
            description="bounded loss trajectory (history_limit entries)"),
    _schema("cstats", (str_field("kind"), str_field("src")),
            producers={"manager", "handler"},
            consumers={"manager", "handler", "cloud"},
            deleters={"manager", "handler"},    # re-put on every update
            lifecycle="persistent",
            description="online cost-model aggregates: per-(op, handler) "
                        "observed compute (n/units/secs) plus the "
                        "Manager's predicted-backlog drain-priority row"),
)
