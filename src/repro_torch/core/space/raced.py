"""``RacedBackend`` — the happens-before race sanitizer.

A transparent :class:`~repro_torch.core.space.api.SpaceBackend` wrapper that
layers dynamic race detection over the protocol sanitizer (select with
``REPRO_TS_BACKEND=raced+checked+sharded`` — stackable exactly like
:class:`~repro_torch.core.space.checked.CheckedBackend`). Where the checked
backend validates each op's *shape* in isolation, this one checks the
**interference** property the frontier scheduler relies on: two stages
the program's ``stage_deps`` lets the Manager run concurrently must
never touch conflicting tuple-space state.

How it works:

- The Manager **announces** the stage lifecycle: ``stage_begin`` when a
  stage enters the frontier (before its ``stage_tasks`` runs) and
  ``stage_complete`` after its ``combine`` returns. Those events carry a
  global sequence number, giving a sound happens-before order: stage
  ``A`` *happens before* stage ``B`` iff ``A`` completed at or before
  ``B``'s launch — completion is a real synchronization (executor writes
  → done marks → barrier → combine) and every launch decision is made on
  the Manager thread after it. Vector-clock comparison thus reduces to
  one ``complete[A] <= launch[B]`` check per pair.
- Every TS op is **attributed** to a stage through thread-local context:
  the Manager wraps ``stage_tasks``/``combine``/``finish_round`` in
  :class:`stage_context`, and the executor wraps each op-kernel group in
  :class:`task_context` — the backend resolves the group's ``(op,
  layer, data_id, step)`` signature against the signatures the Manager
  announced for in-flight stages. The namespace always comes from the
  key itself, so multi-tenant attribution needs no extra plumbing.
- Conflicting accesses (write/write, read/write, or delete/anything) to
  one concrete key — or to a pattern that aliases it — from two stages
  with **no happens-before order in either direction** are recorded as
  :class:`Race`\\ s and surface as ``race_report`` on ``CloudResult``
  next to ``ts_violations``/``ts_leaks``.

Control-plane subjects (tasks, done marks, cursors, histories, cost
stats) are exempt: their discipline — content-keyed marks, epoch-stamped
ids, frontier fences — is enforced by the checks. Unattributed
accesses (setup, handler compensation/undo, tests) are exempt too:
like the checked backend, this sanitizer *records and never raises*, so
a stacked run's trajectory is bit-identical.

A verbatim copy of the reference's ``repro/core/space/raced.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterable

from repro_torch.core.space.api import ANY, Journal, Key, Pattern
from repro_torch.core.space.schema import CONTROL_SCHEMAS, SchemaRegistry

__all__ = ["Race", "RacedBackend", "find_raced", "stage_context",
           "task_context"]

#: Subjects owned by the Manager/Handler protocol — never race-checked.
CONTROL_SUBJECTS = frozenset(s.subject for s in CONTROL_SCHEMAS)

_ctx_tls = threading.local()


def _get_ctx():
    return getattr(_ctx_tls, "ctx", None)


def _set_ctx(ctx) -> None:
    """Install a raw stage/task context tuple on the calling thread —
    the remote TS server's dispatch threads re-assume the context a
    client transmitted with each op, so a server-side RacedBackend
    attributes remote accesses exactly like local ones."""
    _ctx_tls.ctx = ctx


class stage_context:
    """Run a block as stage ``(rnd, stage)`` of the calling Manager's
    program — stage_tasks, combine and finish_round attribution."""

    def __init__(self, rnd: int, stage: str) -> None:
        self._ctx = ("stage", rnd, stage)
        self._prev = None

    def __enter__(self) -> "stage_context":
        self._prev = _get_ctx()
        _ctx_tls.ctx = self._ctx
        return self

    def __exit__(self, *_exc) -> None:
        _ctx_tls.ctx = self._prev


class task_context:
    """Run a block as an executor group with the given task signature;
    the backend maps it to the announced in-flight stage it belongs to
    (unresolvable groups — bare executor tests, post-completion
    stragglers — are exempt)."""

    def __init__(self, op: str, layer: int, data_id: int, step: int) -> None:
        self._ctx = ("task", op, layer, data_id, step)
        self._prev = None

    def __enter__(self) -> "task_context":
        self._prev = _get_ctx()
        _ctx_tls.ctx = self._ctx
        return self

    def __exit__(self, *_exc) -> None:
        _ctx_tls.ctx = self._prev


def _is_wild(f: Any) -> bool:
    return f is ANY or (callable(f) and not isinstance(f, type))


@dataclass(frozen=True)
class Race:
    """One detected pair of unordered conflicting accesses."""

    kind: str          # WW | RW
    namespace: str
    subject: Any
    key: tuple         # concrete key or pattern fields of the 2nd access
    first: tuple       # (rnd, stage) of the earlier access
    second: tuple      # (rnd, stage) of the later access
    detail: str

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        ns = f"{self.namespace}::" if self.namespace else ""
        return (f"[{self.kind}] {ns}{self.subject!r} {self.key!r}: "
                f"round {self.first[0]} stage {self.first[1]!r} vs "
                f"round {self.second[0]} stage {self.second[1]!r} "
                f"unordered ({self.detail})")


def find_raced(backend) -> "RacedBackend | None":
    """The RacedBackend in a wrapper stack, if any (walks ``.inner``)."""
    b = backend
    while b is not None:
        if isinstance(b, RacedBackend):
            return b
        b = getattr(b, "inner", None)
    return None


class _Cell:
    """Per concrete key: the last mutator and the readers since."""

    __slots__ = ("writer", "writer_mode", "readers")

    def __init__(self) -> None:
        self.writer: tuple | None = None   # node = (ns, rnd, stage)
        self.writer_mode = "write"
        self.readers: dict[tuple, None] = {}


class _SubjectState:
    __slots__ = ("cells", "patterns")

    def __init__(self) -> None:
        self.cells: dict[tuple, _Cell] = {}
        self.patterns: deque = deque(maxlen=64)  # (fields, mode, node)


class RacedBackend:
    """Delegates every protocol method to ``inner``, recording the
    access under the current stage attribution first."""

    #: Keep at most this many race records (the count keeps going).
    MAX_RECORDS = 200
    #: Per-subject concrete-key history cap (oldest evicted — eviction
    #: can only miss races, never invent them).
    MAX_CELLS = 4096
    #: Readers tracked per cell since its last write.
    MAX_READERS = 16

    def __init__(self, inner) -> None:
        self.inner = inner
        self.races: list[Race] = []
        self.race_count = 0
        self.raced_ops = 0
        self._lock = threading.Lock()
        self._seq = 0
        self._launch: dict[tuple, int] = {}     # node -> seq at begin
        self._complete: dict[tuple, int] = {}   # node -> seq at combine end
        self._sigs: dict[str, list] = {}        # ns -> [(sig, node)] in-flight
        self._subjects: dict[tuple, _SubjectState] = {}
        self._pairs: set = set()                # (nodeA, nodeB, subject) seen

    # journal passes straight through to the wrapped backend
    @property
    def journal(self) -> Journal | None:
        return self.inner.journal

    @journal.setter
    def journal(self, hook: Journal | None) -> None:
        self.inner.journal = hook

    # ----------------------------------------------------- stage lifecycle
    def stage_begin(self, namespace: str, rnd: int, stage: str) -> None:
        """Manager: stage ``(rnd, stage)`` enters the frontier now."""
        node = (namespace, rnd, stage)
        with self._lock:
            self._seq += 1
            self._launch[node] = self._seq

    def stage_sig(self, namespace: str, rnd: int, stage: str,
                  sig: tuple) -> None:
        """Manager: the stage's issued tasks agree on ``sig`` — the
        ``(op, layer, data_id, step)`` tuple (disagreeing fields ANY)
        executor groups are resolved against."""
        with self._lock:
            self._sigs.setdefault(namespace, []).insert(
                0, (sig, (namespace, rnd, stage)))

    def stage_complete(self, namespace: str, rnd: int, stage: str) -> None:
        """Manager: the stage's barrier closed and its combine returned."""
        node = (namespace, rnd, stage)
        with self._lock:
            self._seq += 1
            self._complete[node] = self._seq
            sigs = self._sigs.get(namespace)
            if sigs:
                self._sigs[namespace] = [e for e in sigs if e[1] != node]

    # ------------------------------------------------------------ recording
    def _resolve_node(self, namespace: str) -> tuple | None:
        ctx = _get_ctx()
        if ctx is None:
            return None
        if ctx[0] == "stage":
            return (namespace, ctx[1], ctx[2])
        vals = ctx[1:]
        for sig, node in self._sigs.get(namespace, ()):
            if node[0] == namespace and all(
                    s is ANY or s == v for s, v in zip(sig, vals)):
                return node
        return None

    def _ordered(self, a: tuple, b: tuple) -> bool:
        if a == b:
            return True
        ca, cb = self._complete.get(a), self._complete.get(b)
        la, lb = self._launch.get(a), self._launch.get(b)
        if la is None or lb is None:
            return True       # unannounced node — exempt, never a race
        return (ca is not None and ca <= lb) or (cb is not None and cb <= la)

    def _race(self, kind: str, ns: str, subject: Any, key: tuple,
              first: tuple, second: tuple, detail: str) -> None:
        pair = (first, second, subject) if first <= second else \
               (second, first, subject)
        if pair in self._pairs:
            return
        self._pairs.add(pair)
        self.race_count += 1
        if len(self.races) < self.MAX_RECORDS:
            self.races.append(Race(
                kind=kind, namespace=ns, subject=subject, key=key,
                first=first[1:], second=second[1:], detail=detail))

    def _check_cell(self, cell: _Cell, mode: str, node: tuple, ns: str,
                    subject: Any, key: tuple) -> None:
        w = cell.writer
        if w is not None and not self._ordered(w, node):
            # any access conflicts with an unordered prior mutation
            kind = "RW" if mode == "read" else "WW"
            self._race(kind, ns, subject, key, w, node,
                       f"prior {cell.writer_mode} vs this {mode}")
        if mode != "read":
            for r in cell.readers:
                if not self._ordered(r, node):
                    self._race("RW", ns, subject, key, r, node,
                               f"prior read vs this {mode}")

    @staticmethod
    def _compat(a: tuple, b: tuple) -> bool:
        """Can two field tuples (either may hold wildcards/predicates)
        describe the same concrete key? Conservative for predicates."""
        if len(a) != len(b):
            return False
        return all(_is_wild(x) or _is_wild(y) or x == y
                   for x, y in zip(a, b))

    def _record(self, mode: str, keyish, destructive_scan: bool = False) -> None:
        """Attribute one access and check it against the subject's
        recorded history. ``mode``: read | write | delete."""
        if not isinstance(keyish, tuple) or not keyish:
            return
        if _is_wild(keyish[0]):
            return
        ns, subject = SchemaRegistry.split_subject(keyish[0])
        if subject in CONTROL_SUBJECTS:
            return
        with self._lock:
            node = self._resolve_node(ns)
            if node is None:
                return
            self.raced_ops += 1
            fields = keyish[1:]
            st = self._subjects.setdefault((ns, subject), _SubjectState())
            concrete = not any(_is_wild(f) for f in fields)
            # check against recorded pattern accesses (unless both read)
            for pf, pm, pn in st.patterns:
                if mode == "read" and pm == "read":
                    continue
                if pn == node or self._ordered(pn, node):
                    continue
                if self._compat(fields, pf):
                    kind = "RW" if "read" in (mode, pm) else "WW"
                    self._race(kind, ns, subject, fields, pn, node,
                               f"prior {pm} pattern vs this {mode}")
            if concrete:
                cell = st.cells.get(fields)
                if cell is None:
                    cell = st.cells.setdefault(fields, _Cell())
                    if len(st.cells) > self.MAX_CELLS:
                        for k in list(st.cells)[:self.MAX_CELLS // 4]:
                            del st.cells[k]
                self._check_cell(cell, mode, node, ns, subject, fields)
                if mode == "read":
                    cell.readers[node] = None
                    if len(cell.readers) > self.MAX_READERS:
                        cell.readers.pop(next(iter(cell.readers)))
                else:
                    cell.writer, cell.writer_mode = node, mode
                    cell.readers.clear()
            else:
                for f in list(st.cells):
                    if self._compat(f, fields):
                        self._check_cell(st.cells[f], mode, node, ns,
                                         subject, f)
                        if destructive_scan and mode == "delete":
                            del st.cells[f]
                st.patterns.append((fields, mode, node))

    # ------------------------------------------------------- protocol ops
    def put(self, key: Key, value: Any) -> None:
        self._record("write", key)
        return self.inner.put(key, value)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        items = list(items)
        for key, _v in items:
            self._record("write", key)
        return self.inner.put_many(items)

    def read(self, pattern: Pattern, timeout: float | None = None):
        self._record("read", pattern)
        return self.inner.read(pattern, timeout)

    def get(self, pattern: Pattern, timeout: float | None = None):
        self._record("delete", pattern, destructive_scan=True)
        return self.inner.get(pattern, timeout)

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None):
        self._record("delete", pattern, destructive_scan=True)
        return self.inner.take_batch(pattern, max_n, timeout)

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None):
        self._record("read", pattern)
        return self.inner.wait_count(pattern, n, timeout)

    def try_read(self, pattern: Pattern):
        self._record("read", pattern)
        return self.inner.try_read(pattern)

    def try_get(self, pattern: Pattern):
        self._record("delete", pattern, destructive_scan=True)
        return self.inner.try_get(pattern)

    def count(self, pattern: Pattern) -> int:
        self._record("read", pattern)
        return self.inner.count(pattern)

    def keys(self, pattern: Pattern) -> list[Key]:
        self._record("read", pattern)
        return self.inner.keys(pattern)

    def delete(self, pattern: Pattern) -> int:
        self._record("delete", pattern, destructive_scan=True)
        return self.inner.delete(pattern)

    def snapshot(self) -> dict[Key, Any]:
        return self.inner.snapshot()

    # ----------------------------------------------------- introspection
    def race_report(self, namespace: str | None = None) -> list[str]:
        """Recorded races as strings (empty = race-free), optionally
        filtered to one tenant's namespace."""
        with self._lock:
            return [str(r) for r in self.races
                    if namespace is None or r.namespace == namespace]

    def stats(self) -> dict[str, int]:
        inner = self.inner.stats()
        inner["raced_ops"] = self.raced_ops
        inner["raced_races"] = self.race_count
        return inner
