"""``InstrumentedBackend`` — transparent wrapper adding latency and
contention counters to any :class:`~repro_torch.core.space.api.SpaceBackend`.

Used by ``benchmarks/ts_bench.py`` / ``benchmarks/sched_bench.py`` to
attribute time per operation and by tests to assert hot-path behaviour.
Counters per operation name: calls, total/max latency (µs), and misses
(``try_read``/``try_get`` returning ``None`` — the idle-poll wakeups the
event-driven control plane eliminates); plus blocking-specific counters
(``timeouts``, ``blocked`` = blocking calls that did not return
immediately, and total blocked time). ``metrics()`` returns the full
breakdown; ``stats()`` returns the inner backend's stats augmented with
aggregate counters.

Deletion accounting (multi-tenant isolation audit): every
``delete`` call is attributed to its pattern's subject —
``delete_metrics()`` returns ``{subject: {"calls", "removed"}}`` plus a
``"<widened>"`` row for ``ANY``/predicate-subject patterns. A
fixed-subject delete can only ever remove tuples of that exact subject,
so with namespace-scoped subjects (:class:`~repro_torch.core.space.scoped
.NsSubject`) the *only* deletes capable of crossing namespaces are the
widened ones — ``stats()["instr_widened_deletes"]`` staying zero is the
multi-tenant co-residency gate's "no cross-tenant deletion" evidence.

A verbatim copy of the reference's ``repro/core/space/instrumented.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable

from repro_torch.core.space.api import (Journal, Key, Pattern, TSTimeout,
                                        subject_is_fixed)

#: delete_metrics() row for deletes whose pattern does not pin a subject.
WIDENED = "<widened>"

#: A blocking call slower than this is counted as contended/blocked (µs).
_BLOCKED_THRESHOLD_US = 500.0


class _OpStat:
    __slots__ = ("calls", "total_us", "max_us", "misses", "timeouts",
                 "blocked", "blocked_us")

    def __init__(self) -> None:
        self.calls = 0
        self.total_us = 0.0
        self.max_us = 0.0
        self.misses = 0
        # Wait stats (blocking ops only): how often and how long this op
        # actually parked — the contention signal the online cost model's
        # consumers read per op, not just in aggregate.
        self.timeouts = 0
        self.blocked = 0
        self.blocked_us = 0.0

    def record(self, us: float, miss: bool = False, timed_out: bool = False,
               blocked: bool = False) -> None:
        self.calls += 1
        self.total_us += us
        if us > self.max_us:
            self.max_us = us
        if miss:
            self.misses += 1
        if timed_out:
            self.timeouts += 1
        if blocked:
            self.blocked += 1
            self.blocked_us += us


class InstrumentedBackend:
    """Delegates every protocol method to ``inner``, timing it."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self._lock = threading.Lock()
        self._ops: dict[str, _OpStat] = {}
        self.timeouts = 0
        self.blocked = 0
        self.blocked_us = 0.0
        # subject (or WIDENED) -> [calls, removed]
        self._deletes: dict[Any, list[int]] = {}

    # journal passes straight through to the wrapped backend
    @property
    def journal(self) -> Journal | None:
        return self.inner.journal

    @journal.setter
    def journal(self, hook: Journal | None) -> None:
        self.inner.journal = hook

    def _record(self, op: str, t0: float, blocking: bool = False,
                timed_out: bool = False, miss: bool = False) -> None:
        us = (time.perf_counter() - t0) * 1e6
        contended = blocking and us > _BLOCKED_THRESHOLD_US
        with self._lock:
            stat = self._ops.get(op)
            if stat is None:
                stat = self._ops[op] = _OpStat()
            stat.record(us, miss=miss, timed_out=timed_out,
                        blocked=contended)
            if timed_out:
                self.timeouts += 1
            if contended:
                self.blocked += 1
                self.blocked_us += us

    def _timed(self, op: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self._record(op, t0)

    def _timed_try(self, op: str, fn, pattern: Pattern):
        t0 = time.perf_counter()
        result = fn(pattern)
        self._record(op, t0, miss=result is None)
        return result

    def _timed_blocking(self, op: str, fn, *args):
        t0 = time.perf_counter()
        try:
            result = fn(*args)
        except TSTimeout:
            self._record(op, t0, blocking=True, timed_out=True)
            raise
        self._record(op, t0, blocking=True)
        return result

    # ------------------------------------------------------- protocol ops
    def put(self, key: Key, value: Any) -> None:
        return self._timed("put", self.inner.put, key, value)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        return self._timed("put_many", self.inner.put_many, items)

    def read(self, pattern: Pattern, timeout: float | None = None):
        return self._timed_blocking("read", self.inner.read, pattern, timeout)

    def get(self, pattern: Pattern, timeout: float | None = None):
        return self._timed_blocking("get", self.inner.get, pattern, timeout)

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None):
        return self._timed_blocking("take_batch", self.inner.take_batch,
                                    pattern, max_n, timeout)

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None):
        return self._timed_blocking("wait_count", self.inner.wait_count,
                                    pattern, n, timeout)

    def try_read(self, pattern: Pattern):
        return self._timed_try("try_read", self.inner.try_read, pattern)

    def try_get(self, pattern: Pattern):
        return self._timed_try("try_get", self.inner.try_get, pattern)

    def count(self, pattern: Pattern) -> int:
        return self._timed("count", self.inner.count, pattern)

    def keys(self, pattern: Pattern) -> list[Key]:
        return self._timed("keys", self.inner.keys, pattern)

    def delete(self, pattern: Pattern) -> int:
        removed = self._timed("delete", self.inner.delete, pattern)
        subject = pattern[0] if (pattern and subject_is_fixed(pattern[0])) \
            else WIDENED
        with self._lock:
            row = self._deletes.get(subject)
            if row is None:
                row = self._deletes[subject] = [0, 0]
            row[0] += 1
            row[1] += removed
        return removed

    def snapshot(self) -> dict[Key, Any]:
        return self._timed("snapshot", self.inner.snapshot)

    # ----------------------------------------------------- introspection
    def metrics(self) -> dict[str, dict[str, float]]:
        """Per-op latency breakdown:
        {op: {calls, total_us, mean_us, max_us, misses,
        timeouts, blocked, blocked_us}} — the last three are the per-op
        wait stats (blocking calls that timed out / parked, and how long
        they parked)."""
        with self._lock:
            out = {}
            for op, s in self._ops.items():
                out[op] = {"calls": s.calls, "total_us": s.total_us,
                           "mean_us": s.total_us / max(s.calls, 1),
                           "max_us": s.max_us, "misses": s.misses,
                           "timeouts": s.timeouts, "blocked": s.blocked,
                           "blocked_us": s.blocked_us}
            return out

    def delete_metrics(self) -> dict[Any, dict[str, int]]:
        """Per-subject delete attribution:
        {subject | WIDENED: {calls, removed}}."""
        with self._lock:
            return {s: {"calls": row[0], "removed": row[1]}
                    for s, row in self._deletes.items()}

    def stats(self) -> dict[str, int]:
        inner = self.inner.stats()
        with self._lock:
            inner["instr_ops"] = sum(s.calls for s in self._ops.values())
            inner["instr_timeouts"] = self.timeouts
            inner["instr_blocked"] = self.blocked
            inner["instr_misses"] = sum(s.misses for s in self._ops.values())
            widened = self._deletes.get(WIDENED)
            inner["instr_widened_deletes"] = widened[0] if widened else 0
        return inner
