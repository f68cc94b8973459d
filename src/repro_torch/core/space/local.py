"""``LocalBackend`` — the seed tuple-space engine, refactored behind the
:class:`~repro_torch.core.space.api.SpaceBackend` protocol.

One global lock + condition variable; storage is a dict keyed by the first
key field (the "subject") for cheap candidate narrowing — patterns almost
always fix the subject (``"task"``, ``"act"``, ``"grad"``, ...). Within a
subject bucket insertion order is preserved, and entries carry a global
sequence stamp so ``get`` is FIFO among matches even when the pattern
widens across subjects (fair task pickup).

Two seed bugs are fixed here (and covered by regression tests):

- ``delete``/``count``/``keys`` only widened to all buckets for ``ANY``
  subjects, so a *predicate* subject silently matched nothing; bucket
  selection now routes through :func:`~repro_torch.core.space.api.subject_is_fixed`
  exactly like ``_find``.
- ``put_many`` bypassed the key-type validation ``put`` enforces (a
  non-tuple key would corrupt the store); both now share one validated
  internal path.

A verbatim copy of the reference's ``repro/core/space/local.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from itertools import islice
from typing import Any, Iterable

from repro_torch.core.space.api import (ANY, Journal, Key, Pattern, TSTimeout,
                                        global_seq, match, subject_is_fixed,
                                        validate_key)


class LocalBackend:
    """Single-lock, single-condvar tuple-space backend."""

    def __init__(self, journal: Journal | None = None) -> None:
        self._lock = threading.Condition(threading.Lock())
        # subject -> {key: (seq, value)}; insertion order per bucket.
        self._store: dict[Any, dict[Key, tuple[int, Any]]] = defaultdict(dict)
        self.journal = journal
        self._puts = 0
        self._takes = 0
        self._reads = 0

    # ------------------------------------------------------------------ put
    def _put_locked(self, key: Key, value: Any) -> None:
        """The single insert path shared by put and put_many (both
        validate before reaching here). Re-putting a live key moves it to
        the back of the FIFO so dict order stays seq order."""
        bucket = self._store[key[0]]
        bucket.pop(key, None)
        bucket[key] = (next(global_seq), value)
        self._puts += 1
        if self.journal is not None:
            self.journal("put", key)

    def put(self, key: Key, value: Any) -> None:
        validate_key(key)
        with self._lock:
            self._put_locked(key, value)
            self._lock.notify_all()

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        batch = list(items)
        for key, _ in batch:
            validate_key(key)          # validate everything before inserting
        with self._lock:
            for key, value in batch:
                self._put_locked(key, value)
            self._lock.notify_all()

    # ----------------------------------------------------------- match core
    def _buckets(self, pattern: Pattern) -> list[dict[Key, tuple[int, Any]]]:
        """Candidate buckets for a pattern — THE subject-selection helper
        shared by find/count/keys/delete (fixes the predicate-subject bug)."""
        subject = pattern[0]
        if subject_is_fixed(subject):
            bucket = self._store.get(subject)
            return [bucket] if bucket is not None else []
        return list(self._store.values())

    def _find(self, pattern: Pattern) -> Key | None:
        """Earliest-inserted (lowest-seq) key matching ``pattern``."""
        best_key, best_seq = None, None
        for bucket in self._buckets(pattern):
            for key, (seq, _) in bucket.items():
                if match(pattern, key):
                    # First match in a bucket is that bucket's earliest.
                    if best_seq is None or seq < best_seq:
                        best_key, best_seq = key, seq
                    break
        return best_key

    def _find_batch(self, pattern: Pattern, max_n: int) -> list[Key]:
        """Up to ``max_n`` matching keys in global put (seq) order."""
        if subject_is_fixed(pattern[0]):
            # Single bucket, dict order == seq order (re-puts move to the
            # back): islice stops at max_n — a full scan would make
            # draining a long queue in batches quadratic.
            bucket = self._store.get(pattern[0])
            if bucket is None:
                return []
            return list(islice(
                (k for k in bucket if match(pattern, k)), max_n))
        hits: list[tuple[int, Key]] = []
        for bucket in self._buckets(pattern):
            for key, (seq, _) in bucket.items():
                if match(pattern, key):
                    hits.append((seq, key))
        hits.sort()
        return [k for _, k in hits[:max_n]]

    def _blocking(self, pattern: Pattern, timeout: float | None,
                  destructive: bool) -> tuple[Key, Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                key = self._find(pattern)
                if key is not None:
                    bucket = self._store[key[0]]
                    value = bucket[key][1]
                    if destructive:
                        del bucket[key]
                        if not bucket:
                            del self._store[key[0]]
                        self._takes += 1
                        if self.journal is not None:
                            self.journal("get", key)
                    else:
                        self._reads += 1
                    return key, value
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TSTimeout(f"pattern {pattern!r} timed out")
                    self._lock.wait(remaining)
                else:
                    self._lock.wait()

    # ------------------------------------------------------------ accessors
    def read(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        return self._blocking(pattern, timeout, destructive=False)

    def get(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        return self._blocking(pattern, timeout, destructive=True)

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None) -> list[tuple[Key, Any]]:
        """Block until ≥ 1 match, then take up to ``max_n`` atomically
        (one lock acquisition), FIFO in global put order."""
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                keys = self._find_batch(pattern, max_n)
                if keys:
                    out = []
                    for key in keys:
                        bucket = self._store[key[0]]
                        out.append((key, bucket.pop(key)[1]))
                        if not bucket:
                            del self._store[key[0]]
                        self._takes += 1
                        if self.journal is not None:
                            self.journal("get", key)
                    return out
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TSTimeout(f"pattern {pattern!r} timed out")
                    self._lock.wait(remaining)
                else:
                    self._lock.wait()

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int:
        """Block until ≥ ``n`` tuples match (re-checked on each arrival);
        returns the observed count. Non-destructive."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                c = sum(1 for b in self._buckets(pattern)
                        for k in b if match(pattern, k))
                if c >= n:
                    self._reads += 1
                    return c
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TSTimeout(
                            f"wait_count {pattern!r} >= {n} timed out at {c}")
                    self._lock.wait(remaining)
                else:
                    self._lock.wait()

    def try_read(self, pattern: Pattern) -> tuple[Key, Any] | None:
        with self._lock:
            key = self._find(pattern)
            if key is None:
                return None
            self._reads += 1
            return key, self._store[key[0]][key][1]

    def try_get(self, pattern: Pattern) -> tuple[Key, Any] | None:
        with self._lock:
            key = self._find(pattern)
            if key is None:
                return None
            bucket = self._store[key[0]]
            value = bucket.pop(key)[1]
            if not bucket:
                del self._store[key[0]]
            self._takes += 1
            if self.journal is not None:
                self.journal("get", key)
            return key, value

    # ---------------------------------------------------------------- misc
    def count(self, pattern: Pattern) -> int:
        with self._lock:
            return sum(1 for b in self._buckets(pattern)
                       for k in b if match(pattern, k))

    def keys(self, pattern: Pattern) -> list[Key]:
        with self._lock:
            return [k for b in self._buckets(pattern)
                    for k in b if match(pattern, k)]

    def delete(self, pattern: Pattern) -> int:
        with self._lock:
            removed = 0
            for bucket in self._buckets(pattern):
                for key in [k for k in bucket if match(pattern, k)]:
                    del bucket[key]
                    if self.journal is not None:
                        self.journal("del", key)
                    removed += 1
            for subject in [s for s, b in self._store.items() if not b]:
                del self._store[subject]
            if removed:
                self._lock.notify_all()
            return removed

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "puts": self._puts,
                "takes": self._takes,
                "reads": self._reads,
                "live": sum(len(b) for b in self._store.values()),
            }

    def snapshot(self) -> dict[Key, Any]:
        with self._lock:
            return {k: sv[1] for b in self._store.values()
                    for k, sv in b.items()}
