"""``ShardedBackend`` — high-throughput tuple-space engine: N subject-hashed
shards, per-shard locks/condvars, and a (subject, arity) index.

Why it is fast:

- **Sharding.** Keys hash to a shard by subject (``key[0]``), so threads
  working on different subjects contend on different locks; the seed's
  single global lock serialises every operation and its ``notify_all``
  wakes every blocked consumer on every put (thundering herd).
- **(subject, arity) index.** Buckets are keyed by ``(subject, len(key))``.
  ``match`` requires equal arity, so *every* pattern operation narrows to
  buckets of its own arity — hot patterns like ``("done", ...)`` stop
  scanning unrelated live tuples.
- **Concrete-pattern fast path.** A pattern with no ``ANY``/predicate
  fields can only match the identical key, so ``try_read``/``try_get``/
  ``read``/``get`` become O(1) dict hits — this is the Manager's
  done-mark polling hot path (``_pending`` issues one fully-concrete
  ``try_read`` per task per poll).

Semantics match :class:`~repro_torch.core.space.local.LocalBackend` exactly
(one conformance suite runs over both): ``get`` is FIFO in global put
order even across shards, via the process-wide sequence stamp from
:mod:`repro_torch.core.space.api`.

Blocking across shards: a fixed-subject pattern waits on its own shard's
condition variable. A subject-widened pattern (``ANY``/predicate subject)
registers as a global waiter and re-scans whenever the global event epoch
advances; ``put`` only touches the global condition when such a waiter
exists (checked with a GIL-atomic counter read), so the common put path
never takes a global lock. The waiter increments the counter *before* its
scan, which makes the wakeup race-free: any put that the scan missed must
observe the already-incremented counter and bump the epoch.

The reactive primitives (``take_batch``/``wait_count``) ride the
same two mechanisms: a fixed-subject batch drains its single (subject,
arity) bucket under one shard-lock acquisition (bucket dict order is seq
order, so the batch is FIFO for free), and widened batches/counts reuse
the waiter-epoch protocol so puts stay cheap when nobody is waiting.

A verbatim copy of the reference's ``repro/core/space/sharded.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
import time
from itertools import islice
from typing import Any, Iterable

from repro_torch.core.space.api import (Journal, Key, Pattern, TSTimeout,
                                        global_seq, is_concrete, match,
                                        subject_is_fixed, validate_key)


class _Shard:
    __slots__ = ("cond", "store", "puts", "takes", "reads")

    def __init__(self) -> None:
        self.cond = threading.Condition(threading.Lock())
        # (subject, arity) -> {key: (seq, value)}; insertion order per bucket.
        self.store: dict[tuple[Any, int], dict[Key, tuple[int, Any]]] = {}
        self.puts = 0
        self.takes = 0
        self.reads = 0


class ShardedBackend:
    """Sharded, indexed tuple-space backend (see module docstring)."""

    #: Default shard count — generous relative to typical thread counts so
    #: subject->shard collisions (birthday paradox) stay rare; a shard is
    #: just a dict + condvar, so the overhead of spares is negligible.
    DEFAULT_SHARDS = 64

    def __init__(self, n_shards: int = DEFAULT_SHARDS,
                 journal: Journal | None = None) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self._shards = [_Shard() for _ in range(n_shards)]
        self.journal = journal
        # Global epoch for subject-widened blocking waits.
        self._gcond = threading.Condition(threading.Lock())
        self._events = 0
        self._any_waiters = 0

    def _shard_of(self, subject: Any) -> _Shard:
        return self._shards[hash(subject) % self.n_shards]

    def _bump_global(self) -> None:
        # Plain int read is GIL-atomic; only pay the global lock when a
        # widened-pattern waiter is actually parked.
        if self._any_waiters:
            with self._gcond:
                self._events += 1
                self._gcond.notify_all()

    # ------------------------------------------------------------------ put
    def _insert_locked(self, shard: _Shard, key: Key, value: Any,
                       seq: int | None = None) -> None:
        bucket = shard.store.setdefault((key[0], len(key)), {})
        # Re-putting a live key moves it to the back of the FIFO so dict
        # order stays seq order.
        bucket.pop(key, None)
        bucket[key] = (next(global_seq) if seq is None else seq, value)
        shard.puts += 1
        if self.journal is not None:
            self.journal("put", key)

    def put(self, key: Key, value: Any) -> None:
        validate_key(key)
        shard = self._shard_of(key[0])
        with shard.cond:
            self._insert_locked(shard, key, value)
            shard.cond.notify_all()
        self._bump_global()

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        batch = list(items)
        for key, _ in batch:
            validate_key(key)          # validate everything before inserting
        # Stamp sequence numbers in batch order BEFORE grouping by shard —
        # grouping first would stamp per shard and break the global-FIFO
        # take order for cross-subject batches.
        by_shard: dict[int, list[tuple[Key, Any, int]]] = {}
        for key, value in batch:
            by_shard.setdefault(hash(key[0]) % self.n_shards, []).append(
                (key, value, next(global_seq)))
        for idx, group in by_shard.items():
            shard = self._shards[idx]
            with shard.cond:
                for key, value, seq in group:
                    self._insert_locked(shard, key, value, seq)
                shard.cond.notify_all()
        if batch:
            self._bump_global()

    # ----------------------------------------------------------- match core
    def _find_locked(self, shard: _Shard, pattern: Pattern) -> Key | None:
        """Earliest match within a fixed-subject pattern's bucket (shard
        lock held)."""
        bucket = shard.store.get((pattern[0], len(pattern)))
        if not bucket:
            return None
        if is_concrete(pattern):
            return pattern if pattern in bucket else None
        for key in bucket:
            if match(pattern, key):
                return key
        return None

    def _remove_locked(self, shard: _Shard, key: Key) -> Any:
        idx = (key[0], len(key))
        bucket = shard.store[idx]
        value = bucket.pop(key)[1]
        if not bucket:
            del shard.store[idx]
        shard.takes += 1
        if self.journal is not None:
            self.journal("get", key)
        return value

    def _try_fixed(self, pattern: Pattern,
                   destructive: bool) -> tuple[Key, Any] | None:
        shard = self._shard_of(pattern[0])
        with shard.cond:
            key = self._find_locked(shard, pattern)
            if key is None:
                return None
            if destructive:
                return key, self._remove_locked(shard, key)
            shard.reads += 1
            return key, shard.store[(key[0], len(key))][key][1]

    def _try_widened(self, pattern: Pattern,
                     destructive: bool) -> tuple[Key, Any] | None:
        """One attempt at a subject-widened pattern: find the globally
        earliest match across shards, then take/read it from its shard
        (retrying the scan if it was taken concurrently)."""
        arity = len(pattern)
        while True:
            best: tuple[int, Key, _Shard] | None = None
            for shard in self._shards:
                with shard.cond:
                    for (_, a), bucket in shard.store.items():
                        if a != arity:
                            continue
                        for key, (seq, _) in bucket.items():
                            if match(pattern, key):
                                if best is None or seq < best[0]:
                                    best = (seq, key, shard)
                                break   # first match = bucket's earliest
            if best is None:
                return None
            _, key, shard = best
            with shard.cond:
                bucket = shard.store.get((key[0], len(key)))
                if bucket is None or key not in bucket:
                    continue            # raced with another taker — rescan
                if destructive:
                    return key, self._remove_locked(shard, key)
                shard.reads += 1
                return key, bucket[key][1]

    # ------------------------------------------------------------ accessors
    def _blocking(self, pattern: Pattern, timeout: float | None,
                  destructive: bool) -> tuple[Key, Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        if subject_is_fixed(pattern[0]):
            shard = self._shard_of(pattern[0])
            with shard.cond:
                while True:
                    key = self._find_locked(shard, pattern)
                    if key is not None:
                        if destructive:
                            return key, self._remove_locked(shard, key)
                        shard.reads += 1
                        return key, shard.store[(key[0], len(key))][key][1]
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TSTimeout(f"pattern {pattern!r} timed out")
                        shard.cond.wait(remaining)
                    else:
                        shard.cond.wait()
        # Subject-widened: global epoch wait. Register BEFORE scanning so a
        # put racing with the scan is guaranteed to bump the epoch.
        with self._gcond:
            self._any_waiters += 1
            epoch = self._events
        try:
            while True:
                hit = self._try_widened(pattern, destructive)
                if hit is not None:
                    return hit
                with self._gcond:
                    while self._events == epoch:
                        if deadline is not None:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise TSTimeout(
                                    f"pattern {pattern!r} timed out")
                            self._gcond.wait(remaining)
                        else:
                            self._gcond.wait()
                    epoch = self._events
        finally:
            with self._gcond:
                self._any_waiters -= 1

    # ------------------------------------------------- batched / counted
    def _take_batch_fixed_locked(self, shard: _Shard, pattern: Pattern,
                                 max_n: int) -> list[tuple[Key, Any]]:
        """Up to ``max_n`` matches from the pattern's single (subject,
        arity) bucket. Bucket dict order IS seq order (re-puts move to the
        back), so iteration order is already FIFO."""
        bucket = shard.store.get((pattern[0], len(pattern)))
        if not bucket:
            return []
        # islice stops at max_n — a full-bucket scan would make draining a
        # long queue in batches quadratic.
        taken = list(islice((k for k in bucket if match(pattern, k)), max_n))
        return [(k, self._remove_locked(shard, k)) for k in taken]

    def _take_batch_widened(self, pattern: Pattern,
                            max_n: int) -> list[tuple[Key, Any]]:
        """One attempt at a cross-shard batch: collect every match with
        its seq stamp, sort globally, then take the first ``max_n`` from
        their shards (skipping keys raced away by concurrent takers)."""
        arity = len(pattern)
        found: list[tuple[int, Key]] = []
        for shard in self._shards:
            with shard.cond:
                for (_, a), bucket in shard.store.items():
                    if a != arity:
                        continue
                    found.extend((seq, key) for key, (seq, _) in bucket.items()
                                 if match(pattern, key))
        found.sort()
        out: list[tuple[Key, Any]] = []
        for _, key in found:
            if len(out) >= max_n:
                break
            shard = self._shard_of(key[0])
            with shard.cond:
                bucket = shard.store.get((key[0], len(key)))
                if bucket is None or key not in bucket:
                    continue            # raced with another taker
                out.append((key, self._remove_locked(shard, key)))
        return out

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None) -> list[tuple[Key, Any]]:
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        deadline = None if timeout is None else time.monotonic() + timeout
        if subject_is_fixed(pattern[0]):
            shard = self._shard_of(pattern[0])
            with shard.cond:
                while True:
                    out = self._take_batch_fixed_locked(shard, pattern, max_n)
                    if out:
                        return out
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TSTimeout(f"pattern {pattern!r} timed out")
                        shard.cond.wait(remaining)
                    else:
                        shard.cond.wait()
        # Widened: register as a global waiter BEFORE scanning (same
        # race-free protocol as _blocking).
        with self._gcond:
            self._any_waiters += 1
            epoch = self._events
        try:
            while True:
                out = self._take_batch_widened(pattern, max_n)
                if out:
                    return out
                with self._gcond:
                    while self._events == epoch:
                        if deadline is not None:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise TSTimeout(
                                    f"pattern {pattern!r} timed out")
                            self._gcond.wait(remaining)
                        else:
                            self._gcond.wait()
                    epoch = self._events
        finally:
            with self._gcond:
                self._any_waiters -= 1

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        if subject_is_fixed(pattern[0]):
            shard = self._shard_of(pattern[0])
            with shard.cond:
                while True:
                    c = sum(1 for b in self._buckets_locked(shard, pattern)
                            for k in b if match(pattern, k))
                    if c >= n:
                        shard.reads += 1
                        return c
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TSTimeout(
                                f"wait_count {pattern!r} >= {n} "
                                f"timed out at {c}")
                        shard.cond.wait(remaining)
                    else:
                        shard.cond.wait()
        # Widened: count spans shards, so wake on the global epoch.
        with self._gcond:
            self._any_waiters += 1
            epoch = self._events
        try:
            while True:
                c = self.count(pattern)
                if c >= n:
                    return c
                with self._gcond:
                    while self._events == epoch:
                        if deadline is not None:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise TSTimeout(
                                    f"wait_count {pattern!r} >= {n} "
                                    f"timed out at {c}")
                            self._gcond.wait(remaining)
                        else:
                            self._gcond.wait()
                    epoch = self._events
        finally:
            with self._gcond:
                self._any_waiters -= 1

    def read(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        return self._blocking(pattern, timeout, destructive=False)

    def get(self, pattern: Pattern, timeout: float | None = None) -> tuple[Key, Any]:
        return self._blocking(pattern, timeout, destructive=True)

    def try_read(self, pattern: Pattern) -> tuple[Key, Any] | None:
        if subject_is_fixed(pattern[0]):
            return self._try_fixed(pattern, destructive=False)
        return self._try_widened(pattern, destructive=False)

    def try_get(self, pattern: Pattern) -> tuple[Key, Any] | None:
        if subject_is_fixed(pattern[0]):
            return self._try_fixed(pattern, destructive=True)
        return self._try_widened(pattern, destructive=True)

    # ---------------------------------------------------------------- misc
    def _pattern_shards(self, pattern: Pattern) -> list[_Shard]:
        if subject_is_fixed(pattern[0]):
            return [self._shard_of(pattern[0])]
        return list(self._shards)

    def _buckets_locked(self, shard: _Shard, pattern: Pattern):
        """Candidate buckets within a shard (arity-narrowed; shard lock
        held). Mirrors LocalBackend's unified subject-selection helper."""
        arity = len(pattern)
        if subject_is_fixed(pattern[0]):
            bucket = shard.store.get((pattern[0], arity))
            return [bucket] if bucket else []
        return [b for (_, a), b in shard.store.items() if a == arity]

    def count(self, pattern: Pattern) -> int:
        total = 0
        for shard in self._pattern_shards(pattern):
            with shard.cond:
                for bucket in self._buckets_locked(shard, pattern):
                    total += sum(1 for k in bucket if match(pattern, k))
        return total

    def keys(self, pattern: Pattern) -> list[Key]:
        out: list[Key] = []
        for shard in self._pattern_shards(pattern):
            with shard.cond:
                for bucket in self._buckets_locked(shard, pattern):
                    out.extend(k for k in bucket if match(pattern, k))
        return out

    def delete(self, pattern: Pattern) -> int:
        removed = 0
        for shard in self._pattern_shards(pattern):
            with shard.cond:
                shard_removed = 0
                for bucket in self._buckets_locked(shard, pattern):
                    for key in [k for k in bucket if match(pattern, k)]:
                        del bucket[key]
                        if self.journal is not None:
                            self.journal("del", key)
                        shard_removed += 1
                if shard_removed:
                    for idx in [i for i, b in shard.store.items() if not b]:
                        del shard.store[idx]
                    shard.cond.notify_all()
                removed += shard_removed
        return removed

    def _all_locked(self):
        """Acquire every shard lock in index order (consistent global
        ordering — no other code path ever holds two shard locks)."""
        class _All:
            def __enter__(_self):
                for s in self._shards:
                    s.cond.acquire()

            def __exit__(_self, *exc):
                for s in reversed(self._shards):
                    s.cond.release()
                return False
        return _All()

    def stats(self) -> dict[str, int]:
        with self._all_locked():
            return {
                "puts": sum(s.puts for s in self._shards),
                "takes": sum(s.takes for s in self._shards),
                "reads": sum(s.reads for s in self._shards),
                "live": sum(len(b) for s in self._shards
                            for b in s.store.values()),
                "shards": self.n_shards,
            }

    def snapshot(self) -> dict[Key, Any]:
        with self._all_locked():
            return {k: sv[1] for s in self._shards
                    for b in s.store.values() for k, sv in b.items()}
