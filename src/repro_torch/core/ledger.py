"""Hash-chained append-only ledger (paper §4: "all updates can be logged in
an immutable blockchain, ensuring traceability and accountability").

We keep the paper's intent without a consensus protocol: a single-writer
hash chain whose integrity can be verified after crashes. The ledger is the
durable trace that Manager restarts replay to discover the last committed
pouch/step (see :mod:`repro_torch.checkpoint.journal` for the training-journal
variant used by the pjit layer).

A verbatim copy of the reference's ``repro/core/ledger.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LedgerEntry:
    index: int
    op: str
    key: tuple
    wallclock: float
    prev_hash: str
    hash: str


def _entry_hash(index: int, op: str, key: tuple, wallclock: float, prev_hash: str) -> str:
    h = hashlib.sha256()
    h.update(repr((index, op, key, round(wallclock, 6), prev_hash)).encode())
    return h.hexdigest()


GENESIS = "0" * 64


@dataclass
class Ledger:
    entries: list[LedgerEntry] = field(default_factory=list)
    max_entries: int | None = 200_000  # ring-buffer cap for long runs
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _dropped: int = 0

    def append(self, op: str, key: tuple) -> LedgerEntry:
        with self._lock:
            prev = self.entries[-1].hash if self.entries else GENESIS
            idx = self._dropped + len(self.entries)
            now = time.time()
            entry = LedgerEntry(idx, op, key, now, prev, _entry_hash(idx, op, key, now, prev))
            self.entries.append(entry)
            if self.max_entries is not None and len(self.entries) > self.max_entries:
                self.entries.pop(0)
                self._dropped += 1
            return entry

    def verify(self) -> bool:
        """Recompute the chain; True iff no entry was tampered with."""
        with self._lock:
            prev = self.entries[0].prev_hash if self.entries else GENESIS
            for e in self.entries:
                if e.prev_hash != prev:
                    return False
                if _entry_hash(e.index, e.op, e.key, e.wallclock, e.prev_hash) != e.hash:
                    return False
                prev = e.hash
            return True

    def __len__(self) -> int:
        with self._lock:
            return self._dropped + len(self.entries)
