"""Deterministic crash-point injection backend.

The interval :class:`~repro_torch.core.faults.FaultPlan` crashes threads at
*times*; whether a crash ever lands between two specific TS operations
is sampled luck. The :class:`CrashPointBackend` closes that gap: it is a
transparent :class:`SpaceBackend` wrapper (``crashpoint+checked+sharded``
stacking, inert until armed) that raises a simulated crash at the N-th
TS **mutation** (``put``/``put_many``/``get``/``try_get``/``take_batch``/
``delete``) issued by a given *role* from a given *source site* — the
same ``(path, line)`` address space ``tools/crash_lint.py`` enumerates,
so the static lint's site registry and the runtime injector name
identical crash points and ``tools/crash_sweep.py`` can walk every one.

The raised :class:`CrashPointFired` propagates out of the Manager/
Handler loop exactly like a :class:`ManagerCrash`/:class:`HandlerCrash`
interval firing: the cloud's thread body swallows it, the thread dies,
and the :class:`~repro_torch.core.faults.MonitorDaemon` revives it through the
existing plumbing (firings are accounted into the daemon's counters, see
``MonitorDaemon.crashpoint``).

Arming is one-shot by construction: the site-hit counter keeps moving
past ``nth``, so the revived thread re-traversing the same site does not
die again.

A verbatim copy of the reference's ``repro/core/space/crashpoint.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable

from repro_torch.core.space.api import Journal, Key, Pattern
from repro_torch.core.space.checked import get_role
from repro_torch.core.space.scoped import key_namespace

__all__ = ["CrashPointBackend", "CrashPointFired", "CrashSpec",
           "find_crashpoint"]

#: Frames inside the space package (facade, scoped views, wrapper stack)
#: are machinery, not crash sites — the frame walk skips them to find the
#: caller's source line.
_SPACE_DIR = os.path.dirname(os.path.abspath(__file__))


class CrashPointFired(Exception):
    """Simulated crash at an armed site — kills the issuing thread."""


@dataclass(frozen=True)
class CrashSpec:
    """One armed crash point.

    ``path`` is a repo-relative source path suffix and ``line``/
    ``end_line`` the call's source span (``ast`` line numbers — the
    crash lint's registry carries both); ``role`` is matched against the
    thread-local role tag; ``nth`` counts matching ops (1-based);
    ``when`` fires the crash ``"before"`` the op (nothing written) or
    ``"after"`` it (the write landed, the thread dies before whatever
    came next — the mode that exercises compensation and sweeps).
    """

    site_id: str
    role: str
    path: str
    line: int
    end_line: int = 0
    nth: int = 1
    when: str = "after"

    def __post_init__(self) -> None:
        if self.when not in ("before", "after"):
            raise ValueError(f"when must be before/after, got {self.when!r}")
        if self.nth < 1:
            raise ValueError(f"nth must be >= 1, got {self.nth}")
        if not self.end_line:
            object.__setattr__(self, "end_line", self.line)


def find_crashpoint(backend) -> "CrashPointBackend | None":
    """The CrashPointBackend in a wrapper stack, if any (walks
    ``.inner``)."""
    b = backend
    while b is not None:
        if isinstance(b, CrashPointBackend):
            return b
        b = getattr(b, "inner", None)
    return None


@dataclass
class CrashPointBackend:
    """Transparent wrapper that deterministically crashes the thread
    issuing the N-th TS mutation matching an armed :class:`CrashSpec`.
    Disarmed (the default) it is pure delegation."""

    inner: Any
    _spec: CrashSpec | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)
    #: Matching ops seen so far for the armed spec (monotonic — never
    #: reset by a firing, which is what makes arming one-shot).
    hits: int = 0
    #: Every firing, for post-run inspection: dicts with site/role/op/ns.
    firings: list[dict[str, Any]] = field(default_factory=list)
    _pending: list[dict[str, Any]] = field(default_factory=list)

    # ------------------------------------------------------------- control
    def arm(self, spec: CrashSpec) -> None:
        with self._lock:
            self._spec = spec
            self.hits = 0

    def disarm(self) -> None:
        with self._lock:
            self._spec = None

    def take_firings(self) -> list[dict[str, Any]]:
        """Drain firings not yet accounted (MonitorDaemon hook)."""
        with self._lock:
            out, self._pending = self._pending, []
            return out

    # ------------------------------------------------------------ matching
    def _site_frame(self):
        f = sys._getframe(2)
        while f is not None and os.path.dirname(
                os.path.abspath(f.f_code.co_filename)) == _SPACE_DIR:
            f = f.f_back
        return f

    def _maybe_fire(self, when: str, op: str, key: Any) -> None:
        spec = self._spec
        if spec is None or spec.when != when:
            return
        if get_role() != spec.role:
            return
        f = self._site_frame()
        if f is None:
            return
        fn = f.f_code.co_filename.replace("\\", "/")
        if not fn.endswith(spec.path):
            return
        if not (spec.line <= f.f_lineno <= spec.end_line):
            return
        with self._lock:
            self.hits += 1
            if self.hits != spec.nth:
                return
            try:
                ns = key_namespace(key) if isinstance(key, tuple) else ""
            except Exception:
                ns = ""
            rec = {"site": spec.site_id, "role": spec.role, "op": op,
                   "when": when, "ns": ns}
            self.firings.append(rec)
            self._pending.append(rec)
        raise CrashPointFired(spec.site_id)

    # --------------------------------------------------- journal plumbing
    @property
    def journal(self) -> Journal | None:
        return self.inner.journal

    @journal.setter
    def journal(self, hook: Journal | None) -> None:
        self.inner.journal = hook

    # ------------------------------------------------------ mutation ops
    def put(self, key: Key, value: Any) -> None:
        self._maybe_fire("before", "put", key)
        self.inner.put(key, value)
        self._maybe_fire("after", "put", key)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        batch = list(items)
        first = batch[0][0] if batch else None
        self._maybe_fire("before", "put_many", first)
        self.inner.put_many(batch)
        self._maybe_fire("after", "put_many", first)

    def get(self, pattern: Pattern, timeout: float | None = None):
        self._maybe_fire("before", "get", pattern)
        out = self.inner.get(pattern, timeout)
        self._maybe_fire("after", "get", pattern)
        return out

    def try_get(self, pattern: Pattern):
        self._maybe_fire("before", "try_get", pattern)
        out = self.inner.try_get(pattern)
        self._maybe_fire("after", "try_get", pattern)
        return out

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None):
        self._maybe_fire("before", "take_batch", pattern)
        out = self.inner.take_batch(pattern, max_n, timeout)
        self._maybe_fire("after", "take_batch", pattern)
        return out

    def delete(self, pattern: Pattern) -> int:
        self._maybe_fire("before", "delete", pattern)
        out = self.inner.delete(pattern)
        self._maybe_fire("after", "delete", pattern)
        return out

    # ------------------------------------------------------ read-only ops
    def read(self, pattern: Pattern, timeout: float | None = None):
        return self.inner.read(pattern, timeout)

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None) -> int:
        return self.inner.wait_count(pattern, n, timeout)

    def try_read(self, pattern: Pattern):
        return self.inner.try_read(pattern)

    def count(self, pattern: Pattern) -> int:
        return self.inner.count(pattern)

    def keys(self, pattern: Pattern) -> list[Key]:
        return self.inner.keys(pattern)

    def snapshot(self) -> dict[Key, Any]:
        return self.inner.snapshot()

    def stats(self) -> dict[str, int]:
        st = dict(self.inner.stats())
        st["crashpoint_hits"] = self.hits
        st["crashpoint_firings"] = len(self.firings)
        return st
