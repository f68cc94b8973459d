"""``CheckedBackend`` — the runtime tuple-space protocol sanitizer.

A transparent :class:`~repro_torch.core.space.api.SpaceBackend` wrapper
(stackable exactly like
:class:`~repro_torch.core.space.instrumented.InstrumentedBackend`, selected
via ``REPRO_TS_BACKEND=checked+local`` / ``checked+sharded``) that
validates every operation against a
:class:`~repro_torch.core.space.schema.SchemaRegistry`:

- **puts** must use a registered subject (in strict namespaces), the
  declared arity, concrete fields of the declared types, and come from a
  declared producer role;
- **reads/takes** with a fixed subject must use the declared arity and
  come from a declared consumer role (widened/predicate subjects — the
  shared fleet's cross-namespace task drain — are structural and are not
  checked);
- **deletes** must come from a declared deleter role; a widened-subject
  delete (the cross-tenant corruption class) is always a violation
  once any schema is registered.

Violations are *recorded, never raised* (``strict=False`` default): the
sanitizer is observation-only, so the §6.1 trajectory is bit-identical
with it stacked. At cloud shutdown :meth:`leak_report` runs the
LSan-style check: every tuple left in the store whose schema lifecycle
is not ``persistent`` is an orphan — something ``finish_round`` /
take-discipline should have removed. ``program_bench`` and the examples
gate on *zero violations and zero leaks*.

Role attribution is thread-local (:func:`set_role` / the :class:`role`
context manager): the Manager, Handler, MonitorDaemon and Cloud mark
their threads, and the executor marks op execution. Code that never
sets a role (tests, ad-hoc scripts) is exempt from role checks but still
gets arity/type/lifecycle checking.

A verbatim copy of the reference's ``repro/core/space/checked.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Iterable

from repro_torch.core.space.api import ANY, Journal, Key, Pattern
from repro_torch.core.space.schema import SchemaRegistry

__all__ = ["CheckedBackend", "Violation", "find_checked", "get_role",
           "role", "set_role"]

_role_tls = threading.local()


def set_role(name: str | None) -> None:
    """Tag the current thread as one of the protocol roles (or None)."""
    _role_tls.role = name


def get_role() -> str | None:
    return getattr(_role_tls, "role", None)


class role:
    """Context manager: run a block under a role, restoring the previous
    one on exit (the executor runs *inside* a handler thread)."""

    def __init__(self, name: str | None) -> None:
        self.name = name
        self._prev: str | None = None

    def __enter__(self) -> "role":
        self._prev = get_role()
        set_role(self.name)
        return self

    def __exit__(self, *_exc) -> None:
        set_role(self._prev)


def _is_wild(f: Any) -> bool:
    return f is ANY or (callable(f) and not isinstance(f, type))


@dataclass(frozen=True)
class Violation:
    """One recorded protocol violation."""

    op: str        # put | read | take | delete
    kind: str      # unknown-subject | arity-mismatch | wildcard-in-put |
                   # bad-field-type | role-violation | widened-delete
    key: tuple
    role: str | None
    detail: str

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        who = self.role or "<no-role>"
        return f"[{self.kind}] {self.op} {self.key!r} by {who}: {self.detail}"


def find_checked(backend) -> "CheckedBackend | None":
    """The CheckedBackend in a wrapper stack, if any (walks ``.inner``)."""
    b = backend
    while b is not None:
        if isinstance(b, CheckedBackend):
            return b
        b = getattr(b, "inner", None)
    return None


class CheckedBackend:
    """Delegates every protocol method to ``inner``, validating first."""

    #: Keep at most this many violation records (the count keeps going).
    MAX_RECORDS = 200

    def __init__(self, inner, registry: SchemaRegistry | None = None,
                 strict: bool = False) -> None:
        self.inner = inner
        self.registry = registry if registry is not None else SchemaRegistry()
        self.strict = strict
        self.violations: list[Violation] = []
        self.violation_count = 0
        self.checked_ops = 0
        self._lock = threading.Lock()

    # journal passes straight through to the wrapped backend
    @property
    def journal(self) -> Journal | None:
        return self.inner.journal

    @journal.setter
    def journal(self, hook: Journal | None) -> None:
        self.inner.journal = hook

    # ---------------------------------------------------------- recording
    def _violate(self, op: str, kind: str, key: tuple, detail: str) -> None:
        v = Violation(op=op, kind=kind, key=key, role=get_role(),
                      detail=detail)
        with self._lock:
            self.violation_count += 1
            if len(self.violations) < self.MAX_RECORDS:
                self.violations.append(v)
        if self.strict:
            raise AssertionError(f"TS protocol violation: {v}")

    # --------------------------------------------------------- validation
    def _check_put(self, key: Key) -> None:
        self.checked_ops += 1
        if not isinstance(key, tuple) or not key:
            return                      # inner validate_key raises its error
        ns, subj, schema = self.registry.lookup(key[0])
        if schema is None:
            if self.registry.is_strict(ns):
                self._violate("put", "unknown-subject", key,
                              f"no schema for subject {subj!r} in "
                              f"namespace {ns!r}")
            return
        if len(key) != schema.arity:
            self._violate("put", "arity-mismatch", key,
                          f"{subj!r} expects arity {schema.arity}, "
                          f"got {len(key)}")
            return
        r = get_role()
        if r is not None and r not in schema.producers:
            self._violate("put", "role-violation", key,
                          f"{r} is not a declared producer of {subj!r} "
                          f"({sorted(schema.producers)})")
        for fs, val in zip(schema.fields, key[1:]):
            if _is_wild(val):
                self._violate("put", "wildcard-in-put", key,
                              f"field {fs.name!r} of {subj!r} is a "
                              f"wildcard/predicate — keys must be concrete")
            elif fs.types is not None and not isinstance(val, fs.types):
                self._violate("put", "bad-field-type", key,
                              f"field {fs.name!r} of {subj!r} expects "
                              f"{'/'.join(t.__name__ for t in fs.types)}, "
                              f"got {type(val).__name__}")

    def _check_pattern(self, op: str, pattern: Pattern) -> None:
        self.checked_ops += 1
        if not isinstance(pattern, tuple) or not pattern:
            return
        if _is_wild(pattern[0]):
            return      # structural cross-subject scan (e.g. fleet drain)
        ns, subj, schema = self.registry.lookup(pattern[0])
        if schema is None:
            if self.registry.is_strict(ns):
                self._violate(op, "unknown-subject", pattern,
                              f"no schema for subject {subj!r} in "
                              f"namespace {ns!r}")
            return
        if len(pattern) != schema.arity:
            self._violate(op, "arity-mismatch", pattern,
                          f"{subj!r} expects arity {schema.arity}, "
                          f"got {len(pattern)}")
            return
        r = get_role()
        if r is not None and r not in schema.consumers:
            self._violate(op, "role-violation", pattern,
                          f"{r} is not a declared consumer of {subj!r} "
                          f"({sorted(schema.consumers)})")
        for fs, val in zip(schema.fields, pattern[1:]):
            if _is_wild(val):
                if not fs.wildcard:
                    self._violate(op, "bad-field-type", pattern,
                                  f"field {fs.name!r} of {subj!r} may not "
                                  f"be wildcarded")
            elif fs.types is not None and not isinstance(val, fs.types):
                self._violate(op, "bad-field-type", pattern,
                              f"field {fs.name!r} of {subj!r} expects "
                              f"{'/'.join(t.__name__ for t in fs.types)}, "
                              f"got {type(val).__name__}")

    def _check_delete(self, pattern: Pattern) -> None:
        self.checked_ops += 1
        if not isinstance(pattern, tuple) or not pattern:
            return
        if _is_wild(pattern[0]):
            if len(self.registry):
                self._violate("delete", "widened-delete", pattern,
                              "subject-widened delete can cross subjects/"
                              "namespaces (corruption class)")
            return
        ns, subj, schema = self.registry.lookup(pattern[0])
        if schema is None:
            if self.registry.is_strict(ns):
                self._violate("delete", "unknown-subject", pattern,
                              f"no schema for subject {subj!r} in "
                              f"namespace {ns!r}")
            return
        if len(pattern) != schema.arity:
            self._violate("delete", "arity-mismatch", pattern,
                          f"{subj!r} expects arity {schema.arity}, "
                          f"got {len(pattern)}")
            return
        r = get_role()
        if r is not None and r not in schema.deleters:
            self._violate("delete", "role-violation", pattern,
                          f"{r} is not a declared deleter of {subj!r} "
                          f"({sorted(schema.deleters)})")

    # ------------------------------------------------------- protocol ops
    def put(self, key: Key, value: Any) -> None:
        self._check_put(key)
        return self.inner.put(key, value)

    def put_many(self, items: Iterable[tuple[Key, Any]]) -> None:
        items = list(items)
        for key, _v in items:
            self._check_put(key)
        return self.inner.put_many(items)

    def read(self, pattern: Pattern, timeout: float | None = None):
        self._check_pattern("read", pattern)
        return self.inner.read(pattern, timeout)

    def get(self, pattern: Pattern, timeout: float | None = None):
        self._check_pattern("take", pattern)
        return self.inner.get(pattern, timeout)

    def take_batch(self, pattern: Pattern, max_n: int,
                   timeout: float | None = None):
        self._check_pattern("take", pattern)
        return self.inner.take_batch(pattern, max_n, timeout)

    def wait_count(self, pattern: Pattern, n: int,
                   timeout: float | None = None):
        self._check_pattern("read", pattern)
        return self.inner.wait_count(pattern, n, timeout)

    def try_read(self, pattern: Pattern):
        self._check_pattern("read", pattern)
        return self.inner.try_read(pattern)

    def try_get(self, pattern: Pattern):
        self._check_pattern("take", pattern)
        return self.inner.try_get(pattern)

    def count(self, pattern: Pattern) -> int:
        self._check_pattern("read", pattern)
        return self.inner.count(pattern)

    def keys(self, pattern: Pattern) -> list[Key]:
        self._check_pattern("read", pattern)
        return self.inner.keys(pattern)

    def delete(self, pattern: Pattern) -> int:
        self._check_delete(pattern)
        return self.inner.delete(pattern)

    def snapshot(self) -> dict[Key, Any]:
        return self.inner.snapshot()

    # ----------------------------------------------------- introspection
    def leak_report(self) -> dict[str, dict[str, Any]]:
        """LSan-style orphan scan: every live tuple whose schema lifecycle
        is not ``persistent`` should have been cleaned up by now. Returns
        ``{"ns::subject": {lifecycle, count, sample}}`` (empty = clean).
        Unregistered subjects are skipped — lifecycle is only meaningful
        where one was declared."""
        leaks: dict[str, dict[str, Any]] = {}
        for key in self.inner.snapshot():
            if not isinstance(key, tuple) or not key:
                continue
            ns, subj, schema = self.registry.lookup(key[0])
            if schema is None or schema.lifecycle == "persistent":
                continue
            label = f"{ns}::{subj}" if ns else str(subj)
            entry = leaks.setdefault(label, {
                "lifecycle": schema.lifecycle, "count": 0, "sample": []})
            entry["count"] += 1
            if len(entry["sample"]) < 3:
                entry["sample"].append(key)
        return leaks

    def protocol_report(self) -> dict[str, Any]:
        """The shutdown gate bundle: violation count + samples + leaks."""
        with self._lock:
            samples = [str(v) for v in self.violations[:20]]
            n = self.violation_count
        return {"violations": n, "violation_samples": samples,
                "leaks": self.leak_report()}

    def stats(self) -> dict[str, int]:
        inner = self.inner.stats()
        inner["checked_ops"] = self.checked_ops
        inner["checked_violations"] = self.violation_count
        return inner
