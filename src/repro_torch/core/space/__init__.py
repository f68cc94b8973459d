"""``repro_torch.core.space`` — the pluggable ACAN tuple-space package.

Public API:

- data model: :data:`ANY`, :func:`match`, :class:`TSTimeout`
- the :class:`SpaceBackend` protocol (:mod:`repro_torch.core.space.api`)
- backends: :class:`LocalBackend`, :class:`ShardedBackend`,
  :class:`InstrumentedBackend`, :class:`CheckedBackend`,
  :class:`RacedBackend`, :class:`CrashPointBackend` (deterministic
  crash-point injection)
- selection: :func:`make_backend` / ``$REPRO_TS_BACKEND``
- the declared key protocol: :class:`KeySchema` / :class:`SchemaRegistry`
  (:mod:`repro_torch.core.space.schema`) and the runtime sanitizers — protocol
  (:mod:`repro_torch.core.space.checked`) and happens-before race detection
  (:mod:`repro_torch.core.space.raced`)
- the :class:`TupleSpace` facade every ACAN component consumes (also
  the numpy-scalar key canonicalization point, :func:`canonicalize_key`)
- namespace scoping: :class:`ScopedSpace` per-program views over one
  shared space (multi-tenant ACAN), with the :class:`NsSubject` fused
  subject and the helpers in :mod:`repro_torch.core.space.scoped`
- distribution: :class:`RemoteBackend` client /
  :class:`TSServer` host over the :mod:`repro_torch.core.space.wire` protocol
  — spec head ``remote`` (``remote+checked+sharded:4``) or
  ``$REPRO_TS_ADDR``

Port of the reference's ``repro/core/space/__init__.py``.
"""

from repro_torch.core.space.api import (ANY, FieldIn, FieldLE, Journal, Key,
                                        Pattern, SpaceBackend, TSTimeout,
                                        is_concrete, match, subject_is_fixed,
                                        validate_key)
from repro_torch.core.space.checked import (CheckedBackend, Violation, find_checked,
                                            get_role, role, set_role)
from repro_torch.core.space.crashpoint import (CrashPointBackend, CrashPointFired,
                                               CrashSpec, find_crashpoint)
from repro_torch.core.space.facade import (BACKEND_ENV, TupleSpace,
                                           canonicalize_key, make_backend)
from repro_torch.core.space.instrumented import InstrumentedBackend
from repro_torch.core.space.raced import (Race, RacedBackend, find_raced,
                                          stage_context, task_context)
from repro_torch.core.space.remote import (ADDR_ENV, RemoteBackend, RemoteOpError,
                                           RemoteSpaceError, server_timeout)
from repro_torch.core.space.schema import (CONTROL_SCHEMAS, FieldSpec, KeySchema,
                                           LIFECYCLES, ROLES, SchemaRegistry)
from repro_torch.core.space.local import LocalBackend
from repro_torch.core.space.scoped import (DEFAULT_NAMESPACE, NsSubject,
                                           NsSubjectPred, ScopedSpace, as_scoped,
                                           key_namespace, scope_key, scope_pattern,
                                           task_take_pattern, unscope_key)
from repro_torch.core.space.server import TSServer
from repro_torch.core.space.sharded import ShardedBackend

__all__ = [
    "ANY", "FieldIn", "FieldLE", "Journal", "Key", "Pattern",
    "SpaceBackend", "TSTimeout",
    "match", "subject_is_fixed", "is_concrete", "validate_key",
    "BACKEND_ENV", "TupleSpace", "canonicalize_key", "make_backend",
    "ADDR_ENV", "RemoteBackend", "RemoteOpError", "RemoteSpaceError",
    "TSServer", "server_timeout",
    "LocalBackend", "ShardedBackend", "InstrumentedBackend",
    "CheckedBackend", "Violation", "find_checked", "get_role", "role",
    "set_role",
    "CrashPointBackend", "CrashPointFired", "CrashSpec", "find_crashpoint",
    "Race", "RacedBackend", "find_raced", "stage_context", "task_context",
    "CONTROL_SCHEMAS", "FieldSpec", "KeySchema", "LIFECYCLES", "ROLES",
    "SchemaRegistry",
    "DEFAULT_NAMESPACE", "NsSubject", "NsSubjectPred", "ScopedSpace",
    "as_scoped",
    "key_namespace", "scope_key", "scope_pattern", "task_take_pattern",
    "unscope_key",
]
