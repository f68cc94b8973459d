"""The ACAN Handler (paper §4) — an op-registry dispatcher.

A Handler ``take_batch()``\\ es task tuples from TS (blocking on arrival —
no fixed-cadence polling), checks each against its **capability** (maximum
task size under the op's registered cost model — a too-big task is
*stored* back for another handler, the paper's "process or store"
choice; a task whose op is not in this handler's registry is treated the
same way, so heterogeneous fleets can specialise), groups compatible
tasks (same op/layer/data_id/step), checks execution **preconditions**
per group (inputs present in TS — otherwise the group is discarded; the
Manager's timeout will re-issue it), executes each group vectorized
through :meth:`~repro_torch.core.executor.TaskExecutor.execute_batch`, writes
results, and marks completion with one batched put.

"Store" livelock guard: a stored task is re-put tagged with the storing
handler's name and a unique ownership nonce (value becomes
``(wire, name, nonce)``). If the same handler
drains its own fresh re-put it puts the task straight back and backs off
for one ``store_backoff`` cycle instead of spinning take→store→take —
with every handler under-capacity, the task circulates gently at backoff
cadence until the Manager sweeps and re-partitions it, while small tasks
keep flowing.

Heterogeneity is emulated by a per-handler **speed** (paper §6: ratios
1:5:10, re-drawn at runtime): a group costs one sleep of
``sum(cost) / speed × time_scale``. Crashes are injected via an event
checked *inside* the sleep, so a crash genuinely interrupts in-flight work
(the taken task tuples are lost with the handler — exactly the failure the
timeout/retransmission discipline must cover).

``scheduling="poll"`` preserves the original single-get/50 ms-timeout
loop as the measured baseline for ``benchmarks/sched_bench.py``.

Multi-tenancy: one handler fleet serves several co-resident
programs on one physical space. Pass ``tenants`` — a mapping of
namespace → :class:`HandlerTenant` (that program's
:class:`~repro_torch.core.space.ScopedSpace` view + op registry) — and the
take pattern widens to :func:`~repro_torch.core.space.task_take_pattern`,
draining ``("task", tid)`` tuples across every served namespace in one
``take_batch`` (FIFO in global put order, so no tenant starves). Each
drained task is routed by :func:`~repro_torch.core.space.key_namespace` to its
tenant's executor and registry; done marks and result tuples land in
that tenant's namespace; "store" re-puts keep the scoped key intact. A
task from a namespace this handler does not serve is a capability miss —
stored back, never a crash — so heterogeneous fleets can dedicate
handlers to subsets of tenants; a namespace served with a
``HandlerTenant.max_tasks`` cap keeps at most that many of the tenant's
tasks per drained batch (the rest stored back the same way), so big
handlers can be pinned to big-task tenants without starving anyone.
Without ``tenants`` the handler is the
single-tenant fast path, byte-identical to the single-tenant behaviour
(fixed-subject ``("task", ANY)`` pattern, atomic bucket drains).

Port of the reference's ``repro/core/handler.py``: the same code, with
``repro.`` renamed ``repro_torch.``, :func:`_values_match` comparing
tensors by value, and a crash signalled while the handler is parked in a
blocking take landing before the take (:meth:`Handler._crash_before_take`;
the reference takes the tasks that wake it and dies holding them).
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.costmodel import OnlineCostModel, read_backlog
from repro_torch.core.executor import PreconditionUnmet, TaskExecutor
from repro_torch.core.manager import validate_scheduling
from repro_torch.core.program import OpRegistry, UnknownOp, ensure_builtin_ops
from repro_torch.core.tasks import TaskDesc, content_key
from repro_torch.core.space import (ANY, DEFAULT_NAMESPACE, TSTimeout, TupleSpace,
                                    key_namespace, role, task_take_pattern)


class HandlerCrash(Exception):
    pass


@dataclass
class HandlerTenant:
    """One served program: its namespace view of the shared space and its
    op registry (``None`` = built-in ops).

    ``max_tasks`` optionally caps how many of this namespace's tasks the
    handler *keeps* out of one drained ``take_batch`` — tasks beyond the
    cap are stored back (tagged, like a capability miss) for the rest of
    the fleet. Heterogeneous fleets use asymmetric caps to pin a
    big-task tenant to its big handlers while every handler still serves
    (a trickle of) every namespace. ``None`` = uncapped; poll-mode
    handlers take one task at a time, so the cap only shapes the batched
    event loop."""
    space: Any                          # TupleSpace | ScopedSpace
    registry: OpRegistry | None = None
    max_tasks: int | None = None


@dataclass
class _TenantRT:
    """Per-tenant runtime the loops dispatch through."""
    space: Any
    registry: OpRegistry
    executor: TaskExecutor
    #: Autotune mode only: this tenant's online cost model — the handler
    #: observes its own (op, cost-units, seconds) samples into it,
    #: publishes them as ``("cstats", op, name)`` rows in the tenant's
    #: namespace, and refreshes the fleet's rows back out of TS for the
    #: slow-handler deferral rule. None with autotune off.
    model: OnlineCostModel | None = None


@dataclass
class SpeedBox:
    """Thread-safe mutable speed shared with the fault daemon."""
    speed: float = 1.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def get(self) -> float:
        with self._lock:
            return self.speed

    def set(self, v: float) -> None:
        with self._lock:
            self.speed = v


def _unpack_task(value) -> tuple[str, str | None]:
    """Task tuple value -> (wire, stored_by). Fresh Manager issues carry
    the bare wire string; handler "store" re-puts carry
    ``(wire, name, nonce)`` (older re-puts were ``(wire, name)`` —
    still accepted)."""
    if isinstance(value, tuple):
        return value[0], value[1]
    return value, None


def _values_match(a, b) -> bool:
    """Ownership test for the fence compensations: is the tuple read
    back from TS *our* write? Object identity decides instantly for the
    in-process backends; over a :class:`RemoteBackend` every read is a
    freshly unpickled copy, so fall back to ndarray-aware structural
    equality. Content equality is sound here because every op's output
    is a pure function of the tuples it reads (paper §5.4 idempotency):
    equal content means ours or a duplicate execution's — semantically
    interchangeable — while a later round's legitimate rewrite of a
    step-less key differs (new weights → new values). In the
    pathological bit-identical-rewrite case a delete degrades to one
    Manager re-issue (the missing-tuple discipline), never corruption.

    Tensors (the port's payloads: gradients stay on the card) compare
    like ndarrays: the same type, shape, dtype and device, then
    :func:`torch.equal`. ``bool(a == b)`` on a multi-element tensor
    raises ``RuntimeError``, which the fallback below does not catch."""
    if a is b:
        return True
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (type(a) is type(b) and a.shape == b.shape
                and a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_values_match(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(_values_match(v, b[k]) for k, v in a.items()))
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


@dataclass
class Handler:
    ts: TupleSpace
    name: str
    speed: SpeedBox
    capacity: float = 256.0           # max task size it can handle (4^4)
    lr: float = 0.01                  # exec-env knob for the MLP update op
    time_scale: float = 2e-6          # seconds of sleep per unit cost at speed 1
    batch_size: int = 16              # max tasks drained per take_batch
    take_timeout: float = 0.2         # crash/stop responsiveness bound
    store_backoff: float = 0.02       # own-tagged re-put skip window
    scheduling: str = "event"         # "event" (batched) | "poll" (seed loop)
    #: How emulated compute burns its budget: "sleep" (default —
    #: time.sleep releases the GIL, cheap and exact) or "spin" (a
    #: GIL-holding busy loop in ~1 ms crash-responsive slices). Spin is
    #: what makes thread-vs-process fleet comparisons honest: sleeping
    #: threads overlap perfectly and hide the GIL, spinning threads
    #: serialize on it exactly like real Python compute would.
    compute_mode: str = "sleep"
    registry: OpRegistry | None = None  # None -> built-in ops (MLP + MoE)
    #: namespace -> HandlerTenant for the multi-tenant fleet; None = the
    #: single-tenant fast path over (ts, registry).
    tenants: dict[str, HandlerTenant] | None = None
    #: Online cost-model participation (default off = byte-identical
    #: drain behaviour): report per-op compute stats to TS, drain groups
    #: longest-predicted-work-first across tenants (by each tenant's
    #: published backlog, then LPT within), and defer predicted-long tasks
    #: this handler is fitted as far slower than the fleet's best at.
    autotune: bool = False
    #: Deferral threshold: store a task back when our fitted unit time
    #: for its op exceeds ``defer_ratio`` × the fleet's best. A deferred
    #: task circulates among slow handlers at ``store_backoff`` cadence
    #: at worst (the skip window rate-limits re-drains) until a fast
    #: handler takes it — and a handler draining its *own* tag past the
    #: window always executes, so progress is guaranteed even with every
    #: handler fitted slow.
    defer_ratio: float = 3.0
    crash_event: threading.Event = field(default_factory=threading.Event)
    stop_event: threading.Event = field(default_factory=threading.Event)
    tasks_done: int = 0
    tasks_discarded: int = 0
    tasks_stored: int = 0
    tasks_capped: int = 0             # stored back over a tenant max_tasks cap
    tasks_fenced: int = 0             # dropped/undone: round already finished
    tasks_deferred: int = 0           # stored back by the slow-handler rule
    batches_taken: int = 0
    busy_time: float = 0.0            # emulated compute seconds (utilisation)
    #: Ownership salt for "store" re-puts: object identity does not
    #: survive the wire (the process fleet reads back freshly
    #: unpickled copies), so each re-put value carries a nonce unique to
    #: this handler incarnation — the fence compensation deletes only a
    #: read-back carrying OUR token (see ``_unstore_if_stale``).
    _store_salt: str = field(
        default_factory=lambda: uuid.uuid4().hex[:12], repr=False)
    _store_seq: Any = field(
        default_factory=lambda: itertools.count(1), repr=False)

    def _store_value(self, wire: str) -> tuple:
        """Ownership-tagged re-put value ``(wire, name, nonce)``."""
        return (wire, self.name,
                f"{self._store_salt}.{next(self._store_seq)}")

    def _maybe_crash(self) -> None:
        if self.crash_event.is_set():
            self.crash_event.clear()
            raise HandlerCrash(self.name)

    def _crash_before_take(self, taken: list[tuple]) -> None:
        """A crash signalled while we were parked in a blocking take
        landed before the take: a crashed handler takes nothing. Hand what
        the take returned back untouched (compensated like a store re-put
        if its round closed meanwhile), then die. Otherwise every handler
        parked at a firing would wake on the next pouch only to die
        holding it, and a Manager whose timeout outlasts the fault
        interval would never see that pouch done."""
        if not self.crash_event.is_set():
            return
        self.ts.put_many(taken)
        for key, value in taken:
            task = TaskDesc.from_wire(_unpack_task(value)[0])
            self._unstore_if_stale(key, value, task, self._rt.get(key_namespace(key)))
        self._maybe_crash()

    def _throttled_sleep(self, seconds: float) -> None:
        """Sleep in small slices so crash/stop events interrupt work.
        ``busy_time`` accrues the *actual* elapsed emulated compute —
        crash/stop-truncated work must not count in full, or the
        utilisation proxy would read phantom busy seconds."""
        t0 = time.monotonic()
        deadline = t0 + seconds
        spin = self.compute_mode == "spin"
        try:
            while True:
                self._maybe_crash()
                if self.stop_event.is_set():
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                if spin:
                    # GIL-holding busy work in ~1 ms slices (see
                    # compute_mode): events are still checked every slice.
                    slice_end = time.monotonic() + min(remaining, 0.001)
                    x = 1.0
                    while time.monotonic() < slice_end:
                        x = x * 1.0000001 + 1e-9
                else:
                    time.sleep(min(remaining, 0.01))
        finally:
            self.busy_time += time.monotonic() - t0

    @staticmethod
    def _task_cost(task: TaskDesc, registry: OpRegistry) -> float | None:
        """Registered cost of the task, or None when this handler lacks
        the op — which is a capability miss (store, don't crash)."""
        try:
            return registry.cost(task)
        except UnknownOp:
            return None

    # ------------------------------------------------- finished-round fence
    def _fence_base(self, rt: _TenantRT) -> float:
        """The tenant's finished-round fence: every round strictly below
        the returned base is over (``inf`` once the whole job is), read
        from the Manager's persisted frontier. Every built-in program's
        tasks carry their round in ``step``, so ``task.step < base``
        means the task's results can never be combined again — executing
        it would only write partials nobody will clean (the leak).
        No Manager in the space (no ``("mstate", "epoch")``: bare-Handler
        tests) = -inf: the fence never fires. Once a Manager has run, an
        absent frontier is the gap of its checkpoint, which deletes the
        frontier and then puts the new one (or, after a Manager crash
        between the two, the time until its revival puts it back): read as
        -inf there, the post-write fence kept a finished round's writes.
        The handler waits for the frontier instead."""
        while True:
            if rt.space.try_read(("mstate", "finished")) is not None:
                return float("inf")
            hit = rt.space.try_read(("mstate", "frontier"))
            if hit is not None:
                return float(hit[1].get("base", 0))
            if (rt.space.try_read(("mstate", "epoch")) is None
                    or self.stop_event.is_set()):
                return float("-inf")
            try:
                rt.space.read(("mstate", "frontier"), timeout=0.01)
            except TSTimeout:
                pass

    def _unstore_if_stale(self, key, value, task, rt) -> None:
        """Put-back compensation: a "store" re-put can land after
        the Manager's *final* untaken-task sweep (the one right before
        ``("mstate", "finished")``) and would then outlive the job as a
        leaked task tuple. Re-read the fence *after* the put: if the
        task's round is finished by now, take our own re-put back. The
        delete is ownership-guarded by VALUE, not object identity (which
        never matches over a :class:`RemoteBackend` — every read-back is
        a fresh unpickled copy): event-loop re-puts carry a
        ``(wire, name, nonce)`` token unique to this incarnation, so a
        fresh Manager re-issue (a bare wire string) or another handler's
        re-put (different name/nonce) always survives. Poll-loop stores
        are untagged bare wire by design (the measured baseline); there
        an equal read-back of a *finished* round is deleted — which is
        exactly what the Manager's own sweep would do with it."""
        if rt is None or task is None:
            return
        if task.step >= self._fence_base(rt):
            return
        hit = self.ts.try_read(key)
        if hit is not None and _values_match(hit[1], value):
            self.ts.delete(key)
            self.tasks_fenced += 1

    def _undo_stale(self, rt: _TenantRT, group: list[TaskDesc],
                    written: list[tuple[tuple, Any]]) -> None:
        """The group's round finished while we were executing (the
        Manager's cleanup passes may both have run already): delete our
        own writes so they cannot outlive the round as orphans. Result
        deletes are guarded by :func:`_values_match` (identity for the
        in-process backends, ndarray-aware content equality over the
        wire) — if a later round legitimately re-wrote the same key
        (step-less keys like the MLP ``fpart`` alias across rounds), the
        stored value is not ours and stays. Done marks are content-keyed
        (``step`` included), so the concrete deletes cannot touch a live
        round's marks."""
        for key, value in written:
            hit = rt.space.try_read(key)
            if hit is not None and _values_match(hit[1], value):
                rt.space.delete(key)
        for t in group:
            rt.space.delete(("done",) + content_key(t))
        self.tasks_fenced += len(group)

    def run(self) -> None:
        # Thread-local role tag for the CheckedBackend's producer/consumer
        # checks; the executor narrows it to "executor" around op
        # kernels, and the context form restores it for borrowed threads.
        with role("handler"):
            self._run()

    def _run(self) -> None:
        validate_scheduling(self.scheduling)
        if self.compute_mode not in ("sleep", "spin"):
            raise ValueError(f"unknown compute_mode {self.compute_mode!r} "
                             f"(expected 'sleep' | 'spin')")
        if self.tenants is None:
            # Single-tenant fast path: fixed-subject pattern (atomic
            # bucket drains), behaviour identical to the single-tenant handler.
            if self.registry is None:
                self.registry = ensure_builtin_ops()
            self._rt = {DEFAULT_NAMESPACE: _TenantRT(
                self.ts, self.registry,
                TaskExecutor(self.ts, lr=self.lr, registry=self.registry),
                model=(OnlineCostModel(registry=self.registry)
                       if self.autotune else None))}
            self._take_pat = ("task", ANY)
            self._caps = {}
        else:
            self._rt = {}
            self._caps = {}
            for ns, tenant in self.tenants.items():
                reg = (tenant.registry if tenant.registry is not None
                       else ensure_builtin_ops())
                self._rt[ns] = _TenantRT(
                    tenant.space, reg,
                    TaskExecutor(tenant.space, lr=self.lr, registry=reg),
                    model=(OnlineCostModel(registry=reg)
                           if self.autotune else None))
                if tenant.max_tasks is not None:
                    if int(tenant.max_tasks) < 1:
                        # 0 would make every handler store this tenant's
                        # tasks back forever — a silent livelock, not a
                        # cap. "Don't serve this tenant" is expressed by
                        # omitting it from `tenants`.
                        raise ValueError(
                            f"HandlerTenant.max_tasks must be >= 1, got "
                            f"{tenant.max_tasks!r} for namespace {ns!r}")
                    self._caps[ns] = int(tenant.max_tasks)
            self._take_pat = task_take_pattern(set(self._rt))
        if self.scheduling == "poll":
            return self._run_poll()
        return self._run_event()

    # --------------------------------------------------------- event loop
    def _run_event(self) -> None:
        # ("task", tid) -> monotonic time until which an own-tagged re-put
        # is skipped (put straight back untouched).
        skip_until: dict[tuple, float] = {}
        while not self.stop_event.is_set():
            self._maybe_crash()
            try:
                batch = self.ts.take_batch(self._take_pat, self.batch_size,
                                           timeout=self.take_timeout)
            except TSTimeout:
                continue
            self._crash_before_take(batch)
            self.batches_taken += 1
            now = time.monotonic()
            # (ns, task, cost, key, wire, defer_ok) per kept task — key/
            # wire kept so a group can still be stored back mid-batch
            # (the post-observation deferral below), defer_ok so a task
            # we must execute (our own tag past its skip window) is never
            # re-deferred.
            runnable: list[tuple] = []
            kept: dict[str, int] = {}     # per-namespace tasks kept (caps)
            fences: dict[str, float] = {}  # per-namespace frontier base
            refreshed: set[str] = set()   # namespaces re-fitted this batch
            deferred = 0
            for key, value in batch:
                wire, stored_by = _unpack_task(value)
                ns = key_namespace(key)
                rt = self._rt.get(ns)
                task: TaskDesc | None = None
                if rt is not None:
                    task = TaskDesc.from_wire(wire)
                    base = fences.get(ns)
                    if base is None:
                        base = fences[ns] = self._fence_base(rt)
                    if task.step < base:
                        # Classification fence: this task's round
                        # is already finished — executing it would write
                        # partials nobody will ever clean, and re-putting
                        # it would leak the task tuple. We hold the
                        # drained tuple, so dropping it here IS the
                        # delete. (A cached base only ever under-reads —
                        # the frontier is monotonic — and the post-write
                        # fence below catches whatever slips through.)
                        self.tasks_fenced += 1
                        continue
                if (stored_by is not None
                        and now < skip_until.get(key, 0.0)):
                    # A task we stored or deferred moments ago (the tag
                    # may have been rewritten by another handler since):
                    # hand it back untouched and let someone else reach
                    # it first.
                    self.ts.put(key, value)
                    self._unstore_if_stale(key, value, task, rt)
                    deferred += 1
                    continue
                cap = self._caps.get(ns)
                if cap is not None and kept.get(ns, 0) >= cap:
                    # Over this tenant's per-batch cap: store it back
                    # (tagged like a capability miss) for a handler with
                    # headroom on this namespace.
                    stored = self._store_value(wire)
                    self.ts.put(key, stored)
                    self._unstore_if_stale(key, stored, task, rt)
                    skip_until[key] = now + self.store_backoff
                    self.tasks_stored += 1
                    self.tasks_capped += 1
                    deferred += 1
                    continue
                # Compute the registered cost ONCE per drained task — it
                # classifies here and prices the group's emulated compute
                # below (threaded through `runnable`/`_group`).
                cost = (None if task is None
                        else self._task_cost(task, rt.registry))
                if cost is None or cost > self.capacity:
                    # "store": an unserved namespace, unknown op, or
                    # too-big task — put it back for a more capable
                    # handler, tagged so we skip it for one backoff cycle.
                    stored = self._store_value(wire)
                    self.ts.put(key, stored)
                    self._unstore_if_stale(key, stored, task, rt)
                    skip_until[key] = now + self.store_backoff
                    self.tasks_stored += 1
                    deferred += 1
                    continue
                if (self.autotune and stored_by != self.name
                        and self._should_defer(rt, ns, task, refreshed)):
                    # Slow-handler deferral: the fleet's fit says a peer
                    # runs this op ≥ defer_ratio× faster than us — store
                    # it back (tagged ours) so a faster handler drains
                    # it. It circulates among slow handlers at backoff
                    # cadence at worst (the skip window above), and a
                    # handler draining its OWN tag past the window
                    # executes it — guaranteed progress, no livelock
                    # even with every handler fitted slow.
                    stored = self._store_value(wire)
                    self.ts.put(key, stored)
                    self._unstore_if_stale(key, stored, task, rt)
                    # Quarter window: a deferred task should reach a fast
                    # handler quickly — unlike a capability miss, some
                    # handler CAN run it right now, we just prefer not to.
                    skip_until[key] = now + self.store_backoff / 4.0
                    self.tasks_stored += 1
                    self.tasks_deferred += 1
                    deferred += 1
                    continue
                kept[ns] = kept.get(ns, 0) + 1
                runnable.append((ns, task, cost, key, wire,
                                 stored_by != self.name))
            if len(skip_until) > 4 * self.batch_size:   # prune stale tids
                skip_until = {k: t for k, t in skip_until.items() if t > now}
            groups = self._group(runnable)
            if self.autotune and len(groups) > 1:
                groups = self._prioritize(groups)
            executed = False
            for ns, entries, group_cost in groups:
                rt = self._rt[ns]
                group = [e[1] for e in entries]
                if (self.autotune and executed
                        and all(e[5] for e in entries)
                        and self._should_defer(rt, ns, group[0], set())):
                    # Post-observation deferral: executing an earlier
                    # group of this batch updated our own fit — if it now
                    # says the fleet's best runs this op ≥ defer_ratio×
                    # faster, store the whole group back instead of
                    # sitting on it. This bounds a cold slow handler's
                    # damage to ONE group per batch instead of the whole
                    # drain.
                    for g_ns, g_task, _, g_key, g_wire, _ in entries:
                        stored = self._store_value(g_wire)
                        self.ts.put(g_key, stored)
                        self._unstore_if_stale(g_key, stored, g_task, rt)
                        skip_until[g_key] = (time.monotonic()
                                             + self.store_backoff / 4.0)
                    self.tasks_stored += len(entries)
                    self.tasks_deferred += len(entries)
                    continue
                # Emulated compute time for the whole group — proportional
                # to summed cost (computed once, at classification),
                # inversely to current speed (paper §6.2).
                t_exec = time.monotonic()
                self._throttled_sleep(
                    group_cost
                    * self.time_scale
                    / max(self.speed.get(), 1e-6))
                executed = True
                if rt.model is not None:
                    rt.model.observe(group[0].op, group_cost,
                                     time.monotonic() - t_exec,
                                     src=self.name, n=len(group))
                    # Publish eagerly (dirty rows only — cheap): peers'
                    # deferral decisions are only as fresh as our last
                    # published fit.
                    rt.model.publish(rt.space, self.name)
                if self.stop_event.is_set():
                    return
                if group[0].step < self._fence_base(rt):
                    # Fence re-check after the emulated compute sleep:
                    # the round may have finished while we slept — don't
                    # write partials into a round that is over.
                    self.tasks_fenced += len(group)
                    continue
                try:
                    written = rt.executor.execute_batch(group)
                except PreconditionUnmet:
                    # Inputs not in TS yet: discard the group; the
                    # Manager's timeout re-issues it (§5.1).
                    self.tasks_discarded += len(group)
                    continue
                rt.space.put_many(
                    (("done",) + content_key(t), self.name) for t in group)
                self.tasks_done += len(group)
                if group[0].step < self._fence_base(rt):
                    # The round closed between the pre-execute fence and
                    # our writes: undo them (see _undo_stale — together
                    # with the Manager's post-checkpoint second cleanup
                    # pass this closes the last late-write window).
                    self._undo_stale(rt, group, written)
            if deferred and not runnable:
                # Nothing but own/too-big tasks in the space: back off
                # instead of spinning on our own re-puts.
                self.stop_event.wait(self.store_backoff)

    @staticmethod
    def _group(
        entries: list[tuple],
    ) -> list[tuple[str, list[tuple], float]]:
        """Group compatible tasks for vectorized execution — never across
        namespaces (each group executes against one tenant's space).
        ``entries`` are the classification tuples
        ``(ns, task, cost, key, wire, defer_ok)``; each group keeps them
        whole (so it can be stored back mid-batch) and carries the sum of
        its tasks' classification-time costs, so the compute pricing
        never re-walks the registry."""
        groups: dict[tuple, list[tuple]] = defaultdict(list)
        costs: dict[tuple, float] = defaultdict(float)
        for e in entries:
            ns, t, c = e[0], e[1], e[2]
            groups[(ns, t.op, t.layer, t.data_id, t.step)].append(e)
            costs[(ns, t.op, t.layer, t.data_id, t.step)] += c
        return [(sig[0], es, costs[sig]) for sig, es in groups.items()]

    # ------------------------------------------------- autotune
    def _should_defer(self, rt: _TenantRT, ns: str, task: TaskDesc,
                      refreshed: set[str]) -> bool:
        """Fleet-relative slowness test for one fresh task: are we fitted
        ≥ ``defer_ratio``× slower at its op than the fleet's best source?
        Requires the fleet fit (lazily refreshed once per batch per
        namespace) to show at least one *other* reporting source —
        a lone handler never defers."""
        model = rt.model
        if model is None:
            return False
        if ns not in refreshed:
            model.refresh(rt.space, keep_src=self.name)
            refreshed.add(ns)
        others = [s for s in model.sources() if s != self.name]
        if not others:
            return False
        mine = model.unit_secs(task.op, src=self.name)
        return mine > self.defer_ratio * model.best_unit_secs(task.op)

    def _prioritize(
        self, groups: list[tuple[str, list[tuple], float]],
    ) -> list[tuple[str, list[tuple], float]]:
        """Drain order for one batch's groups: tenants with the longest
        Manager-published predicted backlog first, longest predicted
        group (LPT) within — so on a heterogeneous fleet the expensive
        groups start as early as possible and the stage barrier is not
        held open by a big group started last."""
        backlog: dict[str, float] = {}
        for ns, _, _ in groups:
            if ns not in backlog:
                backlog[ns] = read_backlog(self._rt[ns].space)

        def key(item: tuple[str, list[tuple], float]):
            ns, entries, cost = item
            model = self._rt[ns].model
            secs = cost * (model.unit_secs(entries[0][1].op, src=self.name)
                           if model is not None else 1.0)
            return (-backlog[ns], -secs)

        return sorted(groups, key=key)

    # ---------------------------------------------------------- poll loop
    def _run_poll(self) -> None:
        """The original loop: one 50 ms-timeout get per task, untagged
        stores — the measured baseline for ``benchmarks/sched_bench.py``."""
        while not self.stop_event.is_set():
            self._maybe_crash()
            try:
                key, value = self.ts.get(self._take_pat, timeout=0.05)
            except TSTimeout:
                continue
            self._crash_before_take([(key, value)])
            wire, _ = _unpack_task(value)
            task = TaskDesc.from_wire(wire)
            rt = self._rt.get(key_namespace(key))
            if rt is not None and task.step < self._fence_base(rt):
                self.tasks_fenced += 1    # finished round: drop, don't run
                continue
            cost = (self._task_cost(task, rt.registry)
                    if rt is not None else None)
            if cost is None or cost > self.capacity:
                self.ts.put(key, wire)
                # Same late-re-put leak as the event loop's stores: the
                # put can land after the Manager's final sweep —
                # compensate here too (found by the crash lint:
                # this was the one uncompensated store re-put).
                self._unstore_if_stale(key, wire, task, rt)
                self.tasks_stored += 1
                time.sleep(0.001)
                continue
            self._throttled_sleep(cost * self.time_scale
                                  / max(self.speed.get(), 1e-6))
            try:
                written = rt.executor.execute(task)
            except PreconditionUnmet:
                self.tasks_discarded += 1
                continue
            rt.space.put(("done",) + content_key(task), self.name)
            self.tasks_done += 1
            if task.step < self._fence_base(rt):
                self._undo_stale(rt, [task], written)
