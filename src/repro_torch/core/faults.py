"""Fault injection + the monitor daemon (paper §6).

The paper's simulation has "one Manager thread and four Handler threads, all
of which may crash during execution. The daemon thread continuously monitors
the system and revives failed Manager thread using the latest checkpoint
[TS cursor]… in our simulation we still recreate crashed Handler threads…
to emulate fluctuating computational resources, we dynamically vary the
processing speed of Handler threads during runtime."

:class:`FaultPlan` describes *when* faults fire (every ``interval`` seconds,
each with a probability — the paper's experiments use probability 1.0);
:class:`MonitorDaemon` applies them and revives dead threads.

A verbatim copy of the reference's ``repro/core/faults.py``: the code is the
same, with ``repro.`` renamed ``repro_torch.``, so one plan's seeded draws
fire the same events in the same order in both packages.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class FaultPlan:
    interval: float = 5.0                 # paper: every 5 s (we compress)
    speed_levels: tuple = (1.0, 5.0, 10.0)  # paper: ratios 1:5:10
    p_speed_change: float = 0.0           # exp2/exp3: 1.0
    p_handler_crash: float = 0.0          # exp3: 1.0
    p_manager_crash: float = 0.0          # exp3: 1.0
    seed: int = 0


@dataclass
class MonitorDaemon:
    """Fires the fault plan and revives dead threads.

    ``make_manager_thread`` / ``make_handler_thread(i)`` must return fresh,
    *started* threads resuming from TS state. Revival is unconditional —
    the daemon notices death by ``Thread.is_alive()`` polling (it cannot
    reliably detect *failure*, only absence — consistent with the paper's
    stance that reliable failure detection is impossible).

    Multi-tenancy: one daemon supervises *several* Managers (one
    per co-resident program) over the shared handler fleet. Pass the
    plural fields — ``manager_crashes`` (one crash event per Manager),
    ``make_manager_threads(i)`` and ``is_manager_finished(i)`` — and the
    fault plan crashes every Manager each firing (the exp3 discipline,
    applied fleet-wide) while revival and its accounting stay per tenant
    (``manager_revivals_by[i]``). The singular fields remain as the
    one-Manager convenience API and populate index 0.

    Per-tenant fault plans: pass ``plans`` — a mapping of
    *namespace* → :class:`FaultPlan` — together with ``namespaces`` (one
    per Manager, aligned with ``manager_crashes``). A tenant with its
    own plan gets an **independent RNG stream** (seeded from that plan's
    ``seed``) and its own firing interval; its Manager is exempt from
    the shared plan's manager-crash draw. Handler crashes and speed
    changes stay fleet-wide on the shared plan — handlers are a shared
    resource, so only the *Manager-crash* axis is per-tenant. Tenants
    absent from the map fall back to the shared plan. Firing is
    accounted per tenant in ``manager_crash_firings_by`` (revivals were
    already per tenant in ``manager_revivals_by``)."""

    plan: FaultPlan
    manager_crash: threading.Event | None = None
    handler_crashes: list[threading.Event] = field(default_factory=list)
    speed_boxes: list = field(default_factory=list)
    make_manager_thread: Callable[[], threading.Thread] | None = None
    make_handler_thread: Callable[[int], threading.Thread] | None = None
    is_finished: Callable[[], bool] = lambda: False
    #: Plural (multi-manager) API — when set, overrides the singular one.
    manager_crashes: list[threading.Event] | None = None
    make_manager_threads: Callable[[int], threading.Thread] | None = None
    is_manager_finished: Callable[[int], bool] | None = None
    #: Per-tenant fault plans: namespace -> FaultPlan, resolved against
    #: ``namespaces`` (aligned with ``manager_crashes``). Independent
    #: seeds/intervals; missing tenants use the shared ``plan``.
    plans: dict[str, FaultPlan] | None = None
    namespaces: list[str] | None = None
    #: Site-triggered injection: the CrashPointBackend in the
    #: cloud's wrapper stack, if one is stacked. The daemon drains its
    #: firings each tick so deterministic crash points surface in the
    #: same counters interval firings do (``manager_crash_firings_by``
    #: per tenant, ``handler_crash_firings`` for the fleet) — revival
    #: itself needs nothing new, a dead thread is a dead thread.
    crashpoint: object | None = None
    stop_event: threading.Event = field(default_factory=threading.Event)
    manager_revivals: int = 0
    handler_revivals: int = 0
    handler_crash_firings: int = 0
    crashpoint_firings: int = 0
    speed_changes: int = 0
    power_log: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.plan.seed)
        if self.manager_crashes is None:
            self.manager_crashes = [self.manager_crash
                                    if self.manager_crash is not None
                                    else threading.Event()]
            self.manager_crash = self.manager_crashes[0]
        elif self.manager_crash is None and self.manager_crashes:
            self.manager_crash = self.manager_crashes[0]
        if self.make_manager_threads is None:
            mk = self.make_manager_thread
            if mk is not None:
                self.make_manager_threads = lambda _i: mk()
        if self.is_manager_finished is None:
            fin = self.is_finished
            self.is_manager_finished = lambda _i: fin()
        self.n_managers = len(self.manager_crashes)
        self.manager_revivals_by = [0] * self.n_managers
        self.manager_crash_firings_by = [0] * self.n_managers
        self._mthreads: list[threading.Thread | None] = [None] * self.n_managers
        self._hthreads: list[threading.Thread | None] = [None] * len(self.speed_boxes)
        # Resolve per-tenant plans to per-manager slots with their own
        # RNG streams, so one tenant's draws never perturb another's.
        # Misconfiguration is loud: a plan that cannot take effect
        # (missing/short namespaces, unknown key, or per-tenant fields
        # that only the fleet-wide plan honours) must not be silently
        # inert.
        self._tenant_plans: list[FaultPlan | None] = [None] * self.n_managers
        self._tenant_rngs: dict[int, np.random.Generator] = {}
        if self.plans:
            ns_list = self.namespaces or []
            if len(ns_list) != self.n_managers:
                raise ValueError(
                    f"plans= requires namespaces=, one per manager "
                    f"(got {len(ns_list)} namespaces for "
                    f"{self.n_managers} managers)")
            unknown = set(self.plans) - set(ns_list)
            if unknown:
                raise ValueError(
                    f"plans= names unknown namespaces {sorted(unknown)}; "
                    f"supervised namespaces are {ns_list}")
            for ns, p in self.plans.items():
                if p.p_handler_crash or p.p_speed_change:
                    raise ValueError(
                        f"tenant plan for {ns!r} sets p_handler_crash/"
                        f"p_speed_change — handlers and speeds are shared "
                        f"resources governed only by the fleet-wide plan")
            for i, ns in enumerate(ns_list):
                p = self.plans.get(ns)
                if p is not None:
                    self._tenant_plans[i] = p
                    self._tenant_rngs[i] = np.random.default_rng(p.seed)
        # Namespace -> manager index for crash-point firing attribution;
        # a single-tenant cloud has no namespaces list and maps "" -> 0.
        self._ns_index = ({ns: i for i, ns in enumerate(self.namespaces)}
                          if self.namespaces else {"": 0})

    # ------------------------------------------------------------- helpers
    def power(self) -> float:
        """Aggregate compute power = sum of speeds of live handlers."""
        total = 0.0
        for box, th in zip(self.speed_boxes, self._hthreads):
            if th is not None and th.is_alive():
                total += box.get()
        return total

    def attach(self, mthread, hthreads: list[threading.Thread]) -> None:
        """``mthread``: the Manager thread, or the list of them (one per
        co-resident program, aligned with ``manager_crashes``)."""
        if isinstance(mthread, (list, tuple)):
            self._mthreads = list(mthread)
        else:
            self._mthreads = [mthread]
        self._hthreads = list(hthreads)

    # ----------------------------------------------------------------- run
    def _fire_faults(self) -> None:
        """One firing of the *shared* plan: fleet-wide speed/handler
        faults plus manager crashes for every tenant **without** its own
        plan (tenants with one draw on their own stream/interval)."""
        rng = self._rng
        if rng.random() < self.plan.p_speed_change:
            for box in self.speed_boxes:
                box.set(float(rng.choice(self.plan.speed_levels)))
            self.speed_changes += 1
        if rng.random() < self.plan.p_manager_crash:
            for i, ev in enumerate(self.manager_crashes):
                if self._tenant_plans[i] is None:
                    ev.set()
                    self.manager_crash_firings_by[i] += 1
        if rng.random() < self.plan.p_handler_crash:
            for ev in self.handler_crashes:
                ev.set()

    def _fire_tenant_faults(self, i: int) -> None:
        """One firing of tenant ``i``'s own plan (manager-crash axis
        only — handlers and speeds are shared resources)."""
        plan = self._tenant_plans[i]
        if plan is None:
            return
        if self._tenant_rngs[i].random() < plan.p_manager_crash:
            self.manager_crashes[i].set()
            self.manager_crash_firings_by[i] += 1

    def _account_crashpoint(self) -> None:
        """Fold drained CrashPointBackend firings into the interval-
        firing counters: a deterministic site crash on a Manager
        thread counts in that tenant's ``manager_crash_firings_by``
        exactly like a plan draw; handler/executor-side firings count in
        ``handler_crash_firings``. The thread died raising
        ``CrashPointFired``, so ``_revive`` below restores it through
        the ordinary plumbing."""
        cp = self.crashpoint
        if cp is None:
            return
        for f in cp.take_firings():
            self.crashpoint_firings += 1
            if f.get("role") == "manager":
                i = self._ns_index.get(f.get("ns", ""), 0)
                self.manager_crash_firings_by[i] += 1
            else:
                self.handler_crash_firings += 1

    def _revive(self) -> None:
        for i, th in enumerate(self._mthreads):
            if (th is not None and not th.is_alive()
                    and not self.is_manager_finished(i)):
                # A dead Manager that did NOT publish its finished flag is
                # a crash — revive it from its TS cursor (paper §6:
                # "revives failed Manager thread using the latest
                # checkpoint").
                self._mthreads[i] = self.make_manager_threads(i)
                self.manager_revivals += 1
                self.manager_revivals_by[i] += 1
        for i, th in enumerate(self._hthreads):
            if th is not None and not th.is_alive():
                self._hthreads[i] = self.make_handler_thread(i)
                self.handler_revivals += 1

    def threads(self) -> list[threading.Thread]:
        """The *latest* supervised thread incarnations (post-revival) —
        the cloud joins them before its shutdown protocol/leak scan."""
        return [th for th in self._mthreads + self._hthreads
                if th is not None]

    def manager_alive(self, i: int | None = None) -> bool:
        """Is Manager ``i`` alive — or, with no index, are *all* attached
        Managers alive (False before attach)?"""
        if i is not None:
            th = self._mthreads[i]
            return th is not None and th.is_alive()
        return bool(self._mthreads) and all(
            th is not None and th.is_alive() for th in self._mthreads)

    #: Liveness-check quantum — ``Thread.is_alive`` has no event to wait
    #: on, so death detection is inherently periodic; this bounds revival
    #: latency. Everything else (stop, fault deadline) is event-or-deadline.
    LIVENESS_QUANTUM = 0.05

    def run(self) -> None:
        # Tag the daemon thread for the CheckedBackend role checks: its
        # is_manager_finished callback reads ("mstate", "finished").
        from repro_torch.core.space import role
        with role("daemon"):
            self._run()

    def _run(self) -> None:
        t0 = time.monotonic()
        last_fault = t0
        tenant_last = {i: t0 for i in self._tenant_rngs}
        while not self.stop_event.is_set():
            now = time.monotonic()
            next_fault = min(
                [last_fault + self.plan.interval]
                + [tenant_last[i] + self._tenant_plans[i].interval
                   for i in tenant_last])
            # Event-or-deadline wait: wakes immediately on stop, otherwise
            # sleeps until the nearest fault deadline of any plan (capped
            # by the liveness quantum) instead of a fixed cadence.
            if self.stop_event.wait(
                    min(max(next_fault - now, 0.0), self.LIVENESS_QUANTUM)):
                return
            now = time.monotonic()
            if now - last_fault >= self.plan.interval:
                self._fire_faults()
                last_fault = now
            for i in tenant_last:
                if now - tenant_last[i] >= self._tenant_plans[i].interval:
                    self._fire_tenant_faults(i)
                    tenant_last[i] = now
            self._account_crashpoint()
            self._revive()
            self.power_log.append((time.time(), self.power()))
        self._account_crashpoint()   # drain firings raced with stop
