"""ACANCloud — wires TS + Manager(s) + Handlers + MonitorDaemon into one
runnable "custom ACAN cloud" (paper §4, §6) and runs one or several
:class:`~repro_torch.core.program.WorkloadProgram`\\ s under it.

By default the cloud runs the paper's MLP workload
(:class:`~repro_torch.programs.mlp.MLPProgram` built from the CloudConfig
geometry) — the reproduction entry point for the paper's three
experiments::

    cloud = ACANCloud(CloudConfig(...))
    result = cloud.run()
    result.loss_history      # [(step, mse)]          — Fig. 1 / Fig. 3
    result.timeout_history   # [(t, timeout, power)]  — Fig. 2 / Fig. 4

Any other program rides the same fault plane unchanged::

    cloud = ACANCloud(CloudConfig(...), program=MoERoutingProgram(...))

**Multi-tenant mode**: several programs co-resident on *one*
tuple space, served by one shared, reconfigurable handler fleet::

    cloud = ACANCloud(CloudConfig(...),
                      programs=[MLPProgram(...), MoERoutingProgram(...)])
    multi = cloud.run()              # MultiCloudResult
    multi.per_program["mlp"]         # that program's CloudResult

Each program gets its own namespace (its ``name``, de-duplicated), its
own :class:`~repro_torch.core.space.ScopedSpace` view, and its own Manager —
so sweeps, cursors and data-plane keys cannot collide — while the
handler fleet drains tasks across all namespaces in one ``take_batch``
and the MonitorDaemon crashes/revives every Manager plus the fleet under
the same fault plan. Single-program mode uses the default (passthrough)
namespace: keys, ledger and the §6.1 trajectory stay bit-identical to
a single-tenant cloud.

Port of the reference's ``repro/core/cloud.py``: the same code, with
``repro.`` renamed ``repro_torch.``, two changes:

- :class:`CloudConfig` gains ``device`` (``None`` means CUDA, which raises
  without a card), which the default :class:`MLPProgram` runs on;
- ``fleet="process"`` (handlers as worker processes over a tuple-space
  server) raises :class:`NotImplementedError`: the port has no server yet
  (ROADMAP.md §1 item 3.3), so the thread fleet is the only one;
- ``run()`` joins every Manager and Handler thread until it exits (the
  reference waits 2 s for each), so no late gradient of a torch tenant
  launches or writes after it returns.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.faults import FaultPlan, MonitorDaemon
from repro_torch.core.handler import Handler, HandlerTenant, SpeedBox
from repro_torch.core.manager import Manager, ManagerConfig, validate_scheduling
from repro_torch.core.program import WorkloadProgram
from repro_torch.core.space import (ANY, CONTROL_SCHEMAS, DEFAULT_NAMESPACE,
                              TSTimeout, TupleSpace, as_scoped, find_checked,
                              find_crashpoint, find_raced, role)

__all__ = ["ACANCloud", "CloudConfig", "CloudResult", "MultiCloudResult"]


def _default_layers() -> list:
    # Imported lazily: repro_torch.programs.mlp itself imports repro_torch.core
    # submodules, so a module-level import here would be circular.
    from repro_torch.programs.mlp import LayerSpec
    return [LayerSpec(256, 256), LayerSpec(256, 1)]   # paper §6: N=4^4


@dataclass
class CloudConfig:
    layers: list = field(default_factory=_default_layers)
    n_handlers: int = 4                            # paper §6
    epochs: int = 2                                # paper §6.1
    n_samples: int = 100                           # paper §6.1
    task_cap: float = 256.0                        # 4^4
    pouch_size: int = 100
    lr: float = 0.02
    time_scale: float = 2e-6
    initial_timeout: float = 0.25
    fault_plan: FaultPlan = field(default_factory=FaultPlan)
    seed: int = 0
    data_noise: float = 0.0
    wall_limit: float = 600.0                      # hard safety limit (s)
    ts_backend: str | None = None                  # None -> $REPRO_TS_BACKEND
    scheduling: str = "event"                      # "event" | "poll" baseline
    handler_batch: int = 16                        # tasks per take_batch
    history_limit: int = 10_000                    # thist/losshist cap
    adaptive_pouch: bool = False                   # PouchController in Manager
    #: Frontier width of every Manager: how many DAG-independent stages
    #: may be in flight at once (1 = sequential).
    max_inflight_stages: int = 1
    #: Per-tenant fault plans (namespace -> FaultPlan, independent seeds)
    #: for the MonitorDaemon; tenants not in the map stay on fault_plan.
    fault_plans: dict | None = None
    #: Per-tenant handler capacity caps (namespace -> max tasks of that
    #: namespace a handler keeps per drained batch) applied to every
    #: handler of the fleet — see HandlerTenant.max_tasks.
    tenant_caps: dict | None = None
    #: Online cost-model autotuning: handlers report per-op
    #: compute stats to TS, every Manager fits an OnlineCostModel from
    #: them and lets it set frontier width / pouch size / the published
    #: drain-priority backlog, and handlers drain longest-predicted-work-
    #: first and defer ops they are fitted as far slower than the fleet's
    #: best at. Off (default) = the plain scheduling.
    autotune: bool = False
    #: Autotune frontier-width ceiling (see ManagerConfig).
    autotune_max_width: int = 16
    #: Declared-effects admission fence (see ManagerConfig): off =
    #: observe-only (the race sanitizer still records; nothing is
    #: serialized).
    effect_fence: bool = True
    #: Initial per-handler speed ratios (paper §6: e.g. [1, 1, 5, 10]).
    #: Must have exactly ``n_handlers`` entries; None = all 1.0. The
    #: MonitorDaemon's speed re-draws still apply on top.
    handler_speeds: list | None = None
    #: Fleet placement: "thread" (the only one ported). The reference's
    #: "process" (worker processes over a tuple-space server) raises here
    #: until the port has that server (ROADMAP.md §1 item 3.3).
    fleet: str = "thread"
    #: Handler emulated-compute mode: "sleep" (GIL-released, default) or
    #: "spin" (GIL-holding busy loop — the honest baseline for
    #: thread-vs-process comparisons). See Handler.compute_mode.
    compute_mode: str = "sleep"
    #: Where the default MLP program keeps its tensors and runs its tile
    #: products: None means CUDA (raises without a card); "cpu" takes the
    #: plain path.
    device: object = None

    def __post_init__(self) -> None:
        validate_scheduling(self.scheduling)
        if self.fleet not in ("thread", "process"):
            raise ValueError(f"unknown fleet {self.fleet!r} "
                             f"(expected 'thread' | 'process')")
        if self.fleet == "process":
            raise NotImplementedError(
                "fleet='process' needs the tuple-space server and worker "
                "processes, which the port does not have yet (ROADMAP.md "
                "§1 item 3.3); use the thread fleet")
        if self.compute_mode not in ("sleep", "spin"):
            raise ValueError(f"unknown compute_mode {self.compute_mode!r} "
                             f"(expected 'sleep' | 'spin')")
        if self.handler_speeds is not None:
            if len(self.handler_speeds) != self.n_handlers:
                raise ValueError(
                    f"handler_speeds must have n_handlers="
                    f"{self.n_handlers} entries, got "
                    f"{len(self.handler_speeds)}")
            if any(float(s) <= 0.0 for s in self.handler_speeds):
                raise ValueError(
                    f"handler_speeds must be > 0, got {self.handler_speeds}")


@dataclass
class CloudResult:
    loss_history: list          # [(step, loss)]
    timeout_history: list       # [(wallclock, timeout, power)]
    manager_revivals: int       # this program's Manager
    handler_revivals: int       # shared fleet total
    speed_changes: int
    wallclock: float
    ts_stats: dict
    ledger_ok: bool
    pouches: int
    #: Protocol-sanitizer outcome (zeros/empty when the backend
    #: stack carries no CheckedBackend). ``ts_violations`` counts every
    #: recorded protocol violation on the *shared* space;
    #: ``ts_leaks`` is the shutdown orphan scan filtered to this
    #: program's namespace (subject label -> {lifecycle, count, sample}).
    ts_violations: int = 0
    ts_violation_samples: list = field(default_factory=list)
    ts_leaks: dict = field(default_factory=dict)
    #: Autotune surface (empty with autotune off): the fitted
    #: cost-model report of this program's Manager
    #: (op -> handler -> {n, units, secs, unit_secs}) plus fleet-level
    #: counters (tasks deferred by the slow-handler rule).
    cost_report: dict = field(default_factory=dict)
    #: Happens-before race-sanitizer outcome, filtered to this
    #: program's namespace (empty when no RacedBackend is stacked OR the
    #: run was race-free): one formatted line per unordered conflicting
    #: stage pair.
    race_report: list = field(default_factory=list)


@dataclass
class MultiCloudResult:
    """Co-residency outcome: one :class:`CloudResult` per program (keyed
    by namespace) plus the shared-fleet aggregates."""

    per_program: dict[str, CloudResult]
    manager_revivals: int       # all Managers
    handler_revivals: int
    speed_changes: int
    wallclock: float
    ts_stats: dict
    ledger_ok: bool
    #: The whole shared space's sanitizer outcome (all namespaces).
    ts_violations: int = 0
    ts_violation_samples: list = field(default_factory=list)
    ts_leaks: dict = field(default_factory=dict)
    #: The whole shared space's race-sanitizer outcome.
    race_report: list = field(default_factory=list)


class ACANCloud:
    def __init__(self, cfg: CloudConfig,
                 program: WorkloadProgram | None = None,
                 programs: list[WorkloadProgram] | None = None) -> None:
        if program is not None and programs is not None:
            raise ValueError("pass either program= or programs=, not both")
        self.cfg = cfg
        self.multi = programs is not None
        if programs is None:
            if program is None:
                from repro_torch.programs.mlp import MLPProgram
                program = MLPProgram(
                    layers=cfg.layers, epochs=cfg.epochs,
                    n_samples=cfg.n_samples, seed=cfg.seed,
                    data_noise=cfg.data_noise, device=cfg.device)
            programs = [program]
        if not programs:
            raise ValueError("programs= must name at least one program")
        self.programs = list(programs)
        self.program = self.programs[0]            # single-mode convenience
        self.namespaces = self._assign_namespaces()
        # Per-tenant config keys must name actual namespaces — a typo'd
        # (or single-program-mode) key would otherwise be silently inert.
        for label, mapping in (("fault_plans", cfg.fault_plans),
                               ("tenant_caps", cfg.tenant_caps)):
            unknown = set(mapping or {}) - set(self.namespaces)
            if unknown:
                raise ValueError(
                    f"CloudConfig.{label} names unknown namespaces "
                    f"{sorted(unknown)} — this cloud's namespaces are "
                    f"{self.namespaces} (single-program mode uses the "
                    f"default namespace {DEFAULT_NAMESPACE!r})")
        bad_caps = {ns: v for ns, v in (cfg.tenant_caps or {}).items()
                    if int(v) < 1}
        if bad_caps:
            raise ValueError(
                f"CloudConfig.tenant_caps must be >= 1 (a 0 cap is a "
                f"livelock, not a cap — drop the tenant from the fleet "
                f"instead): {bad_caps}")
        self.ts = TupleSpace(backend=cfg.ts_backend)
        self.spaces = [as_scoped(self.ts, ns) for ns in self.namespaces]
        self.stop_event = threading.Event()
        # When the selected backend stack carries a CheckedBackend
        # sanitizer, declare each program's key protocol under its
        # namespace — control-plane schemas plus the program's own. A
        # program whose ``key_schemas()`` is empty opts out: nothing is
        # registered under its namespace, which stays lenient (custom/
        # ad-hoc programs are not flagged).
        checked = find_checked(self.ts.backend)
        if checked is not None:
            for ns, prog in zip(self.namespaces, self.programs):
                schemas = tuple(prog.key_schemas())
                if schemas:
                    checked.registry.register_many(
                        CONTROL_SCHEMAS + schemas, namespace=ns)

    def _assign_namespaces(self) -> list[str]:
        """Single program → the default passthrough namespace (bit-
        identical legacy behaviour); co-residents → one namespace per
        program from its ``name``, de-duplicated by suffix."""
        if not self.multi:
            return [DEFAULT_NAMESPACE]
        out: list[str] = []
        seen: dict[str, int] = {}
        for prog in self.programs:
            base = str(getattr(prog, "name", "program") or "program")
            n = seen.get(base, 0)
            seen[base] = n + 1
            out.append(base if n == 0 else f"{base}.{n}")
        return out

    # ----------------------------------------------------------- factories
    def _make_manager(self, i: int, power_fn) -> tuple[Manager, threading.Thread]:
        mgr = Manager(
            ts=self.spaces[i],
            program=self.programs[i],
            cfg=ManagerConfig(
                task_cap=self.cfg.task_cap, pouch_size=self.cfg.pouch_size,
                initial_timeout=self.cfg.initial_timeout,
                scheduling=self.cfg.scheduling,
                history_limit=self.cfg.history_limit,
                adaptive_pouch=self.cfg.adaptive_pouch,
                max_inflight_stages=self.cfg.max_inflight_stages,
                autotune=self.cfg.autotune,
                autotune_max_width=self.cfg.autotune_max_width,
                effect_fence=self.cfg.effect_fence),
            power_fn=power_fn,
            crash_event=self._manager_crashes[i],
            stop_event=self.stop_event,
        )
        # Keep the latest incarnation: a revival replaces the Manager
        # object, and the cost_report surface must read the live model.
        self._managers[i] = mgr
        suffix = f"-{self.namespaces[i]}" if self.multi else ""
        th = threading.Thread(target=self._manager_body, args=(mgr,),
                              name=f"acan-manager{suffix}", daemon=True)
        th.start()
        return mgr, th

    def _manager_body(self, mgr: Manager) -> None:
        try:
            mgr.run()
        except Exception:
            # Crash (injected or real): thread dies; daemon revives a fresh
            # Manager that resumes from the TS cursor.
            return

    def handler_busy_time(self) -> float:
        """Total emulated compute seconds across the fleet, *including*
        handler incarnations retired by crash/revival — the utilisation
        numerator for benchmarks (busy / (n_handlers x wallclock))."""
        return self._busy_retired + sum(
            h.busy_time for h in self._handlers if h is not None)

    def _make_handler(self, i: int):
        old = self._handlers[i]
        if old is not None:
            # Revival replaces the Handler object; bank the dead
            # incarnation's busy seconds so handler_busy_time() spans the
            # whole run, not just the current fleet generation.
            self._busy_retired += old.busy_time
        if self.multi:
            caps = self.cfg.tenant_caps or {}
            tenants = {ns: HandlerTenant(space, prog.registry,
                                         max_tasks=caps.get(ns))
                       for ns, space, prog in zip(
                           self.namespaces, self.spaces, self.programs)}
            registry = None
        else:
            tenants = None
            registry = self.program.registry
        h = Handler(ts=self.ts, name=f"h{i}", speed=self._speed_boxes[i],
                    capacity=self.cfg.task_cap, lr=self.cfg.lr,
                    time_scale=self.cfg.time_scale,
                    batch_size=self.cfg.handler_batch,
                    scheduling=self.cfg.scheduling,
                    registry=registry,
                    tenants=tenants,
                    autotune=self.cfg.autotune,
                    compute_mode=self.cfg.compute_mode,
                    crash_event=self._handler_crashes[i],
                    stop_event=self.stop_event)
        self._handlers[i] = h
        th = threading.Thread(target=self._handler_body, args=(h,),
                              name=f"acan-{h.name}", daemon=True)
        th.start()
        return th

    @staticmethod
    def _handler_body(h: Handler) -> None:
        try:
            h.run()
        except Exception:
            return

    # ------------------------------------------------------------- results
    def _finished(self, i: int) -> bool:
        return self.spaces[i].try_read(("mstate", "finished")) is not None

    def _ns_leaks(self, report: dict | None, ns: str) -> dict:
        """The shutdown leak scan filtered to one namespace (labels are
        ``ns::subject`` for scoped tenants, bare ``subject`` in the
        default namespace)."""
        if report is None:
            return {}
        out = {}
        for label, entry in report["leaks"].items():
            label_ns = label.split("::", 1)[0] if "::" in label else ""
            if label_ns == ns:
                out[label] = entry
        return out

    def _collect(self, i: int, daemon: MonitorDaemon, wall: float,
                 ts_stats: dict | None = None,
                 ledger_ok: bool | None = None,
                 report: dict | None = None,
                 raced=None) -> CloudResult:
        """One program's result from its namespace view. Every history
        read is guarded: a tuple listed by ``keys()`` can vanish (history
        trimming by a still-running revived Manager) before ``try_read``
        — the unguarded loss loop was a crash window."""
        space = self.spaces[i]
        loss_hist = []
        for k in space.keys(("losshist", ANY)):
            hit = space.try_read(k)
            if hit is not None:
                loss_hist.append((k[1], hit[1]))
        loss_hist.sort()
        # timeout_history holds at most ManagerConfig.history_limit rounds
        # (the newest); the pouch count comes from the per-round-
        # checkpointed ("mstate", "rounds") counter instead, so neither
        # the cap nor a revival can deflate it.
        thist = []
        for k in space.keys(("thist", ANY, ANY)):
            v = space.try_read(k)
            if v is not None:
                thist.append((k[1], v[1]["timeout"], v[1]["power"]))
        thist.sort()
        rounds_hit = space.try_read(("mstate", "rounds"))
        total_rounds = rounds_hit[1] if rounds_hit is not None else 0
        cost_report: dict = {}
        if self.cfg.autotune:
            mgr = self._managers[i]
            model = mgr.cost_model if mgr is not None else None
            cost_report = {
                "ops": model.report() if model is not None else {},
                "fleet_units_per_sec": (model.fleet_units_per_sec()
                                        if model is not None else 0.0),
                "tasks_deferred": sum(h.tasks_deferred
                                      for h in self._handlers
                                      if h is not None),
            }
        return CloudResult(
            loss_history=loss_hist,
            timeout_history=thist,
            manager_revivals=daemon.manager_revivals_by[i],
            handler_revivals=daemon.handler_revivals,
            speed_changes=daemon.speed_changes,
            wallclock=wall,
            ts_stats=self.ts.stats() if ts_stats is None else ts_stats,
            ledger_ok=(self.ts.ledger.verify() if ledger_ok is None
                       else ledger_ok),
            pouches=total_rounds,
            ts_violations=0 if report is None else report["violations"],
            ts_violation_samples=([] if report is None
                                  else list(report["violation_samples"])),
            ts_leaks=self._ns_leaks(report, self.namespaces[i]),
            cost_report=cost_report,
            race_report=([] if raced is None
                         else raced.race_report(self.namespaces[i])),
        )

    # ----------------------------------------------------------------- run
    def run(self) -> CloudResult | MultiCloudResult:
        # The cloud's own TS ops (the blocking finished reads, the result
        # collection) run on the caller's thread — tag it for the
        # CheckedBackend role checks, restoring whatever it had.
        with role("cloud"):
            return self._run()

    def _run(self) -> CloudResult | MultiCloudResult:
        cfg = self.cfg
        n_programs = len(self.programs)
        self._manager_crashes = [threading.Event() for _ in range(n_programs)]
        self._handler_crashes = [threading.Event()
                                 for _ in range(cfg.n_handlers)]
        speeds = cfg.handler_speeds or [1.0] * cfg.n_handlers
        self._speed_boxes = [SpeedBox(float(s)) for s in speeds]
        self._handlers: list[Handler | None] = [None] * cfg.n_handlers
        self._managers: list[Manager | None] = [None] * n_programs
        self._busy_retired = 0.0

        daemon = MonitorDaemon(
            plan=cfg.fault_plan,
            plans=cfg.fault_plans,
            namespaces=self.namespaces,
            manager_crashes=self._manager_crashes,
            handler_crashes=self._handler_crashes,
            speed_boxes=self._speed_boxes,
            make_manager_threads=lambda i: self._make_manager(
                i, lambda: daemon.power())[1],
            make_handler_thread=self._make_handler,
            is_manager_finished=self._finished,
            stop_event=self.stop_event,
            crashpoint=find_crashpoint(self.ts.backend),
        )

        t0 = time.monotonic()
        # Each program seeds its own TS state (dataset, params, config) in
        # Manager.run -> program.setup, before any task is issued.
        mthreads = [self._make_manager(i, lambda: daemon.power())[1]
                    for i in range(n_programs)]
        hthreads = [self._make_handler(i) for i in range(cfg.n_handlers)]
        daemon.attach(mthreads, hthreads)
        dthread = threading.Thread(target=daemon.run, name="acan-daemon",
                                   daemon=True)
        dthread.start()

        # Wait for every Manager to publish its finished flag (revivals
        # keep the jobs alive through crashes): one blocking read per
        # namespace against the shared wall-limit deadline — each
        # completion put wakes us directly. ("poll" scheduling keeps the
        # busy-wait as the benchmark baseline.)
        deadline = t0 + cfg.wall_limit
        if cfg.scheduling == "poll":
            while not all(self._finished(i) for i in range(n_programs)):
                if time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        else:
            for space in self.spaces:
                try:
                    space.read(("mstate", "finished"),
                               timeout=max(deadline - time.monotonic(),
                                           1e-3))
                except TSTimeout:
                    break               # wall limit hit — stop everything
        self.stop_event.set()
        dthread.join(timeout=2.0)
        # Quiesce the fleet before the shutdown protocol scan: a handler
        # (or manager) still mid-write would race the leak snapshot. The
        # daemon holds the *latest* thread incarnations (post-revival).
        # Each is joined until it exits: a handler sees the stop within its
        # take timeout plus the batch it is running, and a torch tenant's
        # gradient task can outlast the reference's 2 s grace — a thread
        # left running would go on launching kernels and writing to the
        # space after run() returned.
        for th in daemon.threads():
            th.join()
        wall = time.monotonic() - t0

        # Verify the shared hash chain and snapshot stats ONCE — the
        # ledger replay is O(total mutations) and identical for every
        # tenant of the shared space.
        ts_stats = self.ts.stats()
        ledger_ok = self.ts.ledger.verify()
        # Shutdown gate: violation tally + LSan-style orphan scan
        # (None when no CheckedBackend is stacked).
        checked = find_checked(self.ts.backend)
        report = checked.protocol_report() if checked is not None else None
        # The happens-before race scan (None when no RacedBackend).
        raced = find_raced(self.ts.backend)
        results = [self._collect(i, daemon, wall, ts_stats, ledger_ok,
                                 report, raced)
                   for i in range(n_programs)]
        if not self.multi:
            return results[0]
        return MultiCloudResult(
            per_program=dict(zip(self.namespaces, results)),
            manager_revivals=daemon.manager_revivals,
            handler_revivals=daemon.handler_revivals,
            speed_changes=daemon.speed_changes,
            wallclock=wall,
            ts_stats=ts_stats,
            ledger_ok=ledger_ok,
            ts_violations=0 if report is None else report["violations"],
            ts_violation_samples=([] if report is None
                                  else list(report["violation_samples"])),
            ts_leaks={} if report is None else dict(report["leaks"]),
            race_report=[] if raced is None else raced.race_report(),
        )
