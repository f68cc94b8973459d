"""The ACAN Manager (paper §4, §5.3) — a program-agnostic **frontier
scheduler** over the stage-dependency DAG.

The Manager schedules a :class:`~repro_torch.core.program.WorkloadProgram`'s
stages as an explicit dependency DAG (``stage_deps``, defaulting to a
linear chain so pre-DAG programs run unchanged):

1. it keeps up to ``ManagerConfig.max_inflight_stages`` *independent*
   stages in flight at once — a stage launches as soon as every
   predecessor's done-counter has closed and its combine has run, so
   handlers that a narrow stage would leave idle pick up work from a
   sibling stage (or, when the program's ``round_overlap`` admits it,
   from the **next round**: the MLP program overlaps ``upd_l`` of sample
   *k* with ``fwd``/``act`` of sample *k+1*);
2. each in-flight stage runs the paper's pouch/timeout discipline: the
   program's prototype tasks are partitioned to the uniform task-size
   cap through the op registry and published as **pouches** (≤
   ``pouch_size`` task descriptions) with a **timeout**;
3. the blocking ``wait_count`` done-counter barriers of all in-flight
   stages are **multiplexed**: the Manager first closes any barrier
   whose count already reached its target, then parks on one stage's
   pattern for a slice of ``barrier_quantum`` (rotating which, so no
   stage starves) — with a single stage in flight this degrades to
   exactly the single-stage sliced blocking barrier, op for op. Upon a
   stage's deadline (or completion) it evaluates completion marks,
   adapts the timeout (:class:`~repro_torch.core.gss.TimeoutController`),
   sweeps untaken task tuples, and re-issues unfinished tasks;
4. when a stage's last task has its mark, the program's ``combine`` hook
   fires *for that stage* (commit hooks stay scoped to per-stage
   completion, so the §5.4 window discipline is untouched by overlap),
   and the **completed-stage frontier** — the base round plus every
   combined ``(round, stage)`` at or ahead of it — is checkpointed into
   TS (``("mstate", "frontier")``, next to the legacy ``cursor``), so a
   crashed Manager revived by the daemon resumes the *exact frontier*
   from TS state alone — the paper's checkpoint-free recovery, now with
   several stages (possibly of two rounds) mid-flight.

Completion marks are keyed by task *content* (not attempt), so a slow
handler finishing attempt k still satisfies attempt k+1 — redundant
execution is harmless by construction. The barrier pattern is derived
from the stage's tasks: every field all tasks agree on is pinned, the
rest are wildcards — and because ``data_id``/``step`` are among the
pinned fields for every built-in program, two overlapping stages (even
of consecutive rounds) can never satisfy each other's counters.

Crash semantics under the blocking barrier: an injected crash set while
the Manager is parked inside ``wait_count`` fires at the next wakeup
(completion, arrival, or the sliced quantum — never later), the thread
dies mid-frontier, and the daemon revives a fresh Manager that re-runs
every not-yet-combined stage from the done marks already in TS (covered
by ``tests/test_acan_training.py`` and ``tests/test_pipeline.py``).

``scheduling="poll"`` preserves the fixed-cadence control plane — kept
as the measured baseline for ``benchmarks/sched_bench.py``, not for
production use; it drives the same frontier, re-scanning each in-flight
pouch every ``poll_quantum``.

Multi-tenancy: the Manager is tenant-agnostic — hand it a
:class:`~repro_torch.core.space.ScopedSpace` and every key it touches (tasks,
done marks, the ``mstate`` cursor/frontier/rounds/epoch/finished
records, the timeout history) lands in that program's namespace, so
several Managers can share one physical space without sweeping each
other's in-flight tasks or clobbering each other's recovery cursors.
Task ids additionally carry a **manager epoch** (persisted in
``("mstate", "epoch")``, bumped on every (re)start): a revived Manager's
fresh ``_task_seq`` can no longer mint a tid that collides with — and
silently overwrites — a leftover task tuple of its dead predecessor.

A verbatim copy of the reference's ``repro/core/manager.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.costmodel import OnlineCostModel
from repro_torch.core.gss import PouchController, TimeoutController
from repro_torch.core.conflict import CommitWindow
from repro_torch.core.program import (FINISH_STAGE, UnknownOp, WorkloadProgram,
                                      effects_conflict)
from repro_torch.core.tasks import TaskDesc, content_key
from repro_torch.core.space import (ANY, FieldIn, TSTimeout, TupleSpace,
                                    find_raced, role, stage_context)

_log = logging.getLogger(__name__)


class ManagerCrash(Exception):
    """Injected fault — the Manager thread dies here."""


#: Valid control-plane modes; the single validator shared by CloudConfig,
#: ManagerConfig and Handler (each branches on the value — a typo must not
#: silently select event mode).
SCHEDULING_MODES = ("event", "poll")


def validate_scheduling(value: str) -> str:
    if value not in SCHEDULING_MODES:
        raise ValueError(
            f"scheduling must be one of {SCHEDULING_MODES}, got {value!r}")
    return value


@dataclass
class ManagerConfig:
    """Control-plane knobs only — *what* runs is the program's business."""

    task_cap: float = 256.0          # 4^4, paper §6
    pouch_size: int = 100            # paper §6
    initial_timeout: float = 0.25
    poll_quantum: float = 0.004      # poll-mode only: done-scan cadence
    strict_timeout: bool = False     # True = always wait the full timeout
    scheduling: str = "event"        # "event" (blocking barrier) | "poll"
    #: Upper bound on one blocking slice of a pouch barrier. Barriers are
    #: event-driven (completion arrivals end them immediately); this only
    #: bounds (a) how stale a pending crash/stop event can go unnoticed
    #: while the Manager is parked, and (b) how long a *sibling* in-flight
    #: stage's completion can go unnoticed while the Manager is parked on
    #: another stage's pattern (the slice is divided among in-flight
    #: stages, so the bound holds for the whole frontier).
    barrier_quantum: float = 0.05
    history_limit: int = 10_000      # cap on ("thist",...)/("losshist",...)
    #: Adapt the pouch size per round through PouchController (ROADMAP
    #: "Adaptive pouch sizing"): grow on fully-completed well-utilised
    #: rounds, shrink on timeouts. ``pouch_size`` is the starting point.
    adaptive_pouch: bool = False
    #: Frontier width: how many DAG-independent stages may be in flight at
    #: once. 1 (default) executes the DAG sequentially in ``stage_names``
    #: order — bit-identical to the sequential scheduler on any program and
    #: to the pipelined run on any program whose combines are pure
    #: functions of complete stage results (all built-ins).
    max_inflight_stages: int = 1
    #: Online cost-model autotuning: fit per-op latencies from the
    #: handlers' ``("cstats", op, handler)`` reports and let the fitted
    #: model set the frontier width (overlap headroom), the pouch size
    #: (predicted drain time instead of a fixed count), and the published
    #: backlog row handlers drain by priority. Off (the default) leaves
    #: every scheduling decision byte-identical to the static knobs.
    autotune: bool = False
    #: Autotune-mode frontier-width ceiling (the static
    #: ``max_inflight_stages`` is the fallback until handlers report).
    autotune_max_width: int = 16
    #: Autotune-mode pouch target: aim each pouch at this many seconds of
    #: predicted fleet drain time.
    autotune_pouch_secs: float = 0.2
    #: Declared-effects admission fence: refuse frontier overlap to
    #: a ready stage whose declared ``stage_effects`` conflict with an
    #: in-flight stage's (the pair is serialized with one warning).
    #: Programs that do not declare effects are unaffected either way.
    #: ``False`` = observe-only: the scheduler overlaps exactly as before
    #: and a stacked RacedBackend still records any resulting race.
    effect_fence: bool = True

    def __post_init__(self) -> None:
        validate_scheduling(self.scheduling)
        if self.max_inflight_stages < 1:
            raise ValueError("max_inflight_stages must be >= 1, got "
                             f"{self.max_inflight_stages}")
        if self.autotune_max_width < 1:
            raise ValueError("autotune_max_width must be >= 1, got "
                             f"{self.autotune_max_width}")


@dataclass
class _StageRun:
    """One in-flight stage's pouch state machine."""

    rnd: int
    name: str
    order: int                       # index in stage_names(rnd): priority
    tasks: list                     # partitioned TaskDescs of the stage
    done_pat: tuple = ()
    issued: set = field(default_factory=set)    # content keys ever pouched
    tids: set = field(default_factory=set)      # tids this stage issued
    units_left: float = 0.0          # predicted cost units still pending
    # per-pouch barrier state
    pouch: list = field(default_factory=list)
    target: int = 0
    t0: float = 0.0
    deadline: float = 0.0
    waiting: bool = False            # pouch issued, barrier open
    met_early: bool = False          # barrier met under strict_timeout


@dataclass
class Manager:
    ts: TupleSpace
    program: WorkloadProgram
    cfg: ManagerConfig = field(default_factory=ManagerConfig)
    power_fn: Callable[[], float] = lambda: 0.0
    crash_event: threading.Event = field(default_factory=threading.Event)
    stop_event: threading.Event = field(default_factory=threading.Event)
    controller: TimeoutController = field(default_factory=TimeoutController)
    pouch_ctl: PouchController = field(default_factory=PouchController)
    window: CommitWindow = field(default_factory=CommitWindow)
    #: Fitted online cost model (autotune mode only; None otherwise).
    #: Created in ``_run`` so a revived Manager re-fits from the
    #: ``("cstats", ...)`` rows its predecessor's handlers left in TS.
    cost_model: OnlineCostModel | None = None
    rounds: int = 0                  # pouch rounds (monotonic via TS)
    reissued: int = 0                # tasks re-published after a timeout
    epoch: int = 0                   # (re)start count, persisted in TS
    _task_seq: int = 0

    def __post_init__(self) -> None:
        self.controller.timeout = self.cfg.initial_timeout
        self.controller.history_limit = self.cfg.history_limit
        self.pouch_ctl.pouch = self.cfg.pouch_size
        self.pouch_ctl.min_pouch = min(self.pouch_ctl.min_pouch,
                                       self.cfg.pouch_size)
        self._base = 0                           # lowest unfinished round
        self._swept = -1                         # highest round swept clean
        self._completed: set[tuple[int, str]] = set()
        self._inflight: dict[tuple[int, str], _StageRun] = {}
        self._names_cache: dict[int, list[str]] = {}
        self._deps_cache: dict[int, dict] = {}
        self._wait_rr = 0                        # barrier park rotation
        # EMA of per-stage task counts — recommend_width's denominator.
        self._stage_tasks_ema = 0.0
        # Declared-effects admission fence: per-round effect cache,
        # the stage pairs already warned about, and the RacedBackend (if
        # stacked) that stage lifecycle events are announced to.
        self._effects_cache: dict[int, dict | None] = {}
        self._fence_warned: set[tuple[str, str]] = set()
        self._raced = None
        self._ns = ""

    # ------------------------------------------------------------ lifecycle
    def _bump_epoch(self) -> None:
        """Increment the persisted manager epoch — called once per
        (re)start, before any task is issued, so every tid this Manager
        mints is distinct from every tid of its dead predecessors."""
        hit = self.ts.try_read(("mstate", "epoch"))
        self.epoch = (hit[1] if hit is not None else 0) + 1
        self.ts.delete(("mstate", "epoch"))
        self.ts.put(("mstate", "epoch"), self.epoch)

    def _checkpoint(self) -> None:
        """Persist the completed-stage frontier plus controller state.

        ``("mstate", "frontier")`` holds the resume point proper (base
        round + combined stages at/ahead of it); ``("mstate", "cursor")``
        keeps the legacy ``{round, stage_idx}`` shape (pointing at the
        first *uncombined* stage of the base round) for external readers,
        and carries the timeout/pouch/window state as before."""
        names = (self._names(self._base)
                 if self._base < self.program.n_rounds() else [])
        idx = next((i for i, n in enumerate(names)
                    if (self._base, n) not in self._completed), len(names))
        self.ts.delete(("mstate", "cursor"))
        self.ts.put(("mstate", "cursor"), {
            "round": self._base, "stage_idx": idx,
            "timeout": self.controller.timeout,
            "pouch": self.pouch_ctl.pouch,
            "window": self.window.to_state(),
        })
        self.ts.delete(("mstate", "frontier"))
        self.ts.put(("mstate", "frontier"), {
            "base": self._base,
            # Highest round whose finish_round cleanup pass COMPLETED —
            # a revived Manager re-sweeps every finished round above it
            # (the pass is pure idempotent deletes), so a crash inside
            # cleanup can never strand a finished round's tuples.
            "swept": self._swept,
            "completed": sorted([r, n] for r, n in self._completed),
        })

    def _load_frontier(self) -> None:
        hit = self.ts.try_read(("mstate", "cursor"))
        if hit is not None:
            st = hit[1]
            self.controller.timeout = st.get("timeout",
                                             self.controller.timeout)
            self.pouch_ctl.pouch = st.get("pouch", self.pouch_ctl.pouch)
            self.window = CommitWindow.from_state(st.get("window", {}))
            # This is a *revival*: the pouch the predecessor persisted may
            # have collapsed under crash-induced barrier timeouts (a
            # crashed pouch reads as a timeout) — clamp it back up and
            # forgive the first post-revival shortfall.
            if self.cfg.adaptive_pouch:
                self.pouch_ctl.revive(self.cfg.pouch_size)
            # Fallback base for TS state written before the frontier key
            # existed: resume at the cursor round.
            self._base = int(st.get("round", 0))
        # Rounds are checkpointed per pouch round (not per stage, which
        # would lose straggler rounds of a crashed stage) so the count
        # stays monotonic across revivals — CloudResult.pouches reads it.
        rounds = self.ts.try_read(("mstate", "rounds"))
        self.rounds = rounds[1] if rounds is not None else 0
        fr = self.ts.try_read(("mstate", "frontier"))
        if fr is not None:
            self._base = int(fr[1].get("base", self._base))
            self._completed = {(int(r), str(n))
                               for r, n in fr[1].get("completed", [])}
        # Checkpoints from before the swept cursor existed read as fully
        # swept — the legacy behaviour.
        self._swept = (int(fr[1].get("swept", self._base - 1))
                       if fr is not None else self._base - 1)

    def _maybe_crash(self) -> None:
        if self.crash_event.is_set():
            self.crash_event.clear()
            raise ManagerCrash()

    # ----------------------------------------------------------- DAG access
    def _names(self, rnd: int) -> list[str]:
        names = self._names_cache.get(rnd)
        if names is None:
            names = list(self.program.stage_names(rnd))
            self._names_cache[rnd] = names
        return names

    def _deps(self, rnd: int) -> dict[str, list[tuple[str, int]]]:
        """Round ``rnd``'s deps, normalized to ``name -> [(name, round)]``
        with every edge validated against the declaring rounds' stage
        lists (a typo'd dep must fail loudly, not deadlock quietly)."""
        cached = self._deps_cache.get(rnd)
        if cached is not None:
            return cached
        names = self._names(rnd)
        nameset = set(names)
        raw = self.program.stage_deps(rnd)
        unknown = set(raw) - nameset
        if unknown:
            raise ValueError(
                f"stage_deps({rnd}) names unknown stages {sorted(unknown)}")
        out: dict[str, list[tuple[str, int]]] = {}
        for name in names:
            edges: list[tuple[str, int]] = []
            for dep in raw.get(name, ()):  # absent stage = no predecessors
                if isinstance(dep, str):
                    dname, delta = dep, 0
                else:
                    dname, delta = dep
                    delta = int(delta)
                if delta > 0:
                    raise ValueError(
                        f"stage_deps({rnd})[{name!r}]: dep {dname!r} has "
                        f"delta {delta} — deps must point backwards")
                if delta == 0 and dname == name:
                    raise ValueError(
                        f"stage_deps({rnd})[{name!r}] depends on itself")
                drnd = rnd + delta
                if drnd < 0:
                    continue               # before round 0: satisfied
                if delta != 0 and drnd < self._base:
                    # Backward edge into an already-finished round: the
                    # dep is permanently satisfied (base only advances),
                    # so drop it — validating it would re-populate the
                    # names cache for a round whose eviction already ran,
                    # leaking one entry per round on long jobs.
                    continue
                dnames = nameset if delta == 0 else set(self._names(drnd))
                if dname not in dnames:
                    raise ValueError(
                        f"stage_deps({rnd})[{name!r}]: dep {dname!r} not a "
                        f"stage of round {drnd}")
                edges.append((dname, drnd))
            out[name] = edges
        self._deps_cache[rnd] = out
        return out

    def _deps_met(self, rnd: int, name: str) -> bool:
        for dname, drnd in self._deps(rnd)[name]:
            if drnd < self._base:
                continue                   # that round fully finished
            if (drnd, dname) not in self._completed:
                return False
        return True

    def _effects(self, rnd: int) -> dict | None:
        """Round ``rnd``'s declared per-stage effects (None = the program
        opted out and the admission fence is off)."""
        if rnd not in self._effects_cache:
            self._effects_cache[rnd] = self.program.stage_effects(rnd)
        return self._effects_cache[rnd]

    def _fence_blocker(self, rnd: int, name: str):
        """The in-flight stage (if any) whose declared effects conflict
        with candidate ``(rnd, name)``'s — the admission fence.

        The frontier scheduler's soundness rests on DAG-concurrent stages
        not interfering; when a program *declares* its effects, a
        conflicting pair is refused overlap here (the candidate is
        deferred until the in-flight stage combines — serialized, never
        dropped) instead of racing on real tuples."""
        if not self.cfg.effect_fence:
            return None
        eff = self._effects(rnd)
        if eff is None:
            return None
        mine = eff.get(name, ())
        for (orn, onm) in self._inflight:
            oeff = self._effects(orn)
            if oeff is None:
                continue
            for a in mine:
                for b in oeff.get(onm, ()):
                    kind = effects_conflict(a, b)
                    if kind is not None:
                        return (orn, onm, kind, a, b)
        return None

    def _next_ready(self, n_rounds: int, overlap: int):
        """Lowest-priority ``(rnd, name, order)`` whose deps are all
        combined — deterministic, so ``max_inflight_stages=1`` replays
        the sequential ``stage_names`` order exactly."""
        for rnd in range(self._base, min(self._base + overlap, n_rounds)):
            for order, name in enumerate(self._names(rnd)):
                key = (rnd, name)
                if key in self._completed or key in self._inflight:
                    continue
                if not self._deps_met(rnd, name):
                    continue
                blk = self._fence_blocker(rnd, name)
                if blk is not None:
                    orn, onm, kind, a, b = blk
                    pair = (name, onm) if name <= onm else (onm, name)
                    if pair not in self._fence_warned:
                        self._fence_warned.add(pair)
                        _log.warning(
                            "admission fence: stage %r (round %d) declares "
                            "%s-conflicting effects with in-flight stage %r "
                            "(round %d) — %s vs %s; serializing the pair "
                            "(declare a stage_deps edge or disjoint pins "
                            "to overlap them)",
                            name, rnd, kind, onm, orn, a, b)
                    continue
                return rnd, name, order
        return None

    # ------------------------------------------------------------- dispatch
    def _issue(self, tasks: list[TaskDesc]) -> list[str]:
        # The epoch prefix closes the revived-Manager collision window: a
        # fresh Manager restarts _task_seq at 0, and without the epoch a
        # re-minted tid would overwrite (put = replace) a distinct leftover
        # task tuple of the dead predecessor, losing that task until the
        # next timeout sweep. (The tid is already namespace-scoped when
        # self.ts is a ScopedSpace.)
        items, tids = [], []
        for t in tasks:
            self._task_seq += 1
            tid = f"e{self.epoch}t{self._task_seq}"
            tids.append(tid)
            items.append((("task", tid), t.to_wire()))
        # Task tuples: a crash mid-issue strands the batch's prefix, and
        # the untaken-task sweep + timeout re-issue reclaim it (the key
        # literal hides behind iter(), hence the pragma).
        self.ts.put_many(iter(items))  # crash: sweep-covered
        return tids

    def _pouch_size(self, pending: list[TaskDesc] | None = None) -> int:
        """Next pouch's size. Autotune mode sizes by *predicted drain
        time* — take leading pending tasks until their summed registry
        cost would keep the fitted fleet busy ``autotune_pouch_secs`` —
        falling back to the static knobs until handlers have reported
        (cold start) or when a task's op has no registered cost."""
        if (self.cfg.autotune and self.cost_model is not None
                and pending is not None):
            rate = self.cost_model.fleet_units_per_sec()
            if rate > 0.0:
                try:
                    costs = [self.program.registry.cost(t)
                             for t in pending[: self.pouch_ctl.max_pouch]]
                except UnknownOp:
                    costs = []
                if costs:
                    return self.pouch_ctl.cost_target(
                        costs, rate, self.cfg.autotune_pouch_secs)
        return (self.pouch_ctl.pouch if self.cfg.adaptive_pouch
                else self.cfg.pouch_size)

    def _frontier_width(self) -> int:
        """How many stages may be in flight right now. Static
        ``max_inflight_stages`` unless autotuning, in which case the
        fitted model may *widen* the frontier (narrow stages on a
        reporting fleet need more overlap to keep every handler fed) up
        to ``autotune_max_width``. The configured width is the floor —
        narrowing below it would serialise stages the operator asked to
        overlap, a strict regression; before any handler reports, the
        static width stands."""
        if not self.cfg.autotune or self.cost_model is None:
            return self.cfg.max_inflight_stages
        w = self.cost_model.recommend_width(
            max(self._stage_tasks_ema, 1.0),
            lo=self.cfg.max_inflight_stages,
            hi=max(self.cfg.autotune_max_width,
                   self.cfg.max_inflight_stages))
        return self.cfg.max_inflight_stages if w is None else w

    def _publish_backlog(self) -> None:
        """Refresh the model from the handlers' cstats rows, then publish
        this tenant's predicted remaining drain time — the cross-tenant
        priority handlers sort drained batches by (longest-predicted-
        work-first)."""
        model = self.cost_model
        if model is None:
            return
        model.refresh(self.ts)
        units = sum(r.units_left for r in self._inflight.values())
        rate = model.fleet_units_per_sec()
        secs = (units / rate if rate > 0.0
                else units * model.prior_unit_secs)
        model.publish_backlog(self.ts, secs)

    def _sweep_untaken(self, run: _StageRun | None = None) -> int:
        """Remove task tuples nobody took before re-issuing stragglers.

        With one stage in flight the whole (namespace-confined) task
        subject is this stage's — one widened delete.
        With a frontier of several stages, sweep only the tids *this*
        stage issued (a predicate on the tid field — still one delete
        call), so a timing-out stage cannot yank a sibling's untaken
        pouch out from under its barrier."""
        if run is None or len(self._inflight) <= 1:
            return self.ts.delete(("task", ANY))
        # FieldIn, not a lambda: the pattern must survive the remote
        # backend's frame encoder.
        return self.ts.delete(("task", FieldIn(run.tids)))

    @staticmethod
    def _stage_done_pattern(tasks: list[TaskDesc]) -> tuple:
        """Done-mark pattern covering every task of this stage: fields all
        tasks agree on are pinned, the rest are wildcards. Regular stages
        pin the whole (op, layer, data_id, step) prefix; non-regular
        stages (e.g. the MoE route stage spanning block slices) stay
        pinned by op + data_id + step, which no other stage of the round
        — nor the same stage of an overlapped round — shares."""
        heads = {(t.op, t.layer, t.data_id, t.step) for t in tasks}
        pinned = tuple(
            vals[0] if len(set(vals)) == 1 else ANY
            for vals in zip(*heads))
        return ("done",) + pinned + (ANY, ANY, ANY, ANY)

    def _pending(self, tasks: list[TaskDesc],
                 pat: tuple | None = None) -> list[TaskDesc]:
        """Tasks (all from ONE stage) without a done mark. One ``keys()``
        scan over the stage pattern replaces the seed's N concrete
        ``try_read`` calls per evaluation. ``pat`` may supply the stage's
        cached pattern (any superset pattern is correct — membership is
        checked per exact content key)."""
        if not tasks:
            return []
        done = set(self.ts.keys(pat or self._stage_done_pattern(tasks)))
        return [t for t in tasks
                if ("done",) + content_key(t) not in done]

    def _pending_polled(self, tasks: list[TaskDesc]) -> list[TaskDesc]:
        """Seed-style pending scan: one concrete try_read per task."""
        return [t for t in tasks
                if self.ts.try_read(("done",) + content_key(t)) is None]

    def _scan_pending(self, tasks: list[TaskDesc],
                      pat: tuple | None = None) -> list[TaskDesc]:
        return (self._pending(tasks, pat) if self.cfg.scheduling == "event"
                else self._pending_polled(tasks))

    # ------------------------------------------------- pouch round lifecycle
    def _start_pouch(self, run: _StageRun) -> None:
        """Evaluate the stage; complete it, or issue its next pouch."""
        pending = self._scan_pending(run.tasks, run.done_pat)
        if not pending:
            self._complete_stage(run)
            return
        if self.cfg.autotune:
            try:
                run.units_left = sum(self.program.registry.cost(t)
                                     for t in pending)
            except UnknownOp:
                run.units_left = 0.0
        pouch = pending[: self._pouch_size(pending)]
        run.tids.update(self._issue(pouch))
        # Re-issues are tasks published a second time (timeout
        # stragglers) — NOT later pouches of a stage wider than
        # pouch_size, whose tasks are being published for the first time.
        self.reissued += sum(
            1 for t in pouch if content_key(t) in run.issued)
        run.issued.update(content_key(t) for t in pouch)
        # Barrier target: stage done-marks already present + this pouch.
        # In-flight stragglers from a previous round are always at the
        # front of `pending` (order is preserved), hence inside this
        # pouch — the stage count cannot overshoot the target.
        run.pouch = pouch
        run.target = (len(run.tasks) - len(pending)) + len(pouch)
        run.t0 = time.monotonic()
        run.deadline = run.t0 + self.controller.timeout
        run.waiting = True
        run.met_early = False

    def _finish_pouch(self, run: _StageRun, barrier_met: bool) -> None:
        """One pouch round ended (barrier met or deadline): adapt the
        timeout, record history, sweep, leave the stage re-evaluable."""
        # A crash that landed during the final slice fires here — mid-
        # frontier, resumed from the persisted frontier by the revived
        # Manager.
        self._maybe_crash()
        elapsed = time.monotonic() - run.t0
        # Barrier reached == stage count hit the target == every pouch
        # task has its mark (the count cannot overshoot, see above) — no
        # need to re-scan. Poll mode re-scans, as the baseline always did.
        if barrier_met and self.cfg.scheduling == "event":
            still: list[TaskDesc] = []
        else:
            still = self._scan_pending(run.pouch, run.done_pat)
        done_frac = 1.0 - len(still) / max(len(run.pouch), 1)
        self.controller.update(not still, elapsed, done_frac)
        if self.cfg.adaptive_pouch:
            # Utilisation proxy: how full this pouch ran relative to the
            # controller's current size — a stage's last pouch is usually
            # a remainder and must not read as underutilisation.
            self.pouch_ctl.update(
                not still, len(run.pouch) / max(self.pouch_ctl.pouch, 1))
        self.rounds += 1
        self.ts.delete(("mstate", "rounds"))
        self.ts.put(("mstate", "rounds"), self.rounds)
        self.ts.put(("thist", time.time(), self.rounds),
                    {"timeout": self.controller.timeout,
                     "power": self.power_fn(),
                     "elapsed": elapsed,
                     "done_frac": done_frac})
        # Cap timeout history by live count, not round numbers — a crash
        # landing between the increment and its checkpoint can re-number
        # one round, so counting is the robust trim criterion.
        limit = self.cfg.history_limit
        if limit:
            extra = self.ts.count(("thist", ANY, ANY)) - limit
            if extra > 0:
                for k in sorted(self.ts.keys(("thist", ANY, ANY)))[:extra]:
                    self.ts.delete(k)
        self._sweep_untaken(run)
        run.waiting = False
        run.met_early = False
        if self.cfg.autotune:
            self._publish_backlog()

    def _complete_stage(self, run: _StageRun) -> None:
        """Every task of the stage has its mark: combine, advance the
        frontier (running ``finish_round`` for each round whose stages
        are all combined — rounds finish strictly in order), checkpoint."""
        self._inflight.pop((run.rnd, run.name), None)
        # Stage-boundary combine ("the Manager updates the relevant TS
        # entries as a checkpoint", §5.3) — scoped to THIS stage's
        # completion, wherever the rest of the frontier is.
        with stage_context(run.rnd, run.name):
            self.program.combine(self.ts, run.rnd, run.name, self)
        if self._raced is not None:
            self._raced.stage_complete(self._ns, run.rnd, run.name)
        self._completed.add((run.rnd, run.name))
        prog = self.program
        n_rounds = prog.n_rounds()
        finished: list[int] = []
        while (self._base < n_rounds
               and all((self._base, n) in self._completed
                       for n in self._names(self._base))):
            for n in self._names(self._base):
                self._completed.discard((self._base, n))
            self._names_cache.pop(self._base, None)
            self._deps_cache.pop(self._base, None)
            self._effects_cache.pop(self._base, None)
            finished.append(self._base)
            self._base += 1
        # Frontier FIRST, cleanup after (crash sweep). The old
        # pre-checkpoint cleanup pass meant a Manager crash mid-
        # finish_round revived into a frontier that still wanted the
        # round's last stage — whose combine inputs the interrupted pass
        # had already deleted (re-issue loop forever). With the advance
        # durable before the first delete, a crash anywhere in the pass
        # revives with ``swept`` behind ``base`` and the startup
        # re-sweep re-runs finish_round (pure idempotent deletes).
        #
        # The straggler-write argument carries over: a handler that
        # passed its pre-execute fence before the frontier advanced
        # either lands its write before this pass (deleted here) or
        # after it — in which case the handler's own post-write fence
        # re-read observes the already-persisted frontier and undoes the
        # write. Both orderings leave the space clean.
        self._checkpoint()
        for r in finished:
            # Round cleanup runs as the pseudo-stage FINISH_STAGE — it
            # has declared effects (wide deletes) like any other stage
            # and participates in the happens-before order.
            if self._raced is not None:
                self._raced.stage_begin(self._ns, r, FINISH_STAGE)
            with stage_context(r, FINISH_STAGE):
                prog.finish_round(self.ts, r)
            if self._raced is not None:
                self._raced.stage_complete(self._ns, r, FINISH_STAGE)
        if finished:
            self._swept = self._base - 1   # rides the next checkpoint

    # -------------------------------------------------------- the scheduler
    def _priority(self) -> list[_StageRun]:
        return sorted(self._inflight.values(),
                      key=lambda r: (r.rnd, r.order))

    def _launch_ready(self, n_rounds: int) -> bool:
        """Fill the frontier with ready stages (deps combined), lowest
        ``(round, stage_names order)`` first. Zero-task stages are pure
        combine barriers — completed inline, never occupying a slot."""
        launched = False
        overlap = max(1, int(self.program.round_overlap()))
        while len(self._inflight) < self._frontier_width():
            nxt = self._next_ready(n_rounds, overlap)
            if nxt is None:
                break
            rnd, name, order = nxt
            # Announce the launch BEFORE stage_tasks runs: its TS reads
            # belong to this stage, and the happens-before order must
            # date the stage from its admission decision.
            if self._raced is not None:
                self._raced.stage_begin(self._ns, rnd, name)
            tasks: list[TaskDesc] = []
            with stage_context(rnd, name):
                for proto in self.program.stage_tasks(self.ts, rnd, name):
                    tasks.extend(self.program.registry.partition(
                        proto, self.cfg.task_cap))
            run = _StageRun(rnd=rnd, name=name, order=order, tasks=tasks)
            launched = True
            if not tasks:
                self._complete_stage(run)
                continue
            if self.cfg.autotune:
                # Zero-task barrier stages never occupy a slot, so they
                # must not drag recommend_width's denominator down.
                n = float(len(tasks))
                self._stage_tasks_ema = (
                    n if self._stage_tasks_ema <= 0.0
                    else 0.7 * self._stage_tasks_ema + 0.3 * n)
            run.done_pat = self._stage_done_pattern(tasks)
            if self._raced is not None:
                # The pinned (op, layer, data_id, step) signature executor
                # groups are attributed by — same fields the done-mark
                # barrier pins, so attribution can never cross stages that
                # the barrier itself can tell apart.
                self._raced.stage_sig(self._ns, rnd, name, run.done_pat[1:5])
            self._inflight[(rnd, name)] = run
        return launched

    def _event_tick(self) -> None:
        """Multiplex the in-flight blocking barriers: close any barrier
        already met, evaluate any stage past its GSS deadline, else park
        on one stage's pattern (rotating) for a slice of
        ``barrier_quantum`` — a completion arrival on that stage ends the
        wait immediately; a sibling's completion is noticed within one
        slice. With one stage in flight this is op-for-op the sequential
        sliced barrier (no extra counts on the fast path)."""
        runs = [r for r in self._priority() if r.waiting]
        if not runs:
            return
        now = time.monotonic()
        if len(runs) > 1:
            # We can only park on one pattern — close already-met sibling
            # barriers non-blockingly first so no completion waits a slice.
            for run in runs:
                if (not run.met_early
                        and self.ts.count(run.done_pat) >= run.target):
                    if self.cfg.strict_timeout:
                        run.met_early = True
                    else:
                        return self._finish_pouch(run, barrier_met=True)
        for run in runs:
            if now >= run.deadline:
                return self._finish_pouch(run, barrier_met=run.met_early)
        candidates = [r for r in runs if not r.met_early]
        horizon = min(r.deadline for r in runs) - now
        if not candidates:
            # strict_timeout with every open barrier met: sleep out the
            # nearest deadline (the paper's "always wait the timeout").
            self.stop_event.wait(min(horizon, self.cfg.barrier_quantum))
            return
        run = candidates[self._wait_rr % len(candidates)]
        self._wait_rr += 1
        park = min(horizon, self.cfg.barrier_quantum / len(candidates))
        try:
            self.ts.wait_count(run.done_pat, run.target,
                               timeout=max(park, 1e-4))
        except TSTimeout:
            return
        if self.cfg.strict_timeout:
            run.met_early = True
        else:
            self._finish_pouch(run, barrier_met=True)

    def _poll_tick(self) -> None:
        """The fixed-cadence baseline: sleep one ``poll_quantum``, then
        re-scan each in-flight pouch (one concrete try_read per task, as
        the seed loop did) and evaluate the first stage that completed or
        timed out."""
        time.sleep(self.cfg.poll_quantum)
        self._maybe_crash()
        now = time.monotonic()
        for run in self._priority():
            if not run.waiting:
                continue
            still = self._pending_polled(run.pouch)
            if (not still and not self.cfg.strict_timeout) \
                    or now >= run.deadline:
                self._finish_pouch(run, barrier_met=False)
                return

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        # The role tag is thread-local; Manager.run() may execute on a
        # borrowed thread (step_runner drives it on the caller's), so the
        # context manager form restores whatever role that thread had.
        with role("manager"):
            self._run()

    def _run(self) -> None:
        prog = self.program
        # Race-sanitizer hookup: if a RacedBackend is stacked under
        # this space, announce the stage lifecycle to it. ScopedSpace
        # carries the tenant namespace; a bare TupleSpace runs in "".
        self._raced = find_raced(getattr(self.ts, "backend", None))
        self._ns = getattr(self.ts, "namespace", "")
        prog.setup(self.ts)
        self._bump_epoch()
        self._load_frontier()
        # Re-run cleanup for rounds the frontier finished but whose
        # finish_round pass a crash interrupted (pure deletes, safe to
        # repeat). No raced stage_begin: this is the same logical cleanup
        # re-run, not a fresh unordered access (see _complete_stage).
        for r in range(self._swept + 1, self._base):
            with stage_context(r, FINISH_STAGE):
                prog.finish_round(self.ts, r)
        self._swept = self._base - 1
        if self.cfg.autotune:
            self.cost_model = OnlineCostModel(registry=prog.registry)
            # A revived Manager inherits its predecessor's fleet fit from
            # the persistent ("cstats", op, handler) rows straight away.
            self.cost_model.refresh(self.ts)
        n_rounds = prog.n_rounds()
        self._inflight = {}
        # Reclaim every untaken task tuple of dead predecessor epochs up
        # front (nothing of OUR epoch is issued yet, and the subject is
        # namespace-confined). The per-stage sweeps below are scoped to
        # each stage's own tids whenever the frontier holds siblings, so
        # without this a predecessor's orphans could outlive the whole
        # job and be executed arbitrarily late.
        self._sweep_untaken()
        # The frontier (possibly just-loaded) must be visible before the
        # first barrier parks: a crash inside the very first pouch wait
        # still finds a resume point in TS.
        self._checkpoint()
        while not self.stop_event.is_set():
            self._maybe_crash()
            if self._base >= n_rounds and not self._inflight:
                break
            launched = self._launch_ready(n_rounds)
            if not self._inflight:
                if self._base >= n_rounds:
                    break
                if launched:
                    continue           # inline-completed stages moved us
                raise RuntimeError(
                    f"stage-DAG deadlock: round {self._base} has no ready "
                    f"stage (completed={sorted(self._completed)}) — check "
                    f"{type(prog).__name__}.stage_deps for a cycle")
            # Re-evaluate stages whose pouch round ended: complete them or
            # issue the next pouch. A completion can unblock dependents —
            # return to the launch loop before blocking again.
            progressed = False
            for run in self._priority():
                if not run.waiting:
                    self._start_pouch(run)
                    if (run.rnd, run.name) not in self._inflight:
                        progressed = True
                        break
            if progressed:
                continue
            if self.stop_event.is_set():
                # Frontier aborted (wall limit / shutdown): combining
                # partial results would record bogus state (e.g. a loss
                # scatter-added from the few tiles that landed). The
                # frontier still omits the in-flight stages, so a revived
                # Manager redoes them from the done marks.
                return
            if self.cfg.scheduling == "poll":
                self._poll_tick()
            else:
                self._event_tick()
        if self.stop_event.is_set():
            return
        # Last reclaim before declaring completion: a handler "store"
        # re-put can land a task tuple back *after* the final stage's
        # sweep ran (the re-put races the barrier close). The job is
        # over — nothing of ours is in flight — so the widened
        # namespace-confined sweep is safe and leaves the task subject
        # empty at shutdown (leak gate).
        self._sweep_untaken()
        self.ts.put(("mstate", "finished"), True)
