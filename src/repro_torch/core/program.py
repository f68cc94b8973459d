"""The :class:`WorkloadProgram` protocol and the **op registry** — one
fault-tolerant control plane for arbitrary (including non-regular)
workloads.

The paper's core claim is feasibility of the reconfigurable
multiprocessor for *non-regular workflows*, yet the first
Manager/Handler stack was hard-wired to the five MLP task kinds and the
ACAN-over-JAX runner re-implemented its own barrier/timeout/commit loop.
This module is the split point:

- an **op** is a named, batch-vectorizable executor kernel with a
  per-op cost model and split rule (:class:`OpSpec`), looked up by the
  :class:`~repro_torch.core.executor.TaskExecutor` at execution time through
  an :class:`OpRegistry` — ops are pure functions of tuples they read,
  which preserves the paper's §5.4 idempotency argument for free;
- a **program** (:class:`WorkloadProgram`) declares the per-round stage
  graph — which prototype tasks each stage holds, how stage results are
  combined/committed, and what per-round cleanup looks like. Stages may
  be *data-dependent*: ``stage_tasks`` reads the Tuple Space, so a
  program can derive a stage's tasks from an earlier stage's combined
  output (the MoE routing program derives expert tasks from routing
  decisions — irregular task sizes on the same plane).

The generic :class:`~repro_torch.core.manager.Manager` schedules the
program's stages as a **dependency DAG**: ``stage_deps`` names
each stage's predecessors (defaulting to a linear chain over
``stage_names``, so every pre-DAG program is source-compatible), and
the Manager's frontier scheduler keeps up to
``ManagerConfig.max_inflight_stages`` independent stages in flight —
including stages of *consecutive rounds* when the program opts in via
``round_overlap`` — each driven by the paper's pouch/timeout/barrier
discipline. The completed-stage frontier is checkpointed into TS
(``("mstate", "frontier")``) so a revived Manager resumes the exact
frontier from TS state alone. Everything a program writes must
therefore be either idempotent or guarded by the Manager's §5.4 commit
window.

Built-in programs: :mod:`repro_torch.programs.mlp` (the paper §6 workload,
its tile products on the card), :mod:`repro_torch.programs.torch_sgd`
(training a zoo model on the card), and :mod:`repro_torch.programs.moe`
(non-regular expert routing, its products on the card).

Port of the reference's ``repro/core/program.py``: the same code, with
``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Iterable

from repro_torch.core.tasks import TaskDesc, split_out_halves

if TYPE_CHECKING:  # pragma: no cover - type-only imports
    from repro_torch.core.executor import ExecContext
    from repro_torch.core.manager import Manager
    from repro_torch.core.space import ScopedSpace, TupleSpace
    from repro_torch.core.space.schema import KeySchema

    #: Hooks accept the shared facade or a tenant's namespace view.
    SpaceLike = TupleSpace | ScopedSpace


#: Batch executor: reads inputs from ``ctx.ts``, returns the (key, value)
#: tuples to publish. Raising PreconditionUnmet before returning discards
#: the whole group atomically (nothing is written).
BatchFn = Callable[["ExecContext", list[TaskDesc]], Iterable[tuple[tuple, Any]]]


@dataclass(frozen=True)
class OpSpec:
    """One registered op: executor kernel + cost model + split rule.

    ``cost_fn`` is the task-size proxy the paper's §5.2 partitioning and
    the Handler's capability check both consume; ``split_fn`` is one
    level of the partition rule (default: halve the ``out`` slice).

    ``unit_time_prior`` optionally declares the expected seconds per
    ``cost_fn`` unit (at handler speed 1) — the *prior* the online cost
    model (:mod:`repro_torch.core.costmodel`) starts from and refines with
    observed execution; ``None`` falls back to the model's global
    default. The static ``cost_fn`` thereby stays the single source of
    task *size*, while the learned part is only the size→seconds
    conversion the fleet's (re-drawn) speeds determine.
    """

    name: str
    batch_fn: BatchFn
    cost_fn: Callable[[TaskDesc], float]
    split_fn: Callable[[TaskDesc], list[TaskDesc]] = split_out_halves
    unit_time_prior: float | None = None


class UnknownOp(KeyError):
    """No OpSpec registered under this name (in this registry chain)."""


class OpRegistry:
    """Name → :class:`OpSpec`, with optional parent chaining.

    Stateless ops (the MLP and MoE kernels — everything they need lives
    in TS) register in the shared :data:`GLOBAL_OPS`; programs whose ops
    close over instance state (the JAX-SGD program's jitted grad
    function) build a private ``OpRegistry(parent=GLOBAL_OPS)`` so two
    program instances never collide.
    """

    def __init__(self, parent: "OpRegistry | None" = None) -> None:
        self._ops: dict[str, OpSpec] = {}
        self.parent = parent

    def register(self, spec: OpSpec, override: bool = False) -> OpSpec:
        if not override and spec.name in self._ops:
            raise ValueError(f"op {spec.name!r} already registered")
        self._ops[spec.name] = spec
        return spec

    def resolve(self, name: str) -> OpSpec:
        reg: OpRegistry | None = self
        while reg is not None:
            spec = reg._ops.get(name)
            if spec is not None:
                return spec
            reg = reg.parent
        raise UnknownOp(
            f"no op {name!r} registered (is the owning program module "
            f"imported, and the Handler given the program's registry?)")

    # ------------------------------------------------------ cost/partition
    def cost(self, task: TaskDesc) -> float:
        return self.resolve(task.op).cost_fn(task)

    def split(self, task: TaskDesc) -> list[TaskDesc]:
        return self.resolve(task.op).split_fn(task)

    def partition(self, task: TaskDesc, max_size: float) -> list[TaskDesc]:
        """Recursively split ``task`` until every piece costs ≤ ``max_size``
        (paper §5.2). A task that can no longer shrink is emitted as-is
        (the cap then acts as a soft bound)."""
        if self.cost(task) <= max_size:
            return [task]
        pieces = self.split(task)
        if len(pieces) == 1 and self.cost(pieces[0]) >= self.cost(task):
            return [task]
        out: list[TaskDesc] = []
        for p in pieces:
            out.extend(self.partition(p, max_size))
        return out


#: Shared registry for stateless ops (MLP, MoE routing).
GLOBAL_OPS = OpRegistry()


def ensure_builtin_ops() -> OpRegistry:
    """Import the built-in program modules (registering their ops) and
    return :data:`GLOBAL_OPS`. Lazy so :mod:`repro_torch.core.executor` never
    imports :mod:`repro_torch.programs` at module load (no import cycle)."""
    import repro_torch.programs  # noqa: F401  (import side effect: registration)
    return GLOBAL_OPS


def partition(task: TaskDesc, max_size: float,
              registry: OpRegistry | None = None) -> list[TaskDesc]:
    """Module-level convenience over :meth:`OpRegistry.partition` using
    the built-in registry by default."""
    return (registry or ensure_builtin_ops()).partition(task, max_size)


# --------------------------------------------------------------------------
# Declared stage effects — the interference contract the DAG lint
# checks statically and the Manager's admission fence enforces at runtime.

#: Pseudo-stage name for ``finish_round`` cleanup in a program's declared
#: effects: ``@finish`` of round ``r`` runs after every stage of round
#: ``r`` but concurrently with any later round the overlap admits.
FINISH_STAGE = "@finish"


@dataclass(frozen=True)
class StageEffect:
    """One declared effect of a stage on a tuple-space **key family**:
    the ``subject`` plus the fields the stage pins to concrete values
    (everything unpinned is touched wildcard-wide, which aliases
    conservatively). ``mode`` is ``"read"``, ``"write"`` (put) or
    ``"delete"``; a destructive take declares both a read and a delete.

    Effects are produced by :meth:`WorkloadProgram.stage_effects` *per
    round*, so round-derived pins (``step = rnd``, ``data_id = rnd %
    n_samples``) carry the concrete value for that round — cross-round
    aliasing then falls out of plain pin comparison.
    """

    subject: str
    mode: str  # "read" | "write" | "delete"
    pins: tuple = ()  # sorted ((field, value), ...) pairs

    def __str__(self) -> str:
        pin = ", ".join(f"{f}={v}" for f, v in self.pins)
        return f"{self.mode}({self.subject}{', ' + pin if pin else ''})"


def reads(subject: str, **pins: Any) -> StageEffect:
    """A read effect on ``subject`` with the given pinned fields."""
    return StageEffect(subject, "read", tuple(sorted(pins.items())))


def writes(subject: str, **pins: Any) -> StageEffect:
    """A write (put) effect on ``subject`` with the given pinned fields."""
    return StageEffect(subject, "write", tuple(sorted(pins.items())))


def deletes(subject: str, **pins: Any) -> StageEffect:
    """A delete effect on ``subject`` with the given pinned fields."""
    return StageEffect(subject, "delete", tuple(sorted(pins.items())))


def effects_conflict(a: StageEffect, b: StageEffect) -> str | None:
    """Do two effects interfere? ``None`` if not, else the hazard class
    (``"RW"`` or ``"WW"`` — deletes count as writes). Effects interfere
    when they name the same subject, at least one mutates, and their
    pins are *compatible*: every field pinned by both carries the same
    value (a field pinned by only one side aliases conservatively)."""
    if a.subject != b.subject:
        return None
    if a.mode == "read" and b.mode == "read":
        return None
    pa, pb = dict(a.pins), dict(b.pins)
    for f in pa.keys() & pb.keys():
        if pa[f] != pb[f]:
            return None
    return "RW" if "read" in (a.mode, b.mode) else "WW"


def record_loss(ts, step: int, loss: float, history_limit: int = 0) -> None:
    """Append to the ``("losshist", step)`` trajectory exactly once per
    step (idempotent under Manager revival) and trim it to
    ``history_limit`` entries — steps are monotonic across revivals, so a
    step-number cut is safe."""
    if ts.try_read(("losshist", step)) is None:
        ts.put(("losshist", step), float(loss))
    if history_limit and step >= history_limit:
        from repro_torch.core.space.api import FieldLE
        ts.delete(("losshist", FieldLE(step - history_limit)))


class WorkloadProgram(abc.ABC):
    """A declarative workload: per-round stage graph + combine/commit
    hooks, scheduled by the generic Manager over crash-prone Handlers.

    Contract (what fault tolerance requires of implementations):

    - ``setup`` must be **idempotent** — a revived Manager calls it again;
    - ``stage_tasks`` must be a pure function of ``(ts, round, stage)``
      — it may read TS (data-dependent stages) but only state produced
      by *combined predecessor* stages (per ``stage_deps``) or committed
      earlier rounds;
    - ``combine`` must be idempotent or guarded by ``mgr.window`` (the
      §5.4 sliding commit window) — it can run twice around a crash.
      Under the frontier scheduler it fires on *that stage's*
      completion, possibly while other stages (even of the next round)
      are still in flight — it must only touch state its own stage and
      its declared predecessors own;
    - ``stage_deps`` must name every true data dependency: the frontier
      scheduler runs any two stages with no dependency path between
      them **concurrently**. A program that declares
      ``round_overlap() > 1`` additionally guarantees that
      ``finish_round(r)`` cleanup cannot clobber keys still read by
      rounds ``> r`` that its cross-round deps admit in flight;
    - every op a program issues must be resolvable in ``self.registry``.
    """

    #: Program name — reporting, and the *namespace* a multi-tenant
    #: ACANCloud scopes this program's keys under (de-duplicated when two
    #: co-residents share a name). Ops additionally namespace the control
    #: plane *within* a tenant (done marks carry the op name); true
    #: cross-program isolation — sweeps, cursors, data-plane keys — comes
    #: from the :class:`~repro_torch.core.space.ScopedSpace` the Manager and
    #: Handlers hand the program, which is transparent here: every hook
    #: just uses ``ts`` and all keys land in this program's namespace.
    name: str = "program"
    registry: OpRegistry = GLOBAL_OPS

    def setup(self, ts: "SpaceLike") -> None:
        """Publish initial TS state (params, data, config) — idempotent."""

    @abc.abstractmethod
    def n_rounds(self) -> int:
        """Total rounds (outer iterations) in the job."""

    @abc.abstractmethod
    def stage_names(self, rnd: int) -> list[str]:
        """Dependency-ordered stage names for round ``rnd``. Order is the
        frontier scheduler's deterministic tie-break among ready stages
        (and the sequential execution order at
        ``max_inflight_stages=1``)."""

    def stage_deps(self, rnd: int) -> dict[str, list]:
        """The stage-dependency DAG for round ``rnd``: stage name → list
        of predecessors. A predecessor is either a stage name of the
        *same* round, or a ``(name, delta)`` pair with ``delta <= 0``
        naming a stage of round ``rnd + delta`` (cross-round pipelining;
        deps reaching before round 0 are trivially satisfied). A stage
        absent from the mapping has no predecessors.

        Default: the linear chain over ``stage_names(rnd)`` — exactly
        the pre-DAG sequential contract, so existing programs are
        source-compatible and (with a pure chain) bit-identical.
        """
        names = self.stage_names(rnd)
        return {name: ([names[i - 1]] if i else [])
                for i, name in enumerate(names)}

    def round_overlap(self) -> int:
        """How many consecutive rounds the frontier scheduler may hold
        open at once (1 = strict round-at-a-time, the default). A
        program returning ``k > 1`` promises that its ``stage_deps``
        cross-round entries express every inter-round hazard for rounds
        up to ``k - 1`` apart — including ``finish_round`` cleanup (the
        MLP program, whose cleanup is per ``data_id = rnd % n_samples``,
        only overlaps when ``n_samples >= 2``)."""
        return 1

    def recleanable_rounds(self, lo: int, base: int) -> range:
        """The finished rounds in ``[lo, base)`` whose ``finish_round`` may
        run again while rounds from ``base`` on are in flight (the cleanup
        after a handler's death). Default: all of them, since each round's
        tuples carry the round."""
        return range(lo, base)

    @abc.abstractmethod
    def stage_tasks(self, ts: "SpaceLike", rnd: int,
                    stage: str) -> list[TaskDesc]:
        """Prototype tasks of one stage (pre-partition). May read TS.
        An empty list is a **pure combine barrier**: the stage completes
        immediately and only its ``combine`` hook runs (the MoE program
        uses one to fuse per-expert forward results into the shared
        ``dy``)."""

    def combine(self, ts: "SpaceLike", rnd: int, stage: str,
                mgr: "Manager") -> None:
        """Stage-boundary combine/commit hook ("the Manager updates the
        relevant TS entries as a checkpoint", §5.3). ``mgr`` exposes
        ``window`` (commit dedup) and ``cfg.history_limit``."""

    def finish_round(self, ts: "SpaceLike", rnd: int) -> None:
        """Per-round TS cleanup (delete partials + done marks)."""

    def key_schemas(self) -> "tuple[KeySchema, ...]":
        """The program's declared data-plane key protocol: one
        :class:`~repro_torch.core.space.schema.KeySchema` per subject the
        program puts/reads/deletes.

        A multi-tenant cloud registers these (plus the control-plane
        schemas) under the program's namespace, and the
        :class:`~repro_torch.core.space.checked.CheckedBackend` sanitizer then
        validates every op against them — arity, field types,
        producer/consumer roles — and reports any non-``persistent``
        tuple still live at shutdown as a leak. Programs returning the
        default empty tuple opt out: their namespace stays lenient
        (nothing is registered under it, so nothing is flagged).
        """
        return ()

    def stage_effects(self, rnd: int) -> "dict[str, tuple[StageEffect, ...]] | None":  # noqa: ARG002
        """The program's declared per-stage interference contract for
        round ``rnd``, mirroring :meth:`key_schemas`' declare-
        then-enforce pattern: stage name → the :class:`StageEffect`\\ s
        that stage (its ``stage_tasks`` reads, its op kernels' reads and
        writes, and its ``combine``) performs on the data plane. The
        reserved :data:`FINISH_STAGE` entry declares ``finish_round``'s
        cleanup deletes. Control-plane subjects (tasks, done marks,
        cursors, histories) are owned by the Manager/Handler protocol
        and are never declared.

        Three consumers: ``tools/dag_lint.py`` cross-checks the
        declaration against ``stage_deps``/``round_overlap`` (reporting
        WW/RW conflicts between DAG-concurrent stages, reads with no
        producing ancestor, and cleanup that aliases overlapped rounds)
        and against AST-inferred effects (drift); the Manager refuses to
        overlap two in-flight stages whose declared effects conflict
        (the admission fence); and the happens-before sanitizer
        (``raced`` backend) checks the same property on concrete keys at
        runtime. Returning ``None`` (the default) opts out: nothing is
        checked and the admission fence stays open.
        """
        return None
