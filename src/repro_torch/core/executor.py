"""Registry-dispatched execution of program tasks against the Tuple Space.

The :class:`TaskExecutor` is a thin dispatcher: it resolves a
task's **op name** in an :class:`~repro_torch.core.program.OpRegistry` and runs
the op's batch-vectorizable kernel. Program-specific kernels (the MLP
tile matmuls, the MoE routing/expert/grad kernels, the jitted JAX grad
op) live with their programs under :mod:`repro_torch.programs`.

Every op's output is a *pure function of tuples it reads* — duplicate
execution re-writes identical values, which is the paper's §5.4
idempotency argument for everything except parameter overwrites; those
are keyed by ``step`` and committed exactly once by the Manager's
sliding window (:mod:`repro_torch.core.conflict`).

Control-plane key conventions (Manager/Handler scheduling — shared by
every program; data-plane key tables live in each program's module
docstring, e.g. :mod:`repro_torch.programs.mlp`). The **namespace** column
shows each key as stored in a *multi-tenant* space: a program running
under a :class:`~repro_torch.core.space.ScopedSpace` has its subject fused
into ``ns::subject`` (an :class:`~repro_torch.core.space.NsSubject`), so no
tenant's sweeps, cursors, marks or histories can touch another's; in
the single-tenant default namespace the subject is stored raw and
everything below reads as before:

===========================================  ===================  ==========================
key (as the program writes it)               namespaced subject   value
===========================================  ===================  ==========================
``("task", tid)``                            ``ns::task``         task wire string — or
                                                                  ``(wire, handler_name,``
                                                                  ``nonce)`` after a
                                                                  "store": the name tags
                                                                  which handler put it
                                                                  back so it can skip its
                                                                  own re-puts for one
                                                                  backoff cycle, the nonce
                                                                  marks ownership across
                                                                  process boundaries for
                                                                  the fence
                                                                  compensation; ``tid`` is
                                                                  ``e<epoch>t<seq>`` — the
                                                                  Manager epoch makes a
                                                                  revived Manager's ids
                                                                  collision-free against
                                                                  its predecessor's
                                                                  leftovers
``("done", op, layer, data_id, step,``       ``ns::done``         completion mark, keyed by
``  in_lo, in_hi, out_lo, out_hi)``                               task *content*; the **op
                                                                  name namespaces the
                                                                  control plane within a
                                                                  tenant** — a stage's
                                                                  marks share every field
                                                                  the stage's tasks agree
                                                                  on, so the Manager's
                                                                  pouch barrier is one
                                                                  ``wait_count`` over that
                                                                  pattern (the done counter)
``("mstate", "frontier")``                   ``ns::mstate``       the completed-stage
                                                                  **frontier**:
                                                                  ``{base, completed}`` —
                                                                  every round below
                                                                  ``base`` is finished, and
                                                                  ``completed`` lists the
                                                                  combined ``[round,
                                                                  stage]`` pairs at/ahead
                                                                  of it (possibly spanning
                                                                  two overlapped rounds); a
                                                                  revived Manager resumes
                                                                  exactly this frontier,
                                                                  re-running only the
                                                                  stages it omits
``("mstate", "cursor")`` / ``("mstate",``    ``ns::mstate``       Manager resume cursor
``  "rounds")`` / ``("mstate", "epoch")``                         ``{round, stage_idx,
``/ ("mstate", "finished")``                                      timeout, pouch, window}``
                                                                  (round/stage_idx = first
                                                                  uncombined stage of the
                                                                  base round — legacy
                                                                  shape; the frontier key
                                                                  is the resume point
                                                                  proper) / per-round pouch
                                                                  counter (monotonic across
                                                                  revivals) / Manager
                                                                  (re)start count (folded
                                                                  into tids) / per-program
                                                                  completion flag the Cloud
                                                                  blocks a ``read`` on
``("thist", t, round)``                      ``ns::thist``        timeout/power history
                                                                  (capped by
                                                                  ``history_limit``)
``("losshist", step)``                       ``ns::losshist``     loss trajectory (every
                                                                  training program records
                                                                  it via ``record_loss``)
===========================================  ===================  ==========================

A verbatim copy of the reference's ``repro/core/executor.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.program import OpRegistry, ensure_builtin_ops
from repro_torch.core.tasks import TaskDesc
from repro_torch.core.space import TupleSpace, role, task_context


class PreconditionUnmet(Exception):
    """Task inputs are not (yet) in TS — the task "fails upon timeout and is
    discarded" from the handler's perspective (paper §5.1)."""


def activation(z: np.ndarray) -> np.ndarray:
    return np.tanh(z)


def activation_deriv_from_act(a: np.ndarray) -> np.ndarray:
    return 1.0 - a * a


@dataclass
class ExecContext:
    """What an op kernel sees: the Tuple Space plus a small environment of
    handler-side knobs (currently the SGD ``lr`` for the MLP update op).
    All workload state lives in TS (device-agnostic by construction, the
    paper's decoupling property); ``env`` is for execution parameters
    only, never data."""

    ts: TupleSpace
    env: dict[str, Any] = field(default_factory=dict)

    def require(self, key: tuple) -> Any:
        hit = self.ts.try_read(key)
        if hit is None:
            raise PreconditionUnmet(str(key))
        return hit[1]


class TaskExecutor:
    """Executes :class:`TaskDesc`\\ s by registry dispatch.

    ``registry`` defaults to the built-in ops (MLP + MoE); a Handler
    serving a program with private ops passes that program's registry.
    The executor is stateless between tasks.
    """

    def __init__(self, ts: TupleSpace, lr: float = 0.01,
                 registry: OpRegistry | None = None,
                 env: dict[str, Any] | None = None) -> None:
        self.ts = ts
        self.registry = registry if registry is not None else ensure_builtin_ops()
        e: dict[str, Any] = {"lr": lr}
        e.update(env or {})
        self.ctx = ExecContext(ts, e)

    # ------------------------------------------------------------- dispatch
    def execute(self, task: TaskDesc) -> list[tuple[tuple, Any]]:
        return self._run_group([task])

    def execute_batch(self, tasks: list[TaskDesc]) -> list[tuple[tuple, Any]]:
        """Execute a batch vectorized per compatible *group* (same op,
        layer, data_id, step): shared inputs are read from TS once,
        uniform tiles are stacked, and each group's outputs land through
        a single ``put_many``.

        A group whose inputs are missing raises
        :class:`PreconditionUnmet` before writing anything — the whole
        group is discarded atomically, exactly as each task would be
        individually. A heterogeneous list is split into its groups.

        Returns every ``(key, value)`` written, so the Handler can
        compensate (delete its own writes) when a fence check shows the
        result landed after the Manager already finished the round
        (leak closure).
        """
        if not tasks:
            return []
        groups: list[list[TaskDesc]] = []
        index: dict[tuple, int] = {}
        for t in tasks:
            sig = (t.op, t.layer, t.data_id, t.step)
            if sig not in index:
                index[sig] = len(groups)
                groups.append([])
            groups[index[sig]].append(t)
        written: list[tuple[tuple, Any]] = []
        for group in groups:
            written.extend(self._run_group(group))
        return written

    def _run_group(self, group: list[TaskDesc]) -> list[tuple[tuple, Any]]:
        spec = self.registry.resolve(group[0].op)
        t = group[0]
        with role("executor"), task_context(t.op, t.layer, t.data_id, t.step):
            items = list(spec.batch_fn(self.ctx, group))
            if items:
                # The fence lives in the *caller* (handler.py re-checks
                # _fence_base and _undo_stale's the batch after we
                # return) — non-local, so declared by pragma.
                self.ts.put_many(items)  # crash: frontier-fenced
        return items
