"""Declarative task descriptions — the unit of work every WorkloadProgram
schedules through the ACAN plane.

A :class:`TaskDesc` is a **declarative description** (serialisable
dataclass ↔ wire string), not an instantiated object — the Handler
independently retrieves whatever the task needs from the Tuple Space at
execution time (paper §5.1), which is what decouples Manager from
Handler.

The task carries an **op name** (open string) instead of the
old closed ``TaskKind`` enum: what an op *means* — its executor kernel,
its cost model, its split rule — lives in the
:class:`~repro_torch.core.program.OpRegistry`, so new workloads register new
ops without touching the Manager/Handler plane. The paper's five MLP
prototype ops (``forward`` / ``activation`` / ``loss`` / ``backward`` /
``update``) are registered by :mod:`repro_torch.programs.mlp`.

The four slice ints are **generic payload slices**: for the MLP ops they
are the paper's §5.2 (input × output) rectangle; the JAX-SGD program uses
``out_lo`` as the microbatch index; the MoE routing program uses
``layer`` as the expert id and ``out_lo:out_hi`` as a slot range into
that expert's (data-dependent) dispatch list.

A verbatim copy of the reference's ``repro/core/tasks.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class TaskDesc:
    """Declarative description of one unit of program work.

    ``op`` names the registered executor kernel. ``in_lo:in_hi`` /
    ``out_lo:out_hi`` are op-interpreted payload slices (for the MLP ops:
    the layer input / output dimension ranges).

    ``data_id`` identifies the work item (training sample, minibatch,
    …), ``step`` the global SGD step (used for update-dedup, §5.4),
    ``task_id`` is unique per issued task.
    """

    op: str
    layer: int
    data_id: int
    step: int
    in_lo: int = 0
    in_hi: int = 0
    out_lo: int = 0
    out_hi: int = 0
    task_id: str = ""

    def __post_init__(self) -> None:
        # Accept str-enum-like values but store the plain string so wire
        # format, content keys, and registry lookups are uniform.
        op = getattr(self.op, "value", self.op)
        if not isinstance(op, str) or not op:
            raise ValueError(f"op must be a non-empty string, got {self.op!r}")
        object.__setattr__(self, "op", op)

    # ------------------------------------------------------------- geometry
    @property
    def m(self) -> int:
        return self.in_hi - self.in_lo

    @property
    def n(self) -> int:
        return self.out_hi - self.out_lo

    # ------------------------------------------------------------ serialise
    def to_wire(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)

    @staticmethod
    def from_wire(s: str) -> "TaskDesc":
        return TaskDesc(**json.loads(s))


def content_key(t: TaskDesc) -> tuple:
    """Identity of a task by *content* (not attempt) — completion marks are
    keyed by this, so a slow handler finishing attempt k still satisfies
    attempt k+1 (redundant execution is harmless by construction)."""
    return (t.op, t.layer, t.data_id, t.step,
            t.in_lo, t.in_hi, t.out_lo, t.out_hi)


def halves(lo: int, hi: int) -> list[tuple[int, int]]:
    """Split [lo, hi) in half; a span of ≤ 1 no longer splits."""
    span = hi - lo
    if span <= 1:
        return [(lo, hi)]
    mid = lo + span // 2
    return [(lo, mid), (mid, hi)]


def split_out_halves(task: TaskDesc) -> list[TaskDesc]:
    """Default split rule: halve the ``out`` slice (the paper's 2-way rule
    for 1-D task kinds)."""
    return [replace(task, out_lo=ol, out_hi=oh, task_id="")
            for (ol, oh) in halves(task.out_lo, task.out_hi)]


def split_quadrants(task: TaskDesc) -> list[TaskDesc]:
    """4-way split into (input × output) quadrants (the paper's rule for
    2-D forward/backward tasks)."""
    return [replace(task, in_lo=il, in_hi=ih, out_lo=ol, out_hi=oh,
                    task_id="")
            for (il, ih) in halves(task.in_lo, task.in_hi)
            for (ol, oh) in halves(task.out_lo, task.out_hi)]
