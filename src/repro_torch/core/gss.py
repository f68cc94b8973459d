"""Guided-Self-Scheduling-style adaptive controllers (paper §2 "Guided
Self-Scheduling" + §5.3 adaptive timeout).

Two controllers:

- :class:`TimeoutController` — the Manager's pouch timeout. After each round
  it observes (all-done?, elapsed, completion fraction) and moves the
  timeout toward ``elapsed × slack`` on success or grows it multiplicatively
  on failure. This produces the paper's Fig. 2/4 behaviour: timeout is
  inversely proportional to aggregate handler power.
- :func:`gss_chunk` — classic GSS ``ceil(remaining / P)`` chunk sizing, used
  by the host-side data pipeline (pouch sizing for microbatch dispatch).

A verbatim copy of the reference's ``repro/core/gss.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class TimeoutController:
    timeout: float = 0.5
    min_timeout: float = 1e-3
    max_timeout: float = 30.0
    slack: float = 1.3          # target = completion_time × slack
    grow: float = 1.6           # on an incomplete round
    ema: float = 0.5            # blend toward target on success
    #: Cap on retained history entries (0 = unbounded). The Manager sets
    #: this to ``ManagerConfig.history_limit`` — an uncapped list grows by
    #: one float per pouch round for the life of the process.
    history_limit: int = 10_000
    history: list[float] = field(default_factory=list)

    def update(self, all_done: bool, elapsed: float, fraction_done: float) -> float:
        if all_done:
            target = max(elapsed * self.slack, self.min_timeout)
            self.timeout = (1 - self.ema) * self.timeout + self.ema * target
        else:
            # Partial completion: scale in proportion to how far we got —
            # a nearly-done round grows only slightly.
            shortfall = max(1.0 - fraction_done, 0.1)
            self.timeout *= 1.0 + (self.grow - 1.0) * shortfall
        self.timeout = min(max(self.timeout, self.min_timeout), self.max_timeout)
        self.history.append(self.timeout)
        if self.history_limit and len(self.history) > self.history_limit:
            del self.history[:-self.history_limit]
        return self.timeout


@dataclass
class PouchController:
    """Adaptive pouch size (paper §4 lists pouch size as a tunable; the
    training experiments keep it fixed). The Manager wires this into its
    pouch loop (``_start_pouch``/``_finish_pouch``) when
    ``ManagerConfig.adaptive_pouch`` is set: a fully completed,
    well-utilised round grows the pouch (fewer barriers per stage), a
    timed-out round shrinks it (less lost in-flight work per timeout),
    and a revived Manager calls :meth:`revive` so crash-induced timeouts
    don't read as load; ``benchmarks/sched_bench.py`` measures it against
    the fixed §6 baseline. Also used for host-side microbatch dispatch
    sizing."""

    pouch: int = 100
    min_pouch: int = 8
    max_pouch: int = 4096
    #: Shrink-grace countdown set by :meth:`revive` — see below.
    shrink_grace: int = 0

    def update(self, all_done: bool, utilization: float) -> int:
        if all_done and utilization > 0.9:
            self.pouch = min(int(self.pouch * 1.25) + 1, self.max_pouch)
        elif not all_done:
            if self.shrink_grace > 0:
                self.shrink_grace -= 1
            else:
                self.pouch = max(int(self.pouch * 0.8), self.min_pouch)
        if all_done:
            self.shrink_grace = 0
        return self.pouch

    def cost_target(self, pred_costs: list[float], rate: float,
                    target_secs: float) -> int:
        """Cost-aware pouch size (autotune mode): take leading tasks
        until their summed predicted cost would keep the fleet busy for
        about ``target_secs`` — ``rate`` is the fleet's fitted drain
        rate in the same cost units per second (``pred_costs`` may also
        be plain seconds with ``rate=1``). Replaces the fixed count with
        a fixed *predicted drain time*, so a pouch of cheap tasks grows
        (fewer barriers) and a pouch of expensive tasks shrinks (less
        lost in-flight work per timeout). Clamped to
        [``min_pouch``, ``max_pouch``] and recorded in ``pouch`` so the
        Manager checkpoint persists the latest size."""
        if rate <= 0.0 or target_secs <= 0.0 or not pred_costs:
            return self.pouch
        budget = rate * target_secs
        total = 0.0
        n = 0
        for c in pred_costs:
            if n >= self.max_pouch:
                break
            n += 1
            total += max(float(c), 0.0)
            if total >= budget and n >= self.min_pouch:
                break
        self.pouch = max(min(n, self.max_pouch),
                         min(self.min_pouch, len(pred_costs)))
        return self.pouch

    def revive(self, configured: int) -> int:
        """Reset the controller on Manager revival. A crashed pouch reads
        as a barrier timeout, which is a *fault* signal, not a *load*
        signal — under a crash-heavy fault plan the persisted pouch
        ratchets down toward ``min_pouch`` on every revival and adaptive
        sizing collapses. Clamp the persisted size back up to the
        configured starting point (a legitimately grown pouch survives)
        and forgive the first post-revival shortfall, which is the
        crash-truncated round itself."""
        self.pouch = max(self.pouch, min(configured, self.max_pouch))
        self.shrink_grace = 1
        return self.pouch


def gss_chunk(remaining: int, workers: int) -> int:
    """Guided self-scheduling chunk: ceil(remaining / workers), ≥ 1."""
    if remaining <= 0:
        return 0
    return max(1, math.ceil(remaining / max(workers, 1)))
