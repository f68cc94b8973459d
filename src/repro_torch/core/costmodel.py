"""Online cost model — learned per-op latencies driving the scheduler.

The op registry's ``cost_fn`` gives every task a *static* size proxy in
abstract cost units (MAC counts for the built-in programs). What the
scheduler actually needs is **seconds**: how long will this task take on
this fleet, right now? The conversion factor — seconds per cost unit —
depends on handler speeds the paper re-draws at runtime (§6.2), so no
static number survives contact with a heterogeneous fleet. Following the
learned-cost-model argument for reconfigurable dataflow hardware
(arXiv 2511.01872; Flex-TPU, arXiv 2407.08700), this module fits that
factor *online* from signals the runtime already produces:

- handlers report per-(op, handler) aggregates of executed cost units vs
  observed compute seconds into the tuple space under the schema'd
  ``("cstats", kind, src)`` key family (one tuple per (op, handler) —
  bounded, ``persistent`` lifecycle, re-put on update);
- the Manager refreshes its model from those tuples each pouch round and
  publishes its own ``("cstats", "__backlog__", "manager")`` row — the
  predicted seconds of work still in its frontier — which handlers use
  as the cross-tenant drain priority (longest predicted work first).

The registry ``cost_fn`` remains load-bearing as the **prior**: until an
op has observations, its predicted unit time is ``OpSpec.unit_time_prior``
(or :data:`DEFAULT_PRIOR_UNIT_SECS`), and observations are blended with
the prior by pseudo-count shrinkage (:attr:`OnlineCostModel.prior_weight`
cost units' worth), so one noisy first sample cannot whipsaw the
scheduler.

Consumers (all gated behind ``autotune`` knobs, default off):

- :meth:`Manager._frontier_width <repro_torch.core.manager.Manager>` — frontier
  width from predicted stage-cost overlap headroom;
- ``PouchController.cost_target`` — pouch sized to a predicted drain
  time instead of a fixed count;
- the Handler's priority-weighted ``take_batch`` drain and the
  slow-handler deferral rule (a handler whose *fitted* unit time for an
  op is far off the fleet's best hands the task back for a faster peer).

A verbatim copy of the reference's ``repro/core/costmodel.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from repro_torch.core.space import ANY

__all__ = [
    "BACKLOG_KIND", "CSTATS", "DEFAULT_PRIOR_UNIT_SECS", "MANAGER_SRC",
    "OnlineCostModel", "OpObservation", "read_backlog",
]

#: TS subject of the cost-stats key family: ``(CSTATS, kind, src)`` where
#: ``kind`` is an op name (handler rows) or :data:`BACKLOG_KIND` (the
#: Manager's predicted-backlog row) and ``src`` is the reporting actor.
CSTATS = "cstats"
BACKLOG_KIND = "__backlog__"
MANAGER_SRC = "manager"

#: Fallback prior: seconds of compute per abstract cost unit. Matches the
#: default ``Handler.time_scale`` (2e-6 s/unit at speed 1), so a cold
#: model predicts exactly what the static knobs assumed.
DEFAULT_PRIOR_UNIT_SECS = 2e-6


@dataclass
class OpObservation:
    """One (op, src) aggregate: ``n`` executed tasks totalling ``units``
    cost units over ``secs`` observed compute seconds."""

    n: int = 0
    units: float = 0.0
    secs: float = 0.0

    def add(self, units: float, secs: float, n: int = 1) -> None:
        self.n += n
        self.units += float(units)
        self.secs += float(secs)

    def to_wire(self) -> dict:
        return {"n": self.n, "units": self.units, "secs": self.secs}

    @staticmethod
    def from_wire(d: dict) -> "OpObservation":
        return OpObservation(n=int(d.get("n", 0)),
                             units=float(d.get("units", 0.0)),
                             secs=float(d.get("secs", 0.0)))


class OnlineCostModel:
    """Per-(op, src) online latency estimator with pseudo-count shrinkage
    toward the registry prior.

    Thread-safe: handlers observe from their run loop while publishing,
    and the Manager refreshes from TS while predicting. One instance per
    actor per tenant (observations live in the tenant's namespace).
    """

    def __init__(self, registry=None,
                 prior_unit_secs: float = DEFAULT_PRIOR_UNIT_SECS,
                 prior_weight: float = 512.0) -> None:
        self.registry = registry
        self.prior_unit_secs = float(prior_unit_secs)
        #: Pseudo cost units the prior is worth: observations dominate
        #: once an op's observed units exceed this.
        self.prior_weight = float(prior_weight)
        self._obs: dict[tuple[str, str], OpObservation] = {}
        self._dirty: set[tuple[str, str]] = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- fitting
    def observe(self, op: str, units: float, secs: float,
                src: str = "local", n: int = 1) -> None:
        """Fold one executed group into the (op, src) aggregate."""
        if units <= 0.0 or secs < 0.0:
            return
        key = (str(op), str(src))
        with self._lock:
            obs = self._obs.get(key)
            if obs is None:
                obs = self._obs[key] = OpObservation()
            obs.add(units, secs, n)
            self._dirty.add(key)

    def publish(self, ts, src: str) -> int:
        """Re-put this ``src``'s dirty aggregates into TS (one
        ``(CSTATS, op, src)`` tuple per op — delete+put keeps the family
        bounded at one live tuple per (op, src)). Returns rows written."""
        with self._lock:
            dirty = [k for k in self._dirty if k[1] == src]
            rows = [(k, self._obs[k].to_wire()) for k in dirty]
            self._dirty.difference_update(dirty)
        for (op, s), wire in rows:
            ts.delete(("cstats", op, s))
            ts.put(("cstats", op, s), wire)
        return len(rows)

    def refresh(self, ts, keep_src: str | None = None) -> int:
        """Load every ``(CSTATS, op, src)`` aggregate from TS, replacing
        local entries — except ``keep_src``'s own (an actor's local
        aggregates are authoritative over its possibly-stale published
        copy). Returns rows loaded."""
        loaded = 0
        for key in ts.keys(("cstats", ANY, ANY)):
            kind, src = str(key[1]), str(key[2])
            if kind == BACKLOG_KIND or src == keep_src:
                continue
            hit = ts.try_read(key)
            if hit is None:                 # raced a re-put
                continue
            with self._lock:
                self._obs[(kind, src)] = OpObservation.from_wire(hit[1])
            loaded += 1
        return loaded

    # ------------------------------------------------------------- queries
    def _prior(self, op: str) -> float:
        spec = None
        if self.registry is not None:
            try:
                spec = self.registry.resolve(op)
            except KeyError:
                spec = None
        prior = getattr(spec, "unit_time_prior", None)
        return float(prior) if prior is not None else self.prior_unit_secs

    def _sums(self, op: str, src: str | None) -> tuple[float, float, int]:
        """(units, secs, n) summed over matching aggregates."""
        units = secs = 0.0
        n = 0
        with self._lock:
            for (o, s), obs in self._obs.items():
                if o != op or (src is not None and s != src):
                    continue
                units += obs.units
                secs += obs.secs
                n += obs.n
        return units, secs, n

    def samples(self, op: str, src: str | None = None) -> int:
        return self._sums(op, src)[2]

    def unit_secs(self, op: str, src: str | None = None) -> float:
        """Fitted seconds per cost unit for ``op`` (fleet-wide, or one
        ``src``'s), shrunk toward the prior by ``prior_weight`` pseudo
        units — cold ops predict exactly the prior."""
        units, secs, _ = self._sums(op, src)
        prior = self._prior(op)
        w = self.prior_weight
        return (prior * w + secs) / (w + units)

    def best_unit_secs(self, op: str) -> float:
        """The *fastest* fitted unit time any source shows for ``op`` —
        the deferral rule's reference point. Prior when unobserved."""
        with self._lock:
            srcs = {s for (o, s), obs in self._obs.items()
                    if o == op and obs.units > 0.0}
        if not srcs:
            return self._prior(op)
        return min(self.unit_secs(op, src=s) for s in srcs)

    def sources(self) -> list[str]:
        """Distinct reporting sources (handlers) seen so far."""
        with self._lock:
            return sorted({s for (_, s) in self._obs})

    def predict_task(self, task, src: str | None = None) -> float:
        """Predicted seconds for one task: registry cost units (the
        prior's feature) × fitted unit time. Unregistered op → 0.0 (the
        caller treats it as a capability miss anyway)."""
        if self.registry is None:
            return 0.0
        try:
            units = self.registry.cost(task)
        except KeyError:
            return 0.0
        return float(units) * self.unit_secs(task.op, src=src)

    def predict_tasks(self, tasks, src: str | None = None) -> float:
        return sum(self.predict_task(t, src=src) for t in tasks)

    def fleet_units_per_sec(self) -> float:
        """Aggregate fleet throughput in cost units/sec: the sum of each
        source's observed rate across all ops. 0.0 when nothing has been
        observed (callers fall back to static knobs)."""
        with self._lock:
            per_src: dict[str, list[float]] = {}
            for (_, s), obs in self._obs.items():
                row = per_src.setdefault(s, [0.0, 0.0])
                row[0] += obs.units
                row[1] += obs.secs
        return sum(u / t for u, t in per_src.values() if t > 0.0)

    # ----------------------------------------------------- recommendations
    def recommend_width(self, avg_stage_tasks: float, lo: int, hi: int,
                        headroom: float = 4.0) -> int | None:
        """Frontier width from predicted overlap headroom: keep enough
        DAG-independent stages open that the expected concurrently
        available tasks (``width × avg_stage_tasks``) cover the observed
        fleet parallelism ``headroom`` times over — narrow stages on a
        wide fleet widen the frontier, wide stages keep it tight. Returns
        ``None`` (keep the static width) before any handler reports."""
        workers = len([s for s in self.sources() if s != MANAGER_SRC])
        if workers == 0:
            return None
        want = headroom * workers / max(avg_stage_tasks, 1.0)
        width = max(int(want) + (want > int(want)), 1)
        return max(lo, min(width, hi))

    # -------------------------------------------------------- backlog row
    def publish_backlog(self, ts, secs: float) -> None:
        """The Manager's predicted-remaining-work row — the cross-tenant
        drain priority handlers sort by."""
        ts.delete(("cstats", BACKLOG_KIND, MANAGER_SRC))
        ts.put(("cstats", BACKLOG_KIND, MANAGER_SRC), float(secs))

    def report(self) -> dict:
        """Fitted state for result surfaces: op → src → aggregate +
        fitted unit seconds."""
        with self._lock:
            items = sorted(self._obs.items())
        out: dict[str, dict] = {}
        for (op, src), obs in items:
            row = obs.to_wire()
            row["unit_secs"] = self.unit_secs(op, src=src)
            out.setdefault(op, {})[src] = row
        return out


def read_backlog(ts) -> float:
    """A tenant's published predicted backlog (0.0 when absent)."""
    hit = ts.try_read(("cstats", BACKLOG_KIND, MANAGER_SRC))
    return float(hit[1]) if hit is not None else 0.0
