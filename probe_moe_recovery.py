"""Where a MoE crash run's time goes, on the card and on the CPU.

Runs ``examples/acan_moe_routing.py``'s program and cloud (T 128,
minibatch 32, d_in 16, d_hidden 16, d_out 8, 4 experts, top-2, 16 steps,
4 handler threads, task cap 256, pouch 64, ``time_scale`` 1e-6, frontier
8, ``checked+local``) under the example's crash plan (Manager and Handler
crashes with p = 1.0, speeds re-drawn, every ``--interval`` s; the
example's is 0.15) ``--runs`` times on each device, one fault-free run on
each first, and writes for each run:

- the wall, rounds done, revivals, and whether the run's ledger,
  violations and leaks were clean;
- every pouch round the Manager recorded (its ``("thist", ...)`` tuples):
  timeout, elapsed and done fraction, and how many pouch rounds ended
  short of their barrier;
- every op batch the handlers ran (``TaskExecutor.execute_batch``): its
  thread, op, seconds, and whether it was its thread's first;
- every Manager and Handler incarnation: seconds from its thread's start
  to its first op batch (handlers), how long it lived, what ended it, and
  its state then (a handler's task counters; a Manager's frontier base,
  completed and in-flight stages with their pouch sizes, timeout and
  epoch);
- the space's tuples at the end, counted by subject, and its frontier;
- every Manager combine (``MoERoutingProgram.combine``) with its seconds.

Usage::

    python3 probe_moe_recovery.py [--devices cuda,cpu] [--runs 3]
        [--interval 0.15] [--wall-limit 60] [--out chiprun_out/probe_moe_recovery.json]

Prints one summary line a run, and the full record to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, MoERoutingProgram  # noqa: E402
from repro_torch.core.executor import TaskExecutor  # noqa: E402
from repro_torch.core.handler import Handler  # noqa: E402
from repro_torch.core.manager import Manager  # noqa: E402
from repro_torch.core.space import ANY  # noqa: E402

CLOUD = dict(n_handlers=4, task_cap=256.0, pouch_size=64, time_scale=1e-6,
             initial_timeout=0.1, max_inflight_stages=8, ts_backend="checked+local")
CRASHES = dict(speed_levels=(1.0, 5.0, 10.0), p_speed_change=1.0,
               p_handler_crash=1.0, p_manager_crash=1.0, seed=1)


class Trace:
    """Per-run event lists, filled by the patched methods below."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.t0 = time.monotonic()
        self.batches: list[dict] = []
        self.lives: list[dict] = []
        self.combines: list[dict] = []
        self.seen: set[int] = set()

    def now(self) -> float:
        return time.monotonic() - self.t0


TRACE: Trace | None = None


def _patch() -> None:
    """Wrap the methods the trace reads. Each wrapper only times and
    records; what it wraps runs unchanged."""
    run_batch = TaskExecutor.execute_batch

    def execute_batch(self, tasks):
        tr, th = TRACE, threading.current_thread()
        t = tr.now()
        try:
            return run_batch(self, tasks)
        finally:
            with tr.lock:
                first = th.ident not in tr.seen
                tr.seen.add(th.ident)
                tr.batches.append(dict(thread=th.name, ident=th.ident, op=tasks[0].op,
                                       n=len(tasks), t=t, s=tr.now() - t, first=first))
    TaskExecutor.execute_batch = execute_batch

    def lifetime(cls, kind):
        run = cls.run

        def wrapped(self, *a, **kw):
            tr, th = TRACE, threading.current_thread()
            rec = dict(kind=kind, thread=th.name, ident=th.ident, start=tr.now())
            with tr.lock:
                tr.lives.append(rec)
            try:
                return run(self, *a, **kw)
            except BaseException as e:
                rec["ended_by"] = type(e).__name__
                raise
            finally:
                rec["end"] = tr.now()
                rec["state"] = _state(self)
        cls.run = wrapped
    lifetime(Handler, "handler")
    lifetime(Manager, "manager")

    combine = MoERoutingProgram.combine

    def timed_combine(self, ts, rnd, stage, mgr):
        tr = TRACE
        t = tr.now()
        try:
            return combine(self, ts, rnd, stage, mgr)
        finally:
            with tr.lock:
                tr.combines.append(dict(rnd=rnd, stage=stage, t=t, s=tr.now() - t))
    MoERoutingProgram.combine = timed_combine


def _state(obj) -> dict:
    """What an incarnation held when it ended."""
    if isinstance(obj, Handler):
        return {k: getattr(obj, k) for k in ("batches_taken", "tasks_done", "tasks_discarded",
                                             "tasks_stored", "tasks_fenced")}
    return dict(base=obj._base, completed=len(obj._completed), epoch=obj.epoch,
                timeout=obj.controller.timeout, reissued=obj.reissued,
                inflight={f"{r}/{n}": dict(tasks=len(run.tasks), pouch=len(run.pouch),
                                           target=run.target, waiting=run.waiting)
                          for (r, n), run in obj._inflight.items()})


def _q(xs: list, q: float) -> float | None:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def one_run(device: str, interval: float | None, wall_limit: float) -> dict:
    global TRACE
    TRACE = Trace()
    plan = FaultPlan(interval=1e9) if interval is None else FaultPlan(interval=interval,
                                                                      **CRASHES)
    prog = MoERoutingProgram(steps=16, seed=0, device=device)
    cloud = ACANCloud(CloudConfig(**CLOUD, fault_plan=plan, wall_limit=wall_limit,
                                  device=device), program=prog)
    t0 = time.perf_counter()
    res = cloud.run()
    wall = time.perf_counter() - t0
    tr = TRACE
    thist = sorted((k[1], v) for k in cloud.ts.keys(("thist", ANY, ANY))
                   if (hit := cloud.ts.try_read(k)) is not None for v in [hit[1]])
    pouches = [dict(t=t, timeout=v["timeout"], elapsed=v["elapsed"], done_frac=v["done_frac"])
               for t, v in thist]
    first_batch: dict[int, float] = {}
    for b in tr.batches:
        first_batch.setdefault(b["ident"], b["t"])
    handlers = [dict(life) for life in tr.lives if life["kind"] == "handler"]
    for h in handlers:
        fb = first_batch.get(h["ident"])
        h["to_first_batch_s"] = None if fb is None or fb < h["start"] else fb - h["start"]
        h["lived_s"] = h.get("end", tr.now()) - h["start"]
    firsts = [b["s"] for b in tr.batches if b["first"]]
    laters = [b["s"] for b in tr.batches if not b["first"]]
    to_first = [h["to_first_batch_s"] for h in handlers if h["to_first_batch_s"] is not None]
    summary = dict(
        device=device, interval=interval, wall_s=wall, rounds=len(res.loss_history),
        manager_revivals=res.manager_revivals, handler_revivals=res.handler_revivals,
        clean=bool(res.ledger_ok and res.ts_violations == 0 and res.ts_leaks == {}),
        ledger_ok=res.ledger_ok, violations=res.ts_violations,
        violation_samples=[str(v) for v in res.ts_violation_samples[:3]],
        leaks={label: entry.get("count") for label, entry in res.ts_leaks.items()},
        pouch_rounds=len(pouches), pouch_rounds_short=sum(p["done_frac"] < 1 for p in pouches),
        timeout_median=_q([p["timeout"] for p in pouches], 0.5),
        timeout_max=max((p["timeout"] for p in pouches), default=None),
        batches=len(tr.batches), batch_s_first_median=_q(firsts, 0.5),
        batch_s_later_median=_q(laters, 0.5), batch_s_later_p90=_q(laters, 0.9),
        batch_s_max=max((b["s"] for b in tr.batches), default=None),
        handler_lives=len(handlers), handlers_without_a_batch=len(handlers) - len(to_first),
        to_first_batch_median=_q(to_first, 0.5), to_first_batch_p90=_q(to_first, 0.9),
        combines=len(tr.combines), combine_s_total=sum(c["s"] for c in tr.combines),
        combine_s_max=max((c["s"] for c in tr.combines), default=None),
        busy_batch_s=sum(b["s"] for b in tr.batches))
    subjects: dict[str, int] = {}
    for key in cloud.ts.snapshot():
        subjects[str(key[0])] = subjects.get(str(key[0]), 0) + 1
    frontier = cloud.ts.try_read(("mstate", "frontier"))
    return dict(summary=summary, pouches=pouches, batches=tr.batches, lives=tr.lives,
                combines=tr.combines, subjects=subjects,
                frontier=None if frontier is None else frontier[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--interval", type=float, default=0.15)
    ap.add_argument("--wall-limit", type=float, default=60.0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_moe_recovery.json"))
    args = ap.parse_args()
    _patch()
    out: dict = {"args": vars(args)}
    if torch.cuda.is_available():
        from repro_torch.kernels.tile_matmul import kernel as tm
        out["device_name"] = torch.cuda.get_device_name(0)
        tm._lib()                   # built and loaded before the first run
    for device in args.devices.split(","):
        runs = []
        for i in range(args.runs + 1):
            rec = one_run(device, None if i == 0 else args.interval, args.wall_limit)
            print(json.dumps(rec["summary"]), flush=True)
            runs.append(rec)
        out[device] = runs
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out))
    summaries = {d: [r["summary"]["wall_s"] for r in out[d][1:]]
                 for d in args.devices.split(",")}
    print(json.dumps({"crash_run_wall_median_s": {d: statistics.median(w)
                                                  for d, w in summaries.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
