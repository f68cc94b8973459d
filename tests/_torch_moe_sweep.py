"""Deterministic crash-point sweep of the port's MoE routing program
(``repro_torch.programs.moe.MoERoutingProgram``), shared by
``tests/test_torch_moe_sweep*.py``.

The reference's sweep (``tools/crash_sweep.py``) arms only the MLP's
sites. Here every TS mutation site that ``tools/crash_lint.py`` finds in
the files the MoE program runs (the Manager, the Handler's event and poll
loops, the executor, ``record_loss`` and the program itself) is armed once
through the port's ``CrashPointBackend`` (``crashpoint+checked+local``),
``nth=1``, both ``before`` and ``after`` the op, on a small run: 4 experts,
top-2, 128 tokens, 3 rounds, ONE handler, so that a crashed handler must be
revived for the run to finish. Sites inside ``Handler._run_poll`` run
under ``scheduling="poll"``. A site's crash is matched by its op as well as
its line (``_commit_expert`` deletes and puts on one line). Each armed run
must finish, leave no leaked tuple and no race, give the crash-free run's
losses and final expert weights bit for bit and, where the crash fired,
have its role revived. Where no handler died (the Manager's sites) the
cloud must have reaped nothing, so the leak scan sees all that the Manager
leaves. A site the crash-free run never reaches must leave
the armed run equal to the crash-free one (the armed wrapper is
transparent). Every mutation a crash-free run issues must be one of the
swept sites.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from pathlib import Path

import torch

from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, MoERoutingProgram
from repro_torch.core.space import CrashSpec, crashpoint, find_crashpoint
from repro_torch.core.space.checked import get_role

REPO = Path(__file__).resolve().parents[1]
HERE = os.path.abspath(__file__)
SPACE_DIR = os.path.dirname(os.path.abspath(crashpoint.__file__))
SWEEP_FILES = ("src/repro_torch/core/manager.py", "src/repro_torch/core/handler.py",
               "src/repro_torch/core/executor.py", "src/repro_torch/core/program.py",
               "src/repro_torch/programs/moe.py")
ROLES = ("manager", "handler", "executor")
STEPS = 3
MID = 1                      # the middle round
WALL_LIMIT = 20.0            # a run that hangs fails its own case
#: The Manager's terminal op: after it the daemon does not revive a
#: finished Manager (a crash after the publish is a normal exit).
NO_REVIVAL = frozenset({("manager:manager.Manager._run:put[mstate]#0", "after")})
#: Sites where the crashed role holds nothing the run still needs: the
#: post-write fence's undo runs only once the task's round is over, so
#: when that round is the last the run can finish before the daemon's
#: liveness poll sees the death. (With one handler, a death that the run
#: did need a revival for shows as a run that did not finish.)
NEEDS_NOTHING = ("Handler._undo_stale",)


def sweep_sites(roles=ROLES, files=SWEEP_FILES) -> list:
    """The lint's mutation sites of ``files`` issued by ``roles``."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tools.crash_lint import site_registry

    return [s for s in site_registry([REPO / f for f in files]) if s.role in roles]


def scheduling_for(site) -> str:
    return "poll" if "_run_poll" in site.qualname else "event"


@dataclass
class RunOut:
    finished: bool
    losses: list
    weights: list
    ts_leaks: dict
    race_report: list
    manager_revivals: int
    handler_revivals: int
    firings: list
    #: tuples of finished rounds deleted after a handler death
    stale_reaped: int = 0
    #: (role, path, line, op) of every mutation the run issued
    sites: set = field(default_factory=set)


def cloud_config(scheduling: str = "event", n_handlers: int = 1, **kw) -> CloudConfig:
    return CloudConfig(**(dict(
        n_handlers=n_handlers, task_cap=256.0, pouch_size=64, time_scale=1e-6,
        initial_timeout=0.1, wall_limit=WALL_LIMIT, scheduling=scheduling,
        ts_backend="crashpoint+checked+local", fault_plan=FaultPlan(interval=1e9),
        device="cpu") | kw))


def _site_frame():
    """The frame of the op's caller: past the space package's frames, as
    ``CrashPointBackend._site_frame`` walks, and past this module's
    wrappers of it."""
    f = sys._getframe(1)
    while f is not None and (os.path.dirname(os.path.abspath(f.f_code.co_filename)) == SPACE_DIR
                             or os.path.abspath(f.f_code.co_filename) == HERE):
        f = f.f_back
    return f


def _filtered(cp, keep):
    """Let ``cp`` count and fire only at ops for which ``keep(op, key)``."""
    fire = cp._maybe_fire
    cp._site_frame = _site_frame

    def maybe_fire(when, op, key):
        if keep(op, key):
            fire(when, op, key)

    cp._maybe_fire = maybe_fire


def _recording(cp, seen: set):
    fire = cp._maybe_fire
    cp._site_frame = _site_frame

    def maybe_fire(when, op, key):
        if when == "before":
            f = _site_frame()
            if f is not None:
                path = os.path.relpath(f.f_code.co_filename, REPO).replace("\\", "/")
                seen.add((get_role(), path, f.f_lineno, op))
        fire(when, op, key)

    cp._maybe_fire = maybe_fire


def run_once(scheduling: str = "event", spec: CrashSpec | None = None, keep=None,
             record: bool = False, hook=None, n_handlers: int = 1) -> RunOut:
    """One MoE run; ``spec`` armed, its hits restricted to ops ``keep``
    accepts; ``hook(cloud)`` (optional) runs before ``cloud.run()``."""
    prog = MoERoutingProgram(steps=STEPS, seed=0, device="cpu")
    cloud = ACANCloud(cloud_config(scheduling, n_handlers), program=prog)
    cp = find_crashpoint(cloud.ts.backend)
    seen: set = set()
    if record:
        _recording(cp, seen)
    if keep is not None:
        _filtered(cp, keep)
    if spec is not None:
        cp.arm(spec)
    if hook is not None:
        hook(cloud)
    res = cloud.run()
    finished = cloud.ts.try_read(("mstate", "finished")) is not None
    weights = [cloud.ts.try_read((w, e)) for e in range(prog.E) for w in ("we1", "we2")]
    return RunOut(finished=finished, losses=list(res.loss_history),
                  weights=[None if w is None else w[1] for w in weights],
                  ts_leaks=dict(res.ts_leaks), race_report=list(res.race_report),
                  manager_revivals=res.manager_revivals,
                  handler_revivals=res.handler_revivals, firings=list(cp.firings),
                  stale_reaped=res.stale_reaped, sites=seen)


_baselines: dict = {}
_lock = threading.Lock()


def baseline(scheduling: str) -> RunOut:
    """The crash-free run of ``scheduling``, once a process, its sites
    recorded."""
    with _lock:
        if scheduling not in _baselines:
            base = run_once(scheduling, record=True)
            assert base.finished and len(base.losses) == STEPS, base
            assert base.ts_leaks == {} and base.race_report == [], base
            assert base.stale_reaped == 0, base
            _baselines[scheduling] = base
        return _baselines[scheduling]


def failures(run: RunOut, base: RunOut, role: str, revival_expected: bool) -> list[str]:
    """The sweep's gate: what is wrong with ``run`` against ``base``."""
    out = []
    if not run.finished:
        out.append("run did not complete")
    if run.losses != base.losses:
        out.append(f"losses differ: {run.losses} vs {base.losses}")
    if not all(a is not None and b is not None and torch.equal(a, b)
               for a, b in zip(run.weights, base.weights)):
        out.append("final expert weights differ from the crash-free run")
    if run.ts_leaks:
        out.append(f"ts_leaks={run.ts_leaks}")
    if run.race_report:
        out.append(f"{len(run.race_report)} race(s)")
    if role == "manager" and run.stale_reaped:
        # No handler died, so nothing may be reaped: a leak the Manager
        # leaves must show in ts_leaks.
        out.append(f"stale_reaped={run.stale_reaped} with no handler death")
    if run.firings and revival_expected:
        revived = run.manager_revivals if role == "manager" else run.handler_revivals
        if revived < 1:
            out.append(f"the crash fired but no {role} revival was recorded")
    return out


def covers(site, role: str, path: str, line: int, op: str) -> bool:
    """Whether ``site`` is the mutation ``op`` issued by ``role`` from
    ``path:line``."""
    return (role == site.role and path == site.path and op == site.method
            and site.line <= line <= site.end_line)


def arm_and_check(site, when: str, keep_key=None) -> RunOut:
    """Arm ``site`` once (``when``), run, and assert the gate. ``keep_key``
    (optional) narrows the hits counted to keys it accepts."""
    sched = scheduling_for(site)
    base = baseline(sched)
    spec = CrashSpec(site_id=site.site_id, role=site.role, path=site.path, line=site.line,
                     end_line=site.end_line, nth=1, when=when)
    run = run_once(sched, spec, keep=lambda op, key: op == site.method and (
        keep_key is None or keep_key(key)))
    fails = failures(run, base, site.role, (site.site_id, when) not in NO_REVIVAL
                     and site.qualname not in NEEDS_NOTHING)
    assert not fails, (site.site_id, when, fails)
    return run
