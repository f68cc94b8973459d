"""Crash-point sweep of the port's MoE routing program, part 2: every
Handler and executor mutation site (the event loop's take, store-backs,
done marks and post-write fence undo, the poll loop's take, store-back
and done mark, the executor's result writes), each armed once before and
once after its op; the expert-gradient writes armed again in the middle
round; and the directed test of a handler that writes a finished round's
gradient partials and dies before its post-write fence. See
``tests/_torch_moe_sweep.py`` for the run and the gate."""

import threading
import time

import pytest

import _torch_moe_sweep as S
from repro_torch.core import ANY, TupleSpace
from repro_torch.core.handler import Handler, SpeedBox
from repro_torch.core.space import CrashSpec
from repro_torch.programs.moe import EXPERT_GRAD

SITES = S.sweep_sites(roles=("handler", "executor"))


def test_the_sweep_covers_both_loops_the_fence_and_the_executor():
    names = {s.qualname for s in SITES}
    assert {"Handler._run_event", "Handler._run_poll", "Handler._undo_stale",
            "TaskExecutor._run_group"} <= names, names
    assert {S.scheduling_for(s) for s in SITES} == {"event", "poll"}


@pytest.mark.parametrize("when", ["before", "after"])
@pytest.mark.parametrize("site", SITES, ids=[s.site_id for s in SITES])
def test_a_crash_at_each_handler_site_leaves_the_run_exact(site, when):
    S.arm_and_check(site, when)


def _grad_write_of_mid_round(key) -> bool:
    """A write of round MID's expert gradients: its partials or its done
    mark (``("done", op, layer, data_id, step, ...)``)."""
    if key[0] in ("gw1", "gw2"):
        return key[1] == S.MID
    return key[0] == "done" and key[1] == EXPERT_GRAD and key[4] == S.MID


GRAD_SITES = [s for s in SITES if s.method in ("put", "put_many")
              and ("done" in s.site_id or "_run_group" in s.qualname)]


@pytest.mark.parametrize("when", ["before", "after"])
@pytest.mark.parametrize("site", GRAD_SITES, ids=[s.site_id for s in GRAD_SITES])
def test_a_crash_at_an_expert_gradient_write_of_the_middle_round(site, when):
    run = S.arm_and_check(site, when, keep_key=_grad_write_of_mid_round)
    assert run.firings, "no gradient write of the middle round fired"


def _stale_write_run(crash: bool) -> tuple[S.RunOut, dict]:
    """The order the leak needs, forced: the first handler to write a
    gradient task's partials in round MID is held just before that write
    (its inputs read, its outputs computed) until the Manager has finished
    the round (the task re-issued to the other handler, the round combined
    and cleaned); released, it writes its now stale partials and done
    mark. With ``crash`` it dies right after the done mark, before its
    post-write fence can undo them."""
    state: dict = {}

    def round_closed(space) -> bool:
        fr = space.try_read(("mstate", "frontier"))
        return (fr is not None and fr[1]["base"] > S.MID
                and space.try_read(("dy", S.MID)) is None
                and space.count(("done", ANY, ANY, S.MID, ANY, ANY, ANY, ANY, ANY)) == 0)

    def keep(op, key):
        if op != "put_many" or not _grad_write_of_mid_round(key):
            return False
        if "thread" not in state and key[0] == "gw1":
            state["thread"] = threading.current_thread()
            deadline = time.monotonic() + 10
            while not round_closed(state["space"]) and time.monotonic() < deadline:
                time.sleep(0.002)
            state["round_closed_first"] = round_closed(state["space"])
            return False
        if key[0] == "done" and threading.current_thread() is state.get("thread"):
            state["stale_done"] = True
            return crash
        return False

    site = next(s for s in SITES if s.qualname == "Handler._run_event"
                and s.method == "put_many")
    spec = CrashSpec(site_id=site.site_id, role="handler", path=site.path, line=site.line,
                     end_line=site.end_line, nth=1, when="after")
    run = S.run_once(spec=spec, keep=keep, n_handlers=2,
                     hook=lambda cloud: state.update(space=cloud.ts))
    assert state.get("round_closed_first"), "the held task's round never closed"
    assert state.get("stale_done"), "the held handler never reached its done mark"
    return run, state


def test_a_handler_that_dies_between_a_stale_write_and_its_fence_leaks_nothing():
    """The dead handler's stale partials and done mark are deleted once it
    is dead (at its revival, or when the run ends first): the run ends
    with no leaked tuple and the crash-free run's losses and weights."""
    run, _ = _stale_write_run(crash=True)
    assert run.firings, "the held handler did not die at its done mark"
    # Two handlers: the survivor can finish the run before the daemon's
    # poll sees the death, so a revival is not required here.
    fails = S.failures(run, S.baseline("event"), "handler", revival_expected=False)
    assert not fails, fails
    assert run.stale_reaped >= 3, run.stale_reaped   # its gw1, gw2 and done mark


def test_a_live_handler_undoes_its_own_stale_write():
    """The same stale write by a handler that lives on: its post-write
    fence undoes it, and the cloud reaps nothing (no handler died), so a
    fault of the fence would show as a leak."""
    run, _ = _stale_write_run(crash=False)
    assert not run.firings and run.handler_revivals == 0
    fails = S.failures(run, S.baseline("event"), "handler", revival_expected=False)
    assert not fails, fails
    assert run.stale_reaped == 0


def test_the_fence_waits_out_the_gap_in_the_managers_frontier():
    """The Manager's checkpoint deletes its frontier and then puts the new
    one. Where a Manager has run (its epoch is in the space) a fence read
    in that gap waits for the frontier; with no Manager it reads -inf."""
    ts = TupleSpace()
    handler = Handler(ts, "h0", SpeedBox(1.0))
    rt = type("RT", (), {"space": ts})()
    assert handler._fence_base(rt) == float("-inf")
    ts.put(("mstate", "epoch"), 1)
    threading.Timer(0.2, lambda: ts.put(("mstate", "frontier"), {"base": 5})).start()
    t0 = time.monotonic()
    assert handler._fence_base(rt) == 5.0
    assert time.monotonic() - t0 >= 0.15
    ts.put(("mstate", "finished"), True)
    assert handler._fence_base(rt) == float("inf")
