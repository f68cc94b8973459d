"""The port's MoE routing program (``repro_torch.programs.moe``) against the
reference's, on the CPU.

Each op body (route, expert forward, expert gradient) gets round 0's
tuples of the reference's program, as numpy arrays there and as tensors
here, and must give the reference's outputs at 2e-4 (the routed expert
ids exactly). A cloud run of the port's program follows the reference's
loss history within 1e-5 relative and its expert weights within 1e-5 of
their largest entry. Then twins of the reference's six MoE tests of
``tests/test_programs.py`` and of its cloud tests of
``tests/test_multitenant.py`` (the MLP beside the MoE on one space and one
fleet, per-tenant faults and caps, cursor recovery, result collection,
history caps, the adaptive pouch). Parameters that differ: every program
and cloud runs on ``device="cpu"``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core.executor import TaskExecutor as RefExecutor
from repro.programs import moe as ref_moe
from repro_torch.core import (ACANCloud, ANY, CloudConfig, FaultPlan, GLOBAL_OPS,
                              LayerSpec, Manager, ManagerConfig, MLPProgram,
                              MoERoutingProgram, MultiCloudResult, ScopedSpace,
                              TaskDesc, TimeoutController, TupleSpace)
from repro_torch.core.executor import ExecContext, TaskExecutor
from repro_torch.core.handler import Handler, HandlerTenant, SpeedBox
from repro_torch.core.space import NsSubject
from repro_torch.programs import moe

CAP = 256.0


def _tensorized(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    if isinstance(v, dict):
        return {k: _tensorized(x) for k, x in v.items()}
    return v


def _ref_round0(seed: int = 0):
    """The reference program's space after round 0's route and expert
    stages and the dy combine: every tuple the three op bodies read."""
    prog = ref_core.MoERoutingProgram(steps=2, seed=seed)
    ts = ref_core.TupleSpace()
    prog.setup(ts)
    RefExecutor(ts).execute_batch(prog.stage_tasks(ts, 0, "route"))
    prog._combine_route(ts, 0)
    RefExecutor(ts).execute_batch(
        [p for t in prog.expert_stage_tasks(ts, 0) for p in ref_core.GLOBAL_OPS.partition(t, CAP)])
    prog._combine_expert(ts, 0, 0)
    return prog, ts


def _groups(prog, ts):
    def parts(stage):
        return [p for t in prog.stage_tasks(ts, 0, stage)
                for p in ref_core.GLOBAL_OPS.partition(t, CAP)]
    return ([parts("route")]
            + [g for e in range(prog.E) for s in ("expert", "grad") if (g := parts(f"{s}_{e}"))])


@pytest.mark.parametrize("seed", [0, 3])
def test_op_bodies_match_the_reference(seed):
    ref_prog, ref_ts = _ref_round0(seed)
    port_ts = TupleSpace()
    for k, v in ref_ts.snapshot().items():
        port_ts.put(k, _tensorized(v))
    ops = {moe.ROUTE: ref_moe.ROUTE, moe.EXPERT_FWD: ref_moe.EXPERT_FWD,
           moe.EXPERT_GRAD: ref_moe.EXPERT_GRAD}
    assert set(ops) == set(ops.values())
    seen = set()
    for group in _groups(ref_prog, ref_ts):
        want = dict(ref_core.GLOBAL_OPS.resolve(group[0].op).batch_fn(
            ref_core.executor.ExecContext(ref_ts), group))
        got = dict(GLOBAL_OPS.resolve(group[0].op).batch_fn(ExecContext(port_ts), group))
        assert got.keys() == want.keys()
        seen.add(group[0].op)
        for k, v in got.items():
            flat = v if isinstance(v, dict) else {"": v}
            ref = want[k] if isinstance(v, dict) else {"": want[k]}
            assert flat.keys() == ref.keys()
            for f, x in flat.items():
                assert isinstance(x, torch.Tensor) and x.dtype == torch.from_numpy(ref[f]).dtype
                if x.dtype == torch.int64:
                    np.testing.assert_array_equal(x.numpy(), ref[f])
                else:
                    np.testing.assert_allclose(x.numpy(), ref[f], rtol=0, atol=2e-4)
    assert seen == set(ops)


def test_setup_publishes_the_reference_tuples_on_the_device():
    ref, port = ref_core.TupleSpace(), TupleSpace()
    ref_core.MoERoutingProgram(seed=2).setup(ref)
    MoERoutingProgram(seed=2, device="cpu").setup(port)
    want, got = ref.snapshot(), port.snapshot()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v)
        else:
            assert got[k] == v


def test_key_schemas_and_stage_effects_are_the_references():
    assert [dataclasses.asdict(s) for s in moe.KEY_SCHEMAS] == \
        [dataclasses.asdict(s) for s in ref_moe.KEY_SCHEMAS]
    port, ref = MoERoutingProgram(device="cpu"), ref_core.MoERoutingProgram()
    for rnd in (0, 3):
        assert port.stage_names(rnd) == ref.stage_names(rnd)
        assert port.stage_deps(rnd) == ref.stage_deps(rnd)
        # The port's expert commit writes each weight and its version with
        # one put_many, which replaces them, where the reference deletes
        # and re-puts: its grad stages declare no deletes of them.
        want = {stage: tuple(e for e in effects if not (
            stage.startswith("grad_") and e.mode == "delete"
            and e.subject in ("we1", "we2", "wever")))
            for stage, effects in ref.stage_effects(rnd).items()}
        assert repr(port.stage_effects(rnd)) == repr(want)
    for op in (moe.ROUTE, moe.EXPERT_FWD, moe.EXPERT_GRAD):
        for n in (8, 13, 17, 40):
            t, rt = TaskDesc(op, 1, 0, 0, 0, 0, 0, n), ref_core.TaskDesc(op, 1, 0, 0, 0, 0, 0, n)
            assert GLOBAL_OPS.cost(t) == ref_core.GLOBAL_OPS.cost(rt)
            assert [dataclasses.astuple(p) for p in GLOBAL_OPS.partition(t, CAP)] == \
                [dataclasses.astuple(p) for p in ref_core.GLOBAL_OPS.partition(rt, CAP)]


def _moe_cfg(pkg=None, **kw):
    base = dict(n_handlers=3, task_cap=256.0, pouch_size=64,
                time_scale=1e-6, initial_timeout=0.1,
                fault_plan=(pkg or ref_core).FaultPlan(interval=1e9), wall_limit=120.0)
    if pkg is None:
        base["device"] = "cpu"
    base.update(kw)
    return (CloudConfig if pkg is None else pkg.CloudConfig)(**base)


def test_the_trajectory_matches_the_references():
    """16 steps at the example's size, fault-free: the reference's loss
    history within 1e-5 relative, its expert weights within 1e-5 of their
    largest entry."""
    ref_cloud = ref_core.ACANCloud(_moe_cfg(ref_core), program=ref_core.MoERoutingProgram(
        steps=16, seed=0))
    ref = ref_cloud.run()
    cloud = ACANCloud(_moe_cfg(), program=MoERoutingProgram(steps=16, seed=0, device="cpu"))
    res = cloud.run()
    want, got = [l for _, l in ref.loss_history], [l for _, l in res.loss_history]
    assert len(got) == len(want) == 16
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for e in range(4):
        for w in ("we1", "we2"):
            a, b = cloud.ts.try_read((w, e))[1], ref_cloud.ts.try_read((w, e))[1]
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    assert res.ledger_ok and res.manager_revivals == 0


# ------------------------------------- twins of tests/test_programs.py (MoE)
def test_moe_program_trains_decreasing_loss():
    prog = MoERoutingProgram(steps=12, seed=0, device="cpu")
    res = ACANCloud(_moe_cfg(), program=prog).run()
    losses = [l for _, l in res.loss_history]
    assert len(losses) == 12
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert res.ledger_ok
    assert res.manager_revivals == 0


def test_moe_program_survives_manager_and_handler_crashes():
    """The non-regular program completes under an exp3-style plan (Manager
    AND all Handlers crash each interval with p=1.0) via daemon revival,
    and still learns — here also with the fault-free run's losses and
    weights bit for bit."""
    clean_cloud = ACANCloud(_moe_cfg(), program=MoERoutingProgram(steps=12, seed=0,
                                                                   device="cpu"))
    clean = [l for _, l in clean_cloud.run().loss_history]
    prog = MoERoutingProgram(steps=12, seed=0, device="cpu")
    cloud = ACANCloud(_moe_cfg(
        fault_plan=FaultPlan(interval=0.1, speed_levels=(1.0, 5.0, 10.0),
                             p_speed_change=1.0, p_handler_crash=1.0,
                             p_manager_crash=1.0, seed=1),
        ts_backend="checked+local"), program=prog)
    res = cloud.run()
    losses = [l for _, l in res.loss_history]
    assert len(losses) == 12              # completed despite the crashes
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert res.manager_revivals >= 1
    assert res.handler_revivals >= 1
    assert res.ledger_ok
    assert losses == clean
    assert all(torch.equal(cloud.ts.try_read((w, e))[1], clean_cloud.ts.try_read((w, e))[1])
               for e in range(prog.E) for w in ("we1", "we2"))
    assert res.ts_violations == 0 and res.ts_leaks == {}


def test_moe_task_sizes_are_irregular():
    """The expert stage's task costs are data-dependent: a hot expert's
    prototype task costs more than a cold expert's — and are the
    reference's."""
    prog = MoERoutingProgram(steps=2, seed=0, device="cpu")
    expert_tasks = prog.probe_expert_tasks()
    costs = [GLOBAL_OPS.cost(t) for t in expert_tasks]
    assert len(costs) >= 2
    assert len(set(costs)) > 1, costs     # irregular — not uniform
    total_slots = sum(t.n for t in expert_tasks)
    assert total_slots == prog.B * prog.k
    assert [dataclasses.astuple(t) for t in expert_tasks] == \
        [dataclasses.astuple(t) for t in ref_core.MoERoutingProgram(steps=2, seed=0)
         .probe_expert_tasks()]


def test_moe_dispatch_is_revival_deterministic():
    """stage_tasks is a pure function of TS state: a 'revived' Manager
    (fresh program call on the same TS) derives identical expert tasks."""
    prog = MoERoutingProgram(steps=2, seed=3, device="cpu")
    ts = TupleSpace()
    prog.setup(ts)
    mgr = Manager(ts=ts, program=prog, cfg=ManagerConfig(task_cap=1e9))
    TaskExecutor(ts).execute_batch(prog.stage_tasks(ts, 0, "route"))
    prog.combine(ts, 0, "route", mgr)
    first = prog.expert_stage_tasks(ts, 0)
    prog2 = MoERoutingProgram(steps=2, seed=3, device="cpu")     # the revived instance
    prog2.combine(ts, 0, "route", mgr)             # idempotent re-run
    assert prog2.expert_stage_tasks(ts, 0) == first


def test_moe_route_combine_resumes_after_partial_crash():
    """The route combine's idempotency guard is its LAST-written tuple
    (expert 0's dispatch), so a Manager that died mid-combine leaves the
    guard unset and the revived combine redoes everything."""
    prog = MoERoutingProgram(steps=1, seed=0, device="cpu")
    ts = TupleSpace()
    prog.setup(ts)
    TaskExecutor(ts).execute_batch(prog.stage_tasks(ts, 0, "route"))
    prog._combine_route(ts, 0)
    full = {e: ts.try_read(("disp", 0, e))[1] for e in range(prog.E)}
    # Simulate a crash mid-combine: the guard tuple is missing, the rest
    # of the dispatch lists landed.
    ts.delete(("disp", 0, 0))
    prog._combine_route(ts, 0)          # the revived Manager's re-run
    for e in range(prog.E):
        hit = ts.try_read(("disp", 0, e))
        assert hit is not None
        assert all(torch.equal(hit[1][f], full[e][f]) for f in ("ids", "gates"))
    assert len(prog.expert_stage_tasks(ts, 0)) >= 1


def test_moe_respects_history_limit():
    prog = MoERoutingProgram(steps=10, seed=0, device="cpu")
    res = ACANCloud(_moe_cfg(history_limit=4), program=prog).run()
    steps = [s for s, _ in res.loss_history]
    assert steps == list(range(6, 10))    # trimmed to the newest 4


# ---------------------------- twins of tests/test_multitenant.py's cloud tests
BACKEND_SPECS = ["local", "sharded:4"]


def _base(**kw):
    base = dict(layers=[LayerSpec(16, 16), LayerSpec(16, 1)], n_handlers=3,
                epochs=1, n_samples=6, task_cap=32.0, pouch_size=64,
                lr=0.05, time_scale=1e-6, initial_timeout=0.1,
                fault_plan=FaultPlan(interval=1e9), seed=0, wall_limit=120.0,
                device="cpu")
    base.update(kw)
    return CloudConfig(**base)


def _programs(cfg, moe_steps=8):
    return [MLPProgram(cfg.layers, epochs=cfg.epochs,
                       n_samples=cfg.n_samples, seed=cfg.seed, device="cpu"),
            MoERoutingProgram(steps=moe_steps, seed=0, device="cpu")]


@pytest.mark.parametrize("backend", BACKEND_SPECS)
def test_two_programs_one_space_shared_fleet(backend):
    """MLP + MoE co-resident: both complete, per-program results are
    independent, and the MLP trajectory is bit-identical to the
    single-tenant run of the same config."""
    single = ACANCloud(_base(ts_backend=backend)).run()
    ref = [l for _, l in single.loss_history]

    cfg = _base(ts_backend=f"instrumented:{backend}")
    cloud = ACANCloud(cfg, programs=_programs(cfg))
    multi = cloud.run()
    assert isinstance(multi, MultiCloudResult)
    assert set(multi.per_program) == {"mlp", "moe_routing"}
    mlp_losses = [l for _, l in multi.per_program["mlp"].loss_history]
    moe_losses = [l for _, l in multi.per_program["moe_routing"].loss_history]
    assert mlp_losses == ref                      # bit-identical
    assert len(moe_losses) == 8
    assert np.mean(moe_losses[-3:]) < np.mean(moe_losses[:3])
    assert multi.ledger_ok
    dm = cloud.ts.backend.delete_metrics()
    assert cloud.ts.stats()["instr_widened_deletes"] == 0
    assert dm.get("task", {"removed": 0})["removed"] == 0
    assert NsSubject("mlp", "task") in dm
    assert NsSubject("moe_routing", "task") in dm


def test_cotenants_complete_under_exp3_fault_plan():
    """Co-resident MLP + MoE under an exp3-style plan: both programs
    complete via revival, the MLP trajectory still matches single-tenant
    bit-for-bit, and no delete could cross a namespace."""
    plan = FaultPlan(interval=0.1, speed_levels=(1.0, 5.0, 10.0),
                     p_speed_change=1.0, p_handler_crash=1.0,
                     p_manager_crash=1.0, seed=1)
    single = ACANCloud(_base()).run()
    ref = [l for _, l in single.loss_history]

    cfg = _base(ts_backend="instrumented:local", fault_plan=plan,
                time_scale=2e-5)
    cloud = ACANCloud(cfg, programs=_programs(cfg))
    multi = cloud.run()
    mlp = multi.per_program["mlp"]
    moe_res = multi.per_program["moe_routing"]
    assert [l for _, l in mlp.loss_history] == ref
    assert len(moe_res.loss_history) == 8             # completed despite crashes
    assert multi.manager_revivals >= 1
    assert multi.handler_revivals >= 1
    assert mlp.manager_revivals + moe_res.manager_revivals == multi.manager_revivals
    assert cloud.ts.stats()["instr_widened_deletes"] == 0
    assert cloud.ts.backend.delete_metrics().get(
        "task", {"removed": 0})["removed"] == 0
    assert multi.ledger_ok


def test_poll_equals_event_losses_per_program():
    """Scheduling mode must not perturb either tenant's numerics."""
    results = {}
    for scheduling in ("event", "poll"):
        cfg = _base(scheduling=scheduling)
        multi = ACANCloud(cfg, programs=_programs(cfg, moe_steps=6)).run()
        results[scheduling] = {
            ns: [l for _, l in r.loss_history]
            for ns, r in multi.per_program.items()}
    for ns in ("mlp", "moe_routing"):
        ev, po = results["event"][ns], results["poll"][ns]
        assert len(ev) == len(po) and len(ev) > 0
        np.testing.assert_allclose(ev, po, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("backend", BACKEND_SPECS)
def test_independent_cursor_recovery_per_tenant(backend):
    """Crashing ONE tenant's Manager mid-run leaves the other tenant's
    cursor/epoch untouched; the revived Manager resumes from its own
    namespace and both complete."""
    ts = TupleSpace(backend=backend)
    progs = {
        "a": MLPProgram([LayerSpec(8, 8), LayerSpec(8, 1)], epochs=1,
                        n_samples=4, seed=0, device="cpu"),
        "b": MLPProgram([LayerSpec(8, 8), LayerSpec(8, 1)], epochs=1,
                        n_samples=4, seed=1, device="cpu"),
    }
    spaces = {ns: ScopedSpace(ts, ns) for ns in progs}
    stop = threading.Event()
    crash_a = threading.Event()
    handlers = []
    for i in range(2):
        h = Handler(ts=ts, name=f"h{i}", speed=SpeedBox(1.0), capacity=64.0,
                    time_scale=1e-6, stop_event=stop,
                    tenants={ns: HandlerTenant(spaces[ns], p.registry)
                             for ns, p in progs.items()})
        th = threading.Thread(target=h.run, daemon=True)
        th.start()
        handlers.append(th)

    def run_mgr(ns, crash_event):
        mgr = Manager(ts=spaces[ns], program=progs[ns],
                      cfg=ManagerConfig(task_cap=64.0, initial_timeout=0.2),
                      crash_event=crash_event, stop_event=stop)
        try:
            mgr.run()
        except Exception:
            pass

    crash_a.set()                                 # A dies on its first check
    ta = threading.Thread(target=run_mgr, args=("a", crash_a), daemon=True)
    tb = threading.Thread(target=run_mgr, args=("b", threading.Event()),
                          daemon=True)
    ta.start(); tb.start()
    ta.join(timeout=30.0)
    assert not ta.is_alive()                      # A crashed
    ta2 = threading.Thread(target=run_mgr, args=("a", threading.Event()),
                           daemon=True)
    ta2.start()
    ta2.join(timeout=60.0); tb.join(timeout=60.0)
    assert spaces["a"].try_read(("mstate", "finished")) is not None
    assert spaces["b"].try_read(("mstate", "finished")) is not None
    assert spaces["a"].try_read(("mstate", "epoch"))[1] == 2
    assert spaces["b"].try_read(("mstate", "epoch"))[1] == 1
    la = [v for _, v in sorted(
        (k[1], spaces["a"].try_read(k)[1])
        for k in spaces["a"].keys(("losshist", ANY)))]
    lb = [v for _, v in sorted(
        (k[1], spaces["b"].try_read(k)[1])
        for k in spaces["b"].keys(("losshist", ANY)))]
    assert len(la) == 4 and len(lb) == 4 and la != lb
    stop.set()
    for th in handlers:
        th.join(timeout=2.0)


def test_collect_survives_vanishing_history_tuple():
    """A losshist tuple listed by keys() can be trimmed before try_read —
    collection must skip it, not crash on None[1]."""
    cfg = _base()
    cloud = ACANCloud(cfg, programs=[MLPProgram(
        cfg.layers, epochs=1, n_samples=4, seed=0, device="cpu")])
    res = cloud.run()
    space = cloud.spaces[0]

    class Vanishing:
        """Space view whose try_read loses each losshist key once."""

        def __init__(self, inner):
            self._inner = inner
            self._dropped = set()

        def keys(self, pattern):
            return self._inner.keys(pattern)

        def try_read(self, pattern):
            if (pattern[0] in ("losshist", "thist")
                    and pattern not in self._dropped):
                self._dropped.add(pattern)
                return None
            return self._inner.try_read(pattern)

    class Daemon:
        manager_revivals_by = [0]
        handler_revivals = 0
        speed_changes = 0

    cloud.spaces[0] = Vanishing(space)
    try:
        res2 = cloud._collect(0, Daemon(), 0.0)
    finally:
        cloud.spaces[0] = space
    assert res2.loss_history == [] and res2.timeout_history == []
    assert len(res.per_program["mlp"].loss_history) == 4


def test_timeout_controller_history_is_capped():
    """History must not exceed history_limit, and the Manager wires
    ManagerConfig.history_limit in."""
    tc = TimeoutController(history_limit=5)
    for i in range(50):
        tc.update(True, 0.01, 1.0)
    assert len(tc.history) == 5
    tc0 = TimeoutController(history_limit=0)      # 0 = unbounded
    for _ in range(20):
        tc0.update(False, 0.01, 0.5)
    assert len(tc0.history) == 20
    mgr = Manager(ts=TupleSpace(), program=MLPProgram(
        [LayerSpec(4, 4)], epochs=1, n_samples=1, device="cpu"),
        cfg=ManagerConfig(history_limit=7))
    assert mgr.controller.history_limit == 7


def test_adaptive_pouch_grows_and_shrinks_and_persists():
    from repro_torch.core import PouchController
    pc = PouchController(pouch=100)
    assert pc.update(True, 1.0) > 100             # full+done -> grow
    assert PouchController(pouch=100).update(False, 1.0) < 100
    cfg = _base(adaptive_pouch=True, pouch_size=8)
    cloud = ACANCloud(cfg, program=MLPProgram(
        cfg.layers, epochs=1, n_samples=4, seed=0, device="cpu"))
    res = cloud.run()
    assert len(res.loss_history) == 4
    cursor = cloud.spaces[0].try_read(("mstate", "cursor"))[1]
    assert cursor["pouch"] >= 1                   # persisted for revival


def test_per_tenant_fault_plans_crash_only_the_planned_tenant():
    """Tenant-scoped crash plans ride the same daemon — only the MoE
    tenant's Manager is crashed, the MLP tenant runs fault-free and stays
    bit-identical to the single-tenant reference."""
    single = ACANCloud(_base()).run()
    ref = [l for _, l in single.loss_history]

    cfg = _base(
        time_scale=2e-5,
        fault_plan=FaultPlan(interval=1e9),       # shared plan: inert
        fault_plans={"moe_routing": FaultPlan(interval=0.1,
                                              p_manager_crash=1.0, seed=2)})
    cloud = ACANCloud(cfg, programs=_programs(cfg))
    multi = cloud.run()
    mlp = multi.per_program["mlp"]
    moe_res = multi.per_program["moe_routing"]
    assert [l for _, l in mlp.loss_history] == ref
    assert len(moe_res.loss_history) == 8             # completed via revivals
    assert mlp.manager_revivals == 0              # never crashed
    assert moe_res.manager_revivals >= 1
    assert multi.handler_revivals == 0            # fleet untouched


def test_per_tenant_config_keys_must_name_real_namespaces():
    cfg = _base(fault_plans={"mlp": FaultPlan(p_manager_crash=1.0)})
    with pytest.raises(ValueError, match="unknown namespaces"):
        ACANCloud(cfg)                            # single-program: ns ""
    cfg2 = _base(tenant_caps={"moe-routing": 2})  # typo for moe_routing
    with pytest.raises(ValueError, match="moe-routing"):
        ACANCloud(cfg2, programs=_programs(cfg2))
    cfg3 = _base(tenant_caps={"moe_routing": 2})
    ACANCloud(cfg3, programs=_programs(cfg3))


def test_zero_tenant_cap_is_rejected():
    cfg = _base(tenant_caps={"moe_routing": 0})
    with pytest.raises(ValueError, match="livelock"):
        ACANCloud(cfg, programs=_programs(cfg))


def test_the_mlp_and_the_moe_share_a_process_fleet():
    """The reference's multi-tenant example on worker processes: both
    tenants resolve their ops in the workers' built-in registry and keep
    their thread-fleet trajectories bit for bit."""
    runs = {}
    for fleet in ("thread", "process"):
        cfg = _base(fleet=fleet, n_handlers=2, ts_backend="checked+sharded:4")
        multi = ACANCloud(cfg, programs=_programs(cfg, moe_steps=6)).run()
        assert multi.ledger_ok and multi.ts_violations == 0 and multi.ts_leaks == {}
        runs[fleet] = {ns: [l for _, l in r.loss_history] for ns, r in multi.per_program.items()}
    assert runs["process"] == runs["thread"]
    assert len(runs["thread"]["moe_routing"]) == 6
