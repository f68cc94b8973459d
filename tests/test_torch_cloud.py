"""The port's ACANCloud, fault plane and paper experiments against the
reference's, on the CPU.

Experiment 1 at N = 32 (the reference's ``tests/test_acan_training.py``
config) gives the reference's loss history and final weights within 1e-5
relative. Within the port, a run under experiment 3's crashes, the
``sharded:4`` and ``checked+local`` spaces and a frontier of three stages
give the crash-free ``local`` run's losses and weights bit for bit.
``FaultPlan``/``MonitorDaemon`` fire the reference's sequence for a seed,
shared and per tenant. A two-tenant cloud (the MLP beside a reduced
smollm_360m ``TorchSGDProgram``) keeps the MLP's single-tenant trajectory
and the ``ACANStepRunner``'s losses. Also the twins of two reference tests
that are flaky under load, made exact: the straggler re-issue count and
the pouch dispatcher's balance.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import faults as ref_faults
from repro.core.handler import SpeedBox as RefSpeedBox
from repro_torch import core
from repro_torch.configs import paper_mlp
from repro_torch.configs.base import get_config
from repro_torch.core import (ACANCloud, CloudConfig, FaultPlan, LayerSpec, Manager,
                              ManagerConfig, MLPProgram, TimeoutController, TupleSpace)
from repro_torch.core import faults
from repro_torch.core.handler import Handler, SpeedBox
from repro_torch.data.pipeline import PipelineConfig, PouchDispatcher, TokenPipeline
from repro_torch.programs.torch_sgd import TorchSGDProgram
from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig

EXP3 = dict(interval=0.1, speed_levels=(1.0, 5.0, 10.0), p_speed_change=1.0,
            p_handler_crash=1.0, p_manager_crash=1.0, seed=1)


def _small_cfg(pkg, **kw):
    """``tests/test_acan_training.py::_small_cfg`` in either package."""
    base = dict(layers=[pkg.LayerSpec(32, 32), pkg.LayerSpec(32, 1)],
                n_handlers=4, epochs=2, n_samples=10, task_cap=64.0,
                pouch_size=50, lr=0.02, time_scale=1e-6,
                initial_timeout=0.1, wall_limit=120.0, seed=0,
                fault_plan=pkg.FaultPlan(interval=1e9))
    if pkg is core:
        base["device"] = "cpu"
    base.update(kw)
    return pkg.CloudConfig(**base)


def _run(pkg, **kw):
    """(losses, final weights and biases as numpy, result) of one run."""
    cloud = pkg.ACANCloud(_small_cfg(pkg, **kw))
    res = cloud.run()
    params = []
    for l in range(2):
        for name in ("w", "b"):
            v = cloud.ts.try_read((name, l))[1]
            params.append(v.numpy() if isinstance(v, torch.Tensor) else v)
    return [loss for _, loss in res.loss_history], params, res


@functools.cache
def _clean_port_run():
    return _run(core)


def test_exp1_matches_the_reference_trajectory_and_weights():
    want, want_params, _ = _run(ref_core)
    got, got_params, res = _clean_port_run()
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
    assert np.mean(got[10:]) < np.mean(got[:10])
    assert res.ledger_ok and res.manager_revivals == 0


@pytest.mark.parametrize("variant", ["exp3_crashes", "sharded:4", "checked+local",
                                     "max_inflight_stages=3"])
def test_a_variant_gives_the_crash_free_run_bit_for_bit(variant):
    kw = {"exp3_crashes": dict(fault_plan=FaultPlan(**EXP3), ts_backend="checked+local"),
          "sharded:4": dict(ts_backend="sharded:4"),
          "checked+local": dict(ts_backend="checked+local"),
          "max_inflight_stages=3": dict(max_inflight_stages=3)}[variant]
    want, want_params, _ = _clean_port_run()
    got, got_params, res = _run(core, **kw)
    assert got == want
    assert all(np.array_equal(g, w) for g, w in zip(got_params, want_params))
    assert res.ledger_ok and res.ts_violations == 0 and res.ts_leaks == {}
    if variant == "exp3_crashes":
        assert res.manager_revivals >= 1 and res.handler_revivals >= 1


# ------------------------------------------------------------- the fault plane
def _daemon(pkg, box, plan, **kw):
    return pkg.MonitorDaemon(
        plan=plan, handler_crashes=[threading.Event() for _ in range(3)],
        speed_boxes=[box(1.0) for _ in range(3)], **kw)


def _firings(d, fire) -> list:
    """After each firing: the speeds and which events are set; then clear."""
    seq = []
    for _ in range(40):
        fire(d)
        events = d.manager_crashes + d.handler_crashes
        seq.append(([b.get() for b in d.speed_boxes], [ev.is_set() for ev in events]))
        for ev in events:
            ev.clear()
    return seq + [(d.speed_changes, d.manager_crash_firings_by)]


@pytest.mark.parametrize("seed", [0, 3])
def test_a_shared_plan_fires_the_reference_sequence(seed):
    args = dict(interval=1.0, p_speed_change=0.5, p_handler_crash=0.5,
                p_manager_crash=0.5, seed=seed)
    got = _firings(_daemon(faults, SpeedBox, FaultPlan(**args)), lambda d: d._fire_faults())
    want = _firings(_daemon(ref_faults, RefSpeedBox, ref_faults.FaultPlan(**args)),
                    lambda d: d._fire_faults())
    assert got == want
    assert 5 < sum(any(ev) for _, ev in got[:-1]) < 40


@pytest.mark.parametrize("seed", [0, 3])
def test_tenant_plans_fire_the_reference_sequence(seed):
    def daemon(pkg, box):
        return _daemon(pkg, box, pkg.FaultPlan(p_manager_crash=0.5, p_handler_crash=0.5,
                                               seed=seed),
                       plans={"a": pkg.FaultPlan(p_manager_crash=0.5, seed=seed + 7)},
                       namespaces=["a", "b"],
                       manager_crashes=[threading.Event(), threading.Event()])

    def fire(d):
        d._fire_faults()
        d._fire_tenant_faults(0)
        d._fire_tenant_faults(1)

    got = _firings(daemon(faults, SpeedBox), fire)
    assert got == _firings(daemon(ref_faults, RefSpeedBox), fire)
    assert got[-1][1][0] > 5 and got[-1][1][1] > 5


def test_the_process_fleet_raises_until_it_is_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CloudConfig(fleet="process", device="cpu")
    with pytest.raises(ValueError, match="unknown fleet"):
        CloudConfig(fleet="processes", device="cpu")


def test_the_default_program_runs_on_the_configured_device(monkeypatch):
    assert ACANCloud(CloudConfig(device="cpu")).program.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ACANCloud(CloudConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ACANCloud(paper_mlp.feasibility_config())


def test_the_paper_configs_are_the_reference_configs():
    from repro.configs import paper_mlp as ref_paper

    for name in ("feasibility_config", "adaptability_config", "robustness_config"):
        got = dataclasses.asdict(getattr(paper_mlp, name)(device="cpu"))
        want = dataclasses.asdict(getattr(ref_paper, name)())
        assert got.pop("device") == "cpu"
        assert got == want, name
    assert paper_mlp.PAPER_LR == ref_paper.PAPER_LR


def test_core_exports_the_reference_names_but_moe():
    assert set(core.__all__) == set(ref_core.__all__) - {"MoERoutingProgram"}
    assert all(getattr(core, n) is not None for n in core.__all__)
    with pytest.raises(AttributeError, match="ROADMAP"):
        core.MoERoutingProgram  # noqa: B018


# ------------------------------------------------------------- two tenants
TORCH = dict(steps=3, n_micro=2, micro_batch=2, seq=32, lr=0.05, seed=0)


def _mlp_cfg(**kw):
    base = dict(layers=[LayerSpec(16, 16), LayerSpec(16, 1)], n_handlers=3, epochs=1,
                n_samples=6, task_cap=32.0, pouch_size=64, lr=0.05, time_scale=1e-6,
                initial_timeout=2.0, fault_plan=FaultPlan(interval=1e9), seed=0,
                wall_limit=120.0, device="cpu")
    base.update(kw)
    return CloudConfig(**base)


def test_two_tenants_keep_both_trajectories():
    """The MLP beside a reduced smollm_360m trained by ``TorchSGDProgram``
    on one space and one handler fleet (at most one gradient a handler
    batch), Managers and Handlers crashing at p = 0.5 every 0.15 s (seed 0
    crashes both at the first firing): the MLP's losses are its
    single-tenant run's, and the torch tenant's are ``ACANStepRunner``'s,
    bit for bit."""
    mcfg = dataclasses.replace(get_config("smollm_360m", reduced=True),
                               param_dtype="float32")
    single = [loss for _, loss in ACANCloud(_mlp_cfg()).run().loss_history]
    runner = ACANStepRunner(mcfg, ACANTrainConfig(n_handlers=3, timeout=20.0, **TORCH),
                            device="cpu").run()
    cfg = _mlp_cfg(ts_backend="checked+local", tenant_caps={"torch_sgd": 1},
                   fault_plan=FaultPlan(interval=0.15, p_handler_crash=0.5,
                                        p_manager_crash=0.5, seed=0))
    cloud = ACANCloud(cfg, programs=[
        MLPProgram(cfg.layers, epochs=cfg.epochs, n_samples=cfg.n_samples,
                   seed=cfg.seed, device="cpu"),
        TorchSGDProgram(mcfg, device="cpu", **TORCH)])
    multi = cloud.run()
    assert set(multi.per_program) == {"mlp", "torch_sgd"}
    assert [loss for _, loss in multi.per_program["mlp"].loss_history] == single
    assert [loss for _, loss in multi.per_program["torch_sgd"].loss_history] == \
        runner.losses
    assert len(runner.losses) == TORCH["steps"]
    assert multi.manager_revivals >= 1 and multi.handler_revivals >= 1
    assert multi.ledger_ok and multi.ts_violations == 0 and multi.ts_leaks == {}


# ------------------------------------------------ twins of flaky reference tests
def test_reissued_counts_only_straggler_republications():
    """Twin of the reference's test of the same name: a stage wider than
    pouch_size publishes its later pouches of first-time tasks — those must
    NOT count as re-issues. The deadline is pinned at 10 s
    (``min_timeout``): the reference's controller shrinks it to about 1.3 x
    a pouch's time, and a loaded host then fires a real timeout."""
    ts = TupleSpace()
    prog = MLPProgram([LayerSpec(16, 16), LayerSpec(16, 1)], epochs=1,
                      n_samples=2, seed=0, device="cpu")
    # task_cap 16 -> fwd_0 partitions into 16 tasks; pouch_size 4 forces
    # four first-time pouches per such stage.
    mgr = Manager(ts=ts, program=prog,
                  cfg=ManagerConfig(task_cap=16.0, pouch_size=4, initial_timeout=10.0),
                  controller=TimeoutController(timeout=10.0, min_timeout=10.0))
    stop = threading.Event()
    h = Handler(ts=ts, name="h0", speed=SpeedBox(1.0), capacity=16.0,
                lr=0.01, time_scale=1e-9, stop_event=stop)
    th = threading.Thread(target=h.run, daemon=True)
    th.start()
    mgr.run()
    stop.set()
    th.join(timeout=2.0)
    assert ts.try_read(("mstate", "finished")) is not None
    assert min(mgr.controller.history) == 10.0
    assert mgr.reissued == 0, mgr.reissued


def test_pouch_dispatcher_completes_and_balances():
    """Twin of the reference's test of the same name, without its
    wall-clock utilisation bar: every step arrives, and the workers' shares
    of the steps order with their speeds (the fastest first, so that GSS's
    large first chunks go to fast workers; 20 ms a step at speed 1, so that
    a sleep's own overhead does not blur the speeds)."""
    pipe = TokenPipeline(PipelineConfig(vocab=50, batch=2, seq=8))
    speeds = [10.0, 5.0, 1.0, 1.0]
    disp = PouchDispatcher(pipeline=pipe, n_workers=4, speeds=speeds, work_cost=2e-2)
    out = disp.run_steps(list(range(40)))
    assert sorted(out) == list(range(40))
    for s, b in out.items():
        assert np.array_equal(b["tokens"], pipe.batch_at(s)["tokens"])
    shares = [round(busy * speed / 2e-2) for busy, speed in zip(disp.stats["busy"], speeds)]
    assert sum(shares) == 40
    assert shares[0] >= shares[1] >= max(shares[2:]), shares


def test_run_returns_only_after_every_handler_has_stopped():
    """The torch tenant's first gradient is held until its task was
    re-issued and the duplicate started; each duplicate computes for 5 s,
    past the reference's 2 s join of each of the two handlers, so it is
    still running when the version commits. ``run()`` waits for it, so no
    gradient is in flight once it returns."""
    import time

    mcfg = dataclasses.replace(get_config("smollm_360m", reduced=True),
                               param_dtype="float32")
    prog = TorchSGDProgram(mcfg, steps=1, n_micro=1, micro_batch=2, seq=32, device="cpu")
    grad, lock, started = prog.grad, threading.Lock(), threading.Event()
    calls, live = [], []

    def held_grad(params, batch):
        with lock:
            calls.append(1)
            live.append(1)
            first = len(calls) == 1
        if first:
            started.wait(timeout=30.0)
        else:
            started.set()
            time.sleep(5.0)
        try:
            return grad(params, batch)
        finally:
            with lock:
                live.pop()

    prog.grad = held_grad
    res = ACANCloud(_mlp_cfg(n_handlers=2, initial_timeout=0.3,
                             ts_backend="checked+local"), program=prog).run()
    assert len(calls) >= 2 and live == []
    assert len(res.loss_history) == 1
    assert res.ts_violations == 0 and res.ts_leaks == {}
