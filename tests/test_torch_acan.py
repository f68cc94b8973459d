"""The port's ACAN runtime against the reference's, on the CPU.

Reduced smollm_360m in float32 trained by the two packages' ``ACANStepRunner``
(microbatch-gradient tasks on Manager/Handler threads over the tuple space)
from the same ``("params", 0)``: losses and final params within 1e-4. Within
the port, a run with injected handler crashes gives the crash-free run's
losses and params bit for bit. Also: the torch-SGD key protocol is the
reference's, ``_values_match`` compares tensors by value, and the
tuple-space and crash-site lints pass over the port.

No assertion reads a wall clock; every blocking call of the runtime has a
timeout.
"""

import dataclasses
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.base import get_config as jax_get_config
from repro.core.handler import _values_match as ref_values_match
from repro.models import model as JM
from repro.programs.jax_sgd import KEY_SCHEMAS
from repro.ts_exec.step_runner import ACANStepRunner as JaxRunner
from repro.ts_exec.step_runner import ACANTrainConfig as JaxTrainConfig
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.handler import _values_match
from repro_torch.programs.torch_sgd import TorchSGDProgram
from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig, step_seconds

REPO = Path(__file__).resolve().parents[1]
ARCH = "smollm_360m"
RUN = dict(n_handlers=3, n_micro=3, micro_batch=2, seq=32, seed=0, lr=0.05,
           ts_backend="checked+local")


def _cfgs():
    return (dataclasses.replace(jax_get_config(ARCH, reduced=True), param_dtype="float32"),
            dataclasses.replace(get_config(ARCH, reduced=True), param_dtype="float32"))


def _port_run(steps: int, crash: float, timeout: float, flat=None):
    """(result, final params flattened to numpy) of the port's runner."""
    cfg = _cfgs()[1]
    runner = ACANStepRunner(cfg, ACANTrainConfig(steps=steps, handler_crash_prob=crash,
                                                 timeout=timeout, **RUN), device="cpu")
    if flat is not None:
        runner.ts.put(("params", 0), params_from_numpy(flat, cfg, "cpu"))
    res = runner.run()
    final = runner.ts.try_read(("params", steps))[1]
    return res, {k: v.detach().numpy() for k, v in _flatten(final).items()}


def _clean(res, steps: int) -> None:
    assert res.param_versions == steps
    assert len(res.losses) == steps and all(np.isfinite(res.losses))
    assert res.ts_violations == 0 and res.ts_leaks == {}


def test_runner_matches_the_reference_runner():
    """3 handlers, 3 microbatches of 2 x 32 tokens, 4 SGD steps, no
    crashes, from the reference's initial weights in both spaces."""
    jcfg, _ = _cfgs()
    steps = 4
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams).items()}
    ref = JaxRunner(jcfg, JaxTrainConfig(steps=steps, timeout=20.0, **RUN))
    ref.ts.put(("params", 0), jparams)
    want = ref.run()
    want_params = {k: np.asarray(v) for k, v in
                   _flatten_with_paths(ref.ts.try_read(("params", steps))[1]).items()}
    got, got_params = _port_run(steps, 0.0, 20.0, flat)
    _clean(got, steps)
    _clean(want, steps)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got_params.keys() == want_params.keys()
    for k, w in want_params.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got_params[k], w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)


def test_crashes_leave_the_losses_and_params_as_they_were():
    """The paper's checkpoint-free recovery: crashed tasks are re-issued and
    recomputed from (params, step, micro), so the run equals the crash-free
    run bit for bit."""
    clean, clean_params = _port_run(4, 0.0, 2.0)
    crashed, crashed_params = _port_run(4, 0.25, 2.0)
    _clean(clean, 4)
    _clean(crashed, 4)
    assert clean.crashes == 0 and crashed.crashes >= 1
    assert crashed.losses == clean.losses
    assert all(np.array_equal(crashed_params[k], v) for k, v in clean_params.items())


def test_acan_step_runner_trains_and_survives_crashes():
    """Twin of the reference's ``tests/test_elastic_ts_exec.py`` test of the
    same name."""
    cfg = get_config(ARCH, reduced=True)
    runner = ACANStepRunner(cfg, ACANTrainConfig(
        n_handlers=3, n_micro=3, micro_batch=2, seq=32, steps=6, lr=0.05,
        timeout=20.0, handler_crash_prob=0.25, seed=0), device="cpu")
    res = runner.run()
    assert len(res.losses) == 6
    assert res.param_versions == 6          # exactly-once commits
    assert res.losses[-1] < res.losses[0]   # it actually learns
    assert all(np.isfinite(l) for l in res.losses)
    assert res.crashes + res.reissues >= 1


def test_key_protocol_is_the_reference_protocol_with_the_handler_reading_gpart():
    """Field for field the reference's ``KEY_SCHEMAS``, except that the
    handler is also a declared consumer of ``gpart``."""
    program = TorchSGDProgram(_cfgs()[1], steps=1, device="cpu")
    got = [dataclasses.asdict(s) for s in program.key_schemas()]
    want = [dataclasses.asdict(s) for s in KEY_SCHEMAS]
    assert [s["subject"] for s in got] == [s["subject"] for s in want] == ["params", "gpart"]
    assert got[1]["consumers"] == want[1]["consumers"] | {"handler"} == {"manager", "handler"}
    got[1]["consumers"] = want[1]["consumers"]
    assert got == want


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_the_late_write_undo_reads_gpart_as_the_handler(pkg):
    """``Handler._undo_stale`` reads a stale duplicate's ``gpart`` back as
    the handler before deleting it. Under the reference's protocol that
    read is a role violation; the port declares the handler a consumer."""
    if pkg == "reference":
        from repro.core import space
        schemas = KEY_SCHEMAS
    else:
        from repro_torch.core import space
        schemas = TorchSGDProgram(_cfgs()[1], steps=1, device="cpu").key_schemas()
    ts = space.TupleSpace(backend="checked+local")
    checked = space.find_checked(ts.backend)
    checked.registry.register_many(space.CONTROL_SCHEMAS + tuple(schemas))
    with space.role("executor"):
        ts.put(("gpart", 0, 0), (1.0, {}))
    with space.role("handler"):
        assert ts.try_read(("gpart", 0, 0)) is not None
        assert ts.delete(("gpart", 0, 0)) == 1
    report = checked.protocol_report()
    if pkg == "reference":
        assert report["violations"] == 1
        assert "handler is not a declared consumer of 'gpart'" in report["violation_samples"][0]
    else:
        assert report["violations"] == 0


def test_late_duplicates_break_no_protocol_rule():
    """Timeouts far below a round's time: every round times out and is
    re-issued, so duplicates finish after their round closed and undo
    their writes. The run still commits each version once, with no
    protocol violation and no leak."""
    cfg = _cfgs()[1]
    runner = ACANStepRunner(cfg, ACANTrainConfig(
        n_handlers=4, n_micro=4, micro_batch=2, seq=64, steps=3, timeout=0.02,
        ts_backend="checked+local"), device="cpu")
    res = runner.run()
    assert res.reissues > 0
    _clean(res, 3)


def test_run_returns_only_after_every_handler_has_stopped():
    """The first gradient is held until its task was re-issued and the
    duplicate started; the duplicate is still computing when the version
    commits. ``run()`` waits for it, so no gradient (no kernel launch) is in
    flight once it returns. Each step's seconds come from the ledger."""
    cfg = _cfgs()[1]
    runner = ACANStepRunner(cfg, ACANTrainConfig(
        n_handlers=2, n_micro=1, micro_batch=2, seq=32, steps=1, timeout=0.3,
        ts_backend="checked+local"), device="cpu")
    runner.warm_up()
    grad, lock, started = runner.program.grad, threading.Lock(), threading.Event()
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
            time.sleep(3.0)          # outlasts the commit by seconds
        try:
            return grad(params, batch)
        finally:
            with lock:
                live.pop()

    runner.program.grad = held_grad
    t0 = time.time()
    res = runner.run()
    assert len(calls) >= 2 and res.reissues >= 1
    assert live == []
    _clean(res, 1)
    steps = step_seconds(runner, t0)
    assert len(steps) == 1 and steps[0] > 0


def test_handlers_compute_one_gradient_at_a_time(monkeypatch):
    """Three handlers take the three microbatch tasks of a round together,
    but their gradients run one after another: the program holds a lock
    while one gradient launches. Each loss evaluation pauses a little so
    that gradients left to interleave would overlap."""
    from repro_torch.programs import torch_sgd

    lock, live, peak = threading.Lock(), [0], [0]
    train_loss = torch_sgd.M.train_loss

    def counted(*args, **kw):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        try:
            time.sleep(0.05)
            return train_loss(*args, **kw)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(torch_sgd.M, "train_loss", counted)
    res, _ = _port_run(2, 0.0, 20.0)
    _clean(res, 2)
    assert res.reissues == 0
    assert peak[0] == 1 and live[0] == 0


def _t(*v, dtype=torch.float32):
    return torch.tensor(v, dtype=dtype)


@pytest.mark.parametrize("a, b, want", [
    (_t(1.0, 2.0), _t(1.0, 2.0), True),
    (_t(1.0, 2.0), _t(1.0, 3.0), False),
    (_t(1.0, 2.0), _t(1.0, 2.0, dtype=torch.bfloat16), False),
    (_t(1.0, 2.0), _t(1.0, 2.0).reshape(2, 1), False),
    (_t(1.0, 2.0), np.array([1.0, 2.0], np.float32), False),
    ({"w": [_t(1.0, 2.0)], "b": _t(3.0)}, {"w": [_t(1.0, 2.0)], "b": _t(3.0)}, True),
    ({"w": [_t(1.0, 2.0)], "b": _t(3.0)}, {"w": [_t(1.0, 2.5)], "b": _t(3.0)}, False),
    ((0.5, {"w": _t(1.0, 2.0)}), (0.5, {"w": _t(1.0, 2.0)}), True),
    ((0.5, {"w": _t(1.0, 2.0)}), (0.25, {"w": _t(1.0, 2.0)}), False),
])
def test_values_match_compares_tensors_by_value(a, b, want):
    assert _values_match(a, b) is want
    assert _values_match(b, a) is want


def test_the_reference_values_match_raises_on_equal_tensors():
    """The fault the port repairs: two equal multi-element tensors reach
    ``bool(a == b)``, which raises rather than answering."""
    with pytest.raises(RuntimeError):
        ref_values_match(_t(1.0, 2.0), _t(1.0, 2.0))


@pytest.mark.parametrize("lint", ["ts_lint", "crash_lint"])
def test_lints_pass_over_the_port(lint):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import importlib
    assert importlib.import_module(f"tools.{lint}").main([str(REPO / "src" / "repro_torch")]) == 0
