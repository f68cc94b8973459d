"""The twin of ``examples/acan_jax_train.py`` (``examples/torch_acan_jax_train.py``)
against the reference, on the CPU: its run is the reference example's
(``ACANTrainConfig`` field for field), the port's ``ACANStepRunner`` on
reduced deepseek_v2_lite_16b (MLA and a MoE, float32) gives the reference
runner's losses and final weights from the same ``("params", 0)`` within
1e-4, and a run with the example's handler crashes equals the crash-free
run bit for bit, each version committed once, with no protocol violation
and no leak. No assertion reads a wall clock."""

import ast
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import numpy as np

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro.ts_exec.step_runner import ACANStepRunner as JaxRunner
from repro.ts_exec.step_runner import ACANTrainConfig as JaxTrainConfig
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig

ARCH = "deepseek_v2_lite_16b"
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _twin():
    """The twin example's module (its ``train_config``)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module("torch_acan_jax_train")


def _reference_example_kwargs() -> dict:
    """The keyword arguments of the ``ACANTrainConfig(...)`` call in the
    reference example, read from its source."""
    tree = ast.parse((EXAMPLES / "acan_jax_train.py").read_text())
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "ACANTrainConfig"]
    return {kw.arg: (ast.literal_eval(kw.value) if kw.arg != "ts_backend" else None)
            for kw in call.keywords}


def _clean(res, steps: int) -> None:
    assert res.param_versions == steps
    assert len(res.losses) == steps and all(np.isfinite(res.losses))
    assert res.ts_violations == 0 and res.ts_leaks == {}


def test_the_twin_runs_the_reference_example_config():
    """Field for field the reference example's run, on the reduced config
    of both packages."""
    want = _reference_example_kwargs()
    assert want["handler_crash_prob"] == 0.25 and want["steps"] == 8
    got = dataclasses.asdict(_twin().train_config())
    assert got == dataclasses.asdict(ACANTrainConfig(**want))
    assert dataclasses.asdict(get_config(ARCH, True)) == \
        dataclasses.asdict(jax_get_config(ARCH, True))


def test_runner_matches_the_reference_runner_on_reduced_deepseek():
    """The example's handlers and microbatches (4 x 2 x 32 tokens), 3
    steps, no crashes, from the reference's initial weights in both
    spaces: losses and every final weight within 1e-4."""
    steps = 3
    run = dict(_reference_example_kwargs(), steps=steps, handler_crash_prob=0.0,
               ts_backend="checked+local")
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    ref = JaxRunner(jcfg, JaxTrainConfig(**run))
    ref.ts.put(("params", 0), jparams)
    want = ref.run()
    want_params = {k: np.asarray(v) for k, v in
                   _flatten_with_paths(ref.ts.try_read(("params", steps))[1]).items()}
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams).items()}
    runner = ACANStepRunner(tcfg, _twin().train_config(**run), device="cpu")
    runner.ts.put(("params", 0), params_from_numpy(flat, tcfg, "cpu"))
    got = runner.run()
    got_params = {k: v.detach().numpy()
                  for k, v in _flatten(runner.ts.try_read(("params", steps))[1]).items()}
    _clean(got, steps)
    _clean(want, steps)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got_params.keys() == want_params.keys()
    for k, w in want_params.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got_params[k], w, rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_the_example_crashes_leave_losses_and_weights_as_they_were():
    """The example's run (crash probability 0.25 a task) at 4 steps, a
    first deadline of 2 s: crashed tasks are re-issued and recomputed from
    (params, step, micro), so the run equals the crash-free run bit for
    bit; the loss falls."""
    cfg = get_config(ARCH, True)
    runs = []
    for crash in (0.0, 0.25):
        runner = ACANStepRunner(cfg, _twin().train_config(
            "checked+local", steps=4, timeout=2.0, handler_crash_prob=crash), device="cpu")
        res = runner.run()
        _clean(res, 4)
        runs.append((res, {k: v.detach().numpy() for k, v in
                           _flatten(runner.ts.try_read(("params", 4))[1]).items()}))
    (clean, clean_params), (crashed, crashed_params) = runs
    assert clean.crashes == 0 and crashed.crashes + crashed.reissues >= 1
    assert crashed.losses == clean.losses and clean.losses[-1] < clean.losses[0]
    assert all(np.array_equal(crashed_params[k], v) for k, v in clean_params.items())
