"""The port's training path for the reduced dense-attention configs
(gemma3_12b, h2o_danube_1_8b, command_r_plus_104b) against the JAX
reference, on the CPU.

Both packages start from the reference's PRNGKey(0) weights, carried over
with ``params_from_numpy``, and read the same numpy batches, 40 tokens
long: past every reduced window (gemma3's local layers 16, danube's 32),
so the gradient runs through the band's edge. Bars: 1e-4 in float32
(``ROADMAP.md``); gradients at 1e-4 of the largest entry of their tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import CPU, both_params
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.base import get_config as jax_get_config
from repro.launch.train import train as jax_train
from repro.models import model as JM
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs.base import get_config
from repro_torch.data.frontend import pipeline_for
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.optim.optimizer import tree_leaves, tree_map

DENSE = ("gemma3_12b", "h2o_danube_1_8b", "command_r_plus_104b")
SEQ = 40


TRAINED = ("gemma3_12b", "h2o_danube_1_8b", "musicgen_medium", "internvl2_76b")


def _batch(arch: str, step: int, batch: int = 3) -> dict:
    return pipeline_for(get_config(arch, reduced=True), batch, SEQ).batch_at(step)


def _assert_trees_close(got: dict, want, rtol: float, what: str) -> None:
    """Every leaf within ``rtol`` of the largest value of its reference leaf."""
    want = {k: np.asarray(v, np.float32) for k, v in _flatten_with_paths(want).items()}
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("remat", ["nothing", "none", "dots"])
@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_gradients_match_reference(arch, remat):
    """Loss, NLL and the gradient of every weight (qk-norm and sandwich
    norms in gemma3, danube's untied head, command_r's parallel block)."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), remat=remat)
    cfg = dataclasses.replace(get_config(arch, reduced=True), remat=remat)
    jparams, params = both_params(jcfg, cfg)
    batch = _batch(arch, 3)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, met = M.train_loss(leaves, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
    it = iter(grads)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(met["nll"].item(), float(jmet["nll"]), rtol=1e-4, atol=1e-4)
    got = {k: v.detach().float().numpy()
           for k, v in _flatten(tree_map(lambda _: next(it), params)).items()}
    _assert_trees_close(got, jgrads, 1e-4, "grad")


@pytest.mark.parametrize("arch", TRAINED)
def test_train_matches_reference_train(arch, tmp_path):
    """Reduced config, 5 steps of 8 x 64 cyclic tokens (twice danube's
    window, four times gemma3's; musicgen's (8, 64, 4) codebook tokens and
    labels through ``multi_head_xent``, internvl2's seeded embeddings),
    seed 0: the reference's train() and the port's from the reference's
    initial weights."""
    quiet = dict(steps=5, ckpt_every=0, resume=False, log=lambda _: None)
    ref = jax_train(arch, ckpt_dir=str(tmp_path / "jax"), **quiet)
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    _, params = both_params(jcfg, cfg)
    out = train(arch, ckpt_dir=str(tmp_path / "torch"), device="cpu", params=params, **quiet)
    assert out["start_step"] == 0 and out["watchdog"] == {"timeouts": 0, "retries": 0}
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4, atol=1e-4)
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("arch", TRAINED)
def test_train_runs_at_the_depth_of_the_params_given(arch, tmp_path):
    """``train(params=...)`` with one period where the config has two: the
    run keeps one period, and its first loss is the one-period model's."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), n_periods=1)
    params = M.init_params(cfg, torch.Generator().manual_seed(5), CPU)
    out = train(arch, steps=2, ckpt_dir=str(tmp_path), ckpt_every=0, resume=False,
                device="cpu", params=params, log=lambda _: None)
    assert [len(per) for per in out["params"]["period"]] == [1] * len(cfg.period)
    batch = pipeline_for(cfg, 8, 64).batch_at(0)
    with torch.no_grad():
        want, _ = M.train_loss(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["losses"][0], want.item(), rtol=1e-6)


def test_train_step_gives_an_unused_weight_a_zero_gradient():
    """command_r's parallel block never reads its ``ffn/ln`` weight: the
    train step gives it a zero gradient, as ``jax.grad`` does, where a
    plain ``torch.autograd.grad`` raises for an unused input."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    cfg = get_config("command_r_plus_104b", reduced=True)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=4, weight_decay=0.0)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = {k: torch.as_tensor(v) for k, v in _batch("command_r_plus_104b", 0).items()}
    _, state, metrics = make_train_step(cfg, opt)(params, init_opt_state(params, opt), batch)
    moments = _flatten(state["m"])
    assert np.isfinite(metrics["loss"])
    assert not moments["period/0/ffn/ln"].any() and moments["period/0/attn/wq"].any()
