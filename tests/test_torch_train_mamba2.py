"""The port's training path for reduced mamba2_2_7b against the JAX
reference, on the CPU.

Both packages start from the reference's PRNGKey(0) weights, carried over
with ``params_from_numpy``, and read the same numpy batches. On the CPU the
port's scan is ``ssd_chunked`` under autograd, as the reference
differentiates its own ``ssd_chunked`` with XLA. Bars: 1e-4 in float32
(``ROADMAP.md``); gradients at 1e-4 of the largest entry of their tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.base import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import train as jax_train
from repro.models import model as JM
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.optim.optimizer import OptConfig, init_opt_state, tree_leaves, tree_map

ARCH = "mamba2_2_7b"


def _batch(step: int, batch: int = 4, seq: int = 40) -> dict:
    """seq 40: ragged against the reduced config's chunk of 16."""
    cfg = get_config(ARCH, reduced=True)
    return TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=batch, seq=seq,
                                        mode="cyclic")).batch_at(step)


def _flat_np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in _flatten(tree).items()}


def _assert_trees_close(got: dict, want, rtol: float, what: str) -> None:
    """Every leaf within ``rtol`` of the largest value of its reference leaf."""
    want = {k: np.asarray(v, np.float32) for k, v in _flatten_with_paths(want).items()}
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def weights():
    """The reference's initial weights, and the port's copy of them."""
    jparams = JM.init_params(jax_get_config(ARCH, reduced=True), jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams).items()}
    return jparams, flat


@pytest.mark.parametrize("remat", ["nothing", "none", "dots"])
def test_train_loss_and_gradients_match_reference(weights, remat):
    jparams, flat = weights
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), remat=remat)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), remat=remat)
    batch = _batch(3)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = params_from_numpy(flat, cfg, "cpu")
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, met = M.train_loss(leaves, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(met["nll"].item(), float(jmet["nll"]), rtol=1e-4, atol=1e-4)
    _assert_trees_close(_flat_np(tree_map(lambda _: next(it), params)), jgrads, 1e-4, "grad")


def test_one_train_step_matches_reference(weights):
    """One AdamW step (weight decay on, so the rank >= 2 rule is exercised)
    from the initial weights: new params, moments, step and metrics."""
    jparams, flat = weights
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10, weight_decay=0.1)
    jopt, opt = JOptConfig(**kw), OptConfig(**kw)
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    batch = _batch(0)
    jp, js, jm = jax_make_train_step(jcfg, jopt)(
        jparams, jax_init_opt_state(jparams, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(flat, cfg, "cpu")
    p, s, m = make_train_step(cfg, opt)(params, init_opt_state(params, opt),
                                        {k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("loss", "nll", "lr", "grad_norm"):
        np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-4, err_msg=key)
    assert int(s["step"]) == int(js["step"]) == 1
    _assert_trees_close(_flat_np(p), jp, 1e-5, "params")
    _assert_trees_close(_flat_np(s["m"]), js["m"], 1e-4, "m")
    _assert_trees_close(_flat_np(s["v"]), js["v"], 1e-4, "v")


def test_train_matches_reference_train(weights, tmp_path):
    """Reduced mamba2_2_7b, 5 steps of 8 x 64 cyclic tokens, seed 0: the
    reference's train() and the port's from the reference's initial weights."""
    _, flat = weights
    quiet = dict(steps=5, ckpt_every=0, resume=False, log=lambda _: None)
    ref = jax_train(ARCH, ckpt_dir=str(tmp_path / "jax"), **quiet)
    params = params_from_numpy(flat, get_config(ARCH, reduced=True), "cpu")
    out = train(ARCH, ckpt_dir=str(tmp_path / "torch"), device="cpu", params=params, **quiet)
    assert out["start_step"] == 0 and out["watchdog"] == {"timeouts": 0, "retries": 0}
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4, atol=1e-4)
    assert out["losses"][-1] < out["losses"][0]
