"""The port's deepseek_v2_lite_16b training against the JAX reference, on
the CPU: ``train_loss`` with its MoE aux loss and the gradient of every
weight (MLA's ``w_dkv`` / ``ln_ckv`` / 3-D ``w_uk`` / ``w_uv``, the dense
prefix layer's, the router's) under both remat policies, ``train()``
against the reference's ``train()``, and ``train()`` at the depth of the
params given. The attention's gradient runs through the plain formula at
the reduced config's head dims, q/k 24 and v 16 (the card's ffma kernels
at that pair are held in ``tests/test_torch_gpu.py``). Weights are the
reference's PRNGKey(0) init; tolerance 1e-4 in float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import CPU, both_params
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models import model as TM
from repro_torch.optim.optimizer import tree_leaves, tree_map

ARCH = "deepseek_v2_lite_16b"


@pytest.mark.parametrize("remat", ["nothing", "none", "dots"])
def test_train_loss_aux_and_gradients_match_reference(remat):
    """Loss, NLL, the MoE aux loss (summed over the MoE layers) and the
    gradient of every weight at 1e-4 of the largest entry of each tensor;
    4 x 40 tokens, ten groups of 16 (tokens drop at capacity 1.25)."""
    from test_torch_train_dense import _assert_trees_close

    jcfg = dataclasses.replace(jax_get_config(ARCH, True), remat=remat)
    tcfg = dataclasses.replace(get_config(ARCH, True), remat=remat)
    jparams, tparams = both_params(jcfg, tcfg)
    batch = TokenPipeline(PipelineConfig(vocab=tcfg.vocab, batch=4, seq=40,
                                         mode="cyclic")).batch_at(2)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), tparams)
    loss, met = TM.train_loss(leaves, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert met["aux"].item() > 0
    for got, want in ((loss, jloss), (met["nll"], jmet["nll"]), (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-4)
    grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
    it = iter(grads)
    got = {k: v.detach().float().numpy()
           for k, v in _flatten(tree_map(lambda _: next(it), tparams)).items()}
    assert {"prefix/0/attn/w_uk", "period/0/attn/w_dkv", "period/0/ffn/w_router"} <= got.keys()
    assert all(np.abs(g).max() > 0 for g in got.values())
    _assert_trees_close(got, jgrads, 1e-4, "grad")


def test_train_matches_reference_train(tmp_path):
    """Reduced deepseek (the dense first layer, 2 MoE layers), 5 steps of
    8 x 64 cyclic tokens, seed 0: the reference's ``train()`` and the
    port's from the reference's initial weights, losses at 1e-4."""
    from repro.launch.train import train as jax_train
    from repro_torch.launch.train import train

    quiet = dict(steps=5, ckpt_every=0, resume=False, log=lambda _: None)
    ref = jax_train(ARCH, ckpt_dir=str(tmp_path / "jax"), **quiet)
    _, params = both_params(jax_get_config(ARCH, True), get_config(ARCH, True))
    out = train(ARCH, ckpt_dir=str(tmp_path / "torch"), device="cpu", params=params, **quiet)
    assert out["start_step"] == 0 and out["watchdog"] == {"timeouts": 0, "retries": 0}
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4, atol=1e-4)
    assert out["losses"][-1] < out["losses"][0]


def test_train_runs_at_the_depth_of_the_params_given(tmp_path):
    """``train(params=...)`` with the dense prefix layer and one MoE layer
    where the reduced config has two: the run keeps that depth, and its
    first loss is the cut model's (as the card trains deepseek cut in
    depth)."""
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_config(ARCH, True), n_periods=1)
    assert get_config(ARCH, True).n_periods > 1
    params = TM.init_params(cfg, torch.Generator().manual_seed(5), CPU)
    out = train(ARCH, steps=2, ckpt_dir=str(tmp_path), ckpt_every=0, resume=False,
                device="cpu", params=params, log=lambda _: None)
    assert len(out["params"]["prefix"]) == 1
    assert [len(per) for per in out["params"]["period"]] == [1]
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=64,
                                         mode="cyclic")).batch_at(0)
    with torch.no_grad():
        want, _ = TM.train_loss(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["losses"][0], want.item(), rtol=1e-6)
