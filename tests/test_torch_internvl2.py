"""The port's internvl2_76b backbone (the ``embeds`` frontend) against the
JAX reference, on the CPU: the config field for field, the empty ``embed``
dict carried across, embeddings cast into the model, reduced prefill and
decode logits and caches with a fresh embedding a decode step, greedy
serving under the reference's draw order, ``train_loss`` and every
gradient, and ``active_param_count``. Tolerance 1e-4 in float32
(``_torch_dense``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, TOL, assert_configs_match, assert_loss_and_grads_match,
                          assert_prefill_and_decode_match, assert_serve_tokens_match,
                          both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import model as TM

ARCH = "internvl2_76b"


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_count_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)


def test_full_config_is_the_internvl2_76b_backbone():
    cfg = get_config(ARCH)
    (layer,) = cfg.period
    assert (cfg.frontend, cfg.tie_embeddings) == ("embeds", False)
    assert layer.attn.q_group == 8 and layer.attn.head_dim == 128
    assert (layer.dense.kind, layer.dense.d_ff) == ("swiglu", 28672)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (80, 8192, 128256)
    assert TM.param_count(cfg) == 69_503_033_344
    assert TM.param_count(dataclasses.replace(cfg, n_periods=16)) == 14_741_151_744


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_active_param_count_matches_reference(reduced_cfg):
    assert TM.active_param_count(get_config(ARCH, reduced_cfg)) == \
        JM.active_param_count(jax_get_config(ARCH, reduced_cfg))


def test_the_empty_embed_dict_is_carried_across(reduced):
    """No input table: ``embed`` is an empty dict in the specs, in the
    port's init and in the tree ``params_from_numpy`` builds, which no
    checkpoint path names; the head stays untied."""
    jcfg, tcfg, jparams, tparams = reduced
    assert TM.param_specs(tcfg)["embed"] == {} and jparams["embed"] == {}
    assert tparams["embed"] == {} and list(tparams)[:2] == ["embed", "prefix"]
    assert TM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)["embed"] == {}
    flat = reference_flat(jparams)
    assert not any(k.startswith("embed") for k in flat)
    np.testing.assert_array_equal(np32(tparams["head"]), flat["head"])
    bad = dict(flat, head=flat["head"][:, :-1])
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(bad, tcfg, CPU)


@pytest.mark.parametrize("shape", [(2, 7), (3,)])
def test_embeddings_enter_in_the_models_dtype(reduced, shape):
    """(B, T, d) prompts and (B, d) decode embeddings are cast, not looked up."""
    _, tcfg, _, tparams = reduced
    x = np.random.default_rng(1).standard_normal(shape + (tcfg.d_model,))
    got = TM._embed(tparams, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float32))
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    assert TM._embed({"embed": {}}, bf, torch.from_numpy(x)).dtype == torch.bfloat16


@pytest.mark.parametrize("prompt_len", [8, 32])
def test_prefill_and_decode_match_reference(reduced, prompt_len):
    """A (B, T, d) prompt, then 10 decode steps of fresh (B, d) embeddings:
    logits and caches."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=10)


def test_serve_greedy_tokens_match_reference(reduced):
    """The prompt and every step's embedding drawn in the reference's order
    (a step's embedding after its pick): the same tokens."""
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len=32, gen=16)


def test_sampled_serve_draws_in_the_reference_order(reduced):
    """Sampling draws from the same generator as the embeddings: a step's
    pick draws first, then its embedding. With the reference's weights (its
    ``serve`` draws them from PRNGKey(seed)) the port samples the
    reference's tokens."""
    from repro.launch.serve import serve as jax_serve
    kw = dict(reduced=True, seed=0, batch=2, prompt_len=16, gen=6, cache_len=24,
              greedy=False, log=lambda _: None)
    ref = jax_serve(ARCH, **kw)
    out = serve(ARCH, device="cpu", params=reduced[3], **kw)
    np.testing.assert_array_equal(out["tokens"], np.asarray(ref["tokens"]))


@pytest.mark.parametrize("remat", ["nothing", "none", "dots"])
def test_train_loss_and_gradients_match_reference(reduced, remat):
    """(B, T, d) embeddings and (B, T) labels: the loss, its NLL and the
    gradient of every weight, the untied head's among them, at 1e-4 of
    each tensor's largest entry; the empty ``embed`` gets no gradient in
    either package."""
    jcfg, tcfg, jparams, tparams = reduced
    jcfg, tcfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    batch = {"embeds": rng.standard_normal((3, 40, jcfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, jcfg.vocab, (3, 40)).astype(np.int32)}
    jgrads = assert_loss_and_grads_match(jcfg, tcfg, jparams, tparams, batch)
    assert jgrads["embed"] == {}


def test_a_loss_mask_weighs_the_positions_as_the_reference(reduced):
    jcfg, tcfg, jparams, tparams = reduced
    rng = np.random.default_rng(6)
    batch = {"embeds": rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32),
             "loss_mask": (rng.random((2, 24)) < 0.5).astype(np.float32)}
    want, _ = JM.train_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = TM.train_loss(tparams, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), **TOL)
