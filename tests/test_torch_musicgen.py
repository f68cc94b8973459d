"""The port's musicgen_medium (the ``codebooks`` frontend) against the JAX
reference, on the CPU: the config field for field, the codebook embedding
sum and the per-codebook heads, reduced prefill and decode logits and
caches, greedy serving ((B, gen, K) tokens), ``train_loss`` through
``multi_head_xent`` and every gradient, ``active_param_count`` and the
weights carried over by ``params_from_numpy``. The FFN's biases are drawn
at random (both inits make them zeros), so the GELU epilogue's bias counts.
Tolerance 1e-4 in float32 (``_torch_dense``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, TOL, assert_configs_match, assert_loss_and_grads_match,
                          assert_prefill_and_decode_match, assert_serve_tokens_match,
                          both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro.launch.serve import _pick as jax_pick
from repro.models import model as JM
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import pick, serve
from repro_torch.models import model as TM

ARCH = "musicgen_medium"


def _with_random_biases(jparams, seed: int = 3):
    """The reference's weights with the FFN's zero biases redrawn."""
    rng = np.random.default_rng(seed)
    ffn = dict(jparams["period"][0]["ffn"])
    for name in ("b_up", "b_down"):
        ffn[name] = jnp.asarray(0.1 * rng.standard_normal(ffn[name].shape), jnp.float32)
    return {**jparams, "period": ({**jparams["period"][0], "ffn": ffn},)}


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    jparams = _with_random_biases(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jparams, params_from_numpy(reference_flat(jparams), tcfg, CPU)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_count_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)


def test_full_config_is_musicgen_medium():
    cfg = get_config(ARCH)
    (layer,) = cfg.period
    assert (cfg.frontend, cfg.n_codebooks, cfg.tie_embeddings) == ("codebooks", 4, False)
    assert layer.attn.q_group == 1 and layer.attn.head_dim == 64
    assert (layer.dense.kind, layer.dense.d_ff) == ("gelu", 6144)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.head_width) == (48, 1536, 2048, 8192)
    assert TM.param_count(cfg) == 1_384_637_952


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_active_param_count_matches_reference(reduced_cfg):
    assert TM.active_param_count(get_config(ARCH, reduced_cfg)) == \
        JM.active_param_count(jax_get_config(ARCH, reduced_cfg))


def test_param_specs_hold_one_table_and_one_head_of_every_codebook():
    cfg = get_config(ARCH)
    specs = TM.param_specs(cfg)
    assert specs["embed"]["tok"].shape == (4 * 2048, 1536)
    assert specs["head"].shape == (1536, 4 * 2048)
    jspecs = JM.param_specs(jax_get_config(ARCH))
    assert specs["embed"]["tok"].axes == jspecs["embed"]["tok"].axes
    assert specs["head"].axes == jspecs["head"].axes


@pytest.mark.parametrize("shape", [(2, 7, 4), (3, 4)])
def test_codebook_embedding_is_the_reference_sum(reduced, shape):
    """(B, T, K) prompts and (B, K) decode tokens: each codebook's row of
    the one table, ``tok + k V``, summed over the codebooks."""
    jcfg, tcfg, jparams, tparams = reduced
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, shape)
    got = TM._embed(tparams, tcfg, torch.from_numpy(tok))
    table = np32(tparams["embed"]["tok"])
    want = sum(table[tok[..., k] + k * jcfg.vocab] for k in range(jcfg.n_codebooks))
    np.testing.assert_allclose(np32(got), want, **TOL)
    if len(shape) == 3:
        jwant = JM._embed(jparams, jcfg, {"tokens": jnp.asarray(tok, jnp.int32)})
        np.testing.assert_allclose(np32(got), np32(jwant), **TOL)


def test_codebook_sum_in_bf16_rounds_as_the_reference():
    """In bf16 the port sums the K rows in float32 and rounds once; on the
    CPU, JAX's sum of the bf16 rows gives the same bits."""
    cfg = dataclasses.replace(get_config(ARCH, True), param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config(ARCH, True), param_dtype="bfloat16")
    rng = np.random.default_rng(2)
    table = rng.standard_normal((cfg.n_codebooks * cfg.vocab, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, (4, 16, cfg.n_codebooks))
    got = TM._embed({"embed": {"tok": torch.from_numpy(table).bfloat16()}}, cfg,
                    torch.from_numpy(tok))
    want = JM._embed({"embed": {"tok": jnp.asarray(table, jnp.bfloat16)}}, jcfg,
                     {"tokens": jnp.asarray(tok, jnp.int32)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(got), np.asarray(want, np.float32))


def test_per_codebook_heads_give_the_reference_logits_and_picks(reduced):
    """The last position's logits, (B, K V): codebook k's are h @ head[:, kV:(k+1)V];
    the greedy pick is one token a codebook, the reference's."""
    jcfg, tcfg, jparams, tparams = reduced
    tok = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 9, jcfg.n_codebooks))
    _, jl = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tok, jnp.int32)})
    _, tl = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tok)})
    assert tl.shape == (3, jcfg.n_codebooks * jcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    got = pick(tcfg, tl, True, None)
    want = jax_pick(jl.reshape(3, jcfg.n_codebooks, jcfg.vocab), True, None)
    assert got.shape == (3, jcfg.n_codebooks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prompt_len", [8, 32])
def test_prefill_and_decode_match_reference(reduced, prompt_len):
    """10 decode steps of forced (B, K) tokens: logits and caches."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=10)


def test_serve_greedy_tokens_match_reference():
    """The reference's ``serve`` draws its own PRNGKey(0) weights, zero
    biases and all: the port is given those."""
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    assert_serve_tokens_match(ARCH, both_params(jcfg, tcfg)[1], prompt_len=32, gen=16)


def test_serve_returns_a_token_a_codebook_a_step():
    out = serve(ARCH, device="cpu", batch=3, prompt_len=8, gen=5, cache_len=16,
                log=lambda _: None)
    assert out["tokens"].shape == (3, 5, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 64)).all()


@pytest.mark.parametrize("remat", ["nothing", "none", "dots"])
def test_train_loss_and_gradients_match_reference(reduced, remat):
    """(B, T, K) tokens and labels through ``multi_head_xent``: the loss,
    its NLL and the gradient of every weight, the table's and the K heads'
    among them, at 1e-4 of each tensor's largest entry."""
    jcfg, tcfg, jparams, tparams = reduced
    jcfg, tcfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    shape = (3, 40, jcfg.n_codebooks)
    batch = {"tokens": rng.integers(0, jcfg.vocab, shape).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, shape).astype(np.int32)}
    assert_loss_and_grads_match(jcfg, tcfg, jparams, tparams, batch)


def test_params_from_numpy_carries_the_table_and_heads_with_their_shapes(reduced):
    jcfg, tcfg, jparams, tparams = reduced
    flat = reference_flat(jparams)
    np.testing.assert_array_equal(np32(tparams["embed"]["tok"]), flat["embed/tok"])
    np.testing.assert_array_equal(np32(tparams["head"]), flat["head"])
    np.testing.assert_array_equal(np32(tparams["period"][0][1]["ffn"]["b_up"]),
                                  flat["period/0/ffn/b_up"][1])
    assert tparams["head"].shape == (jcfg.d_model, jcfg.n_codebooks * jcfg.vocab)
    for key, cut in (("head", np.s_[:, :jcfg.vocab]), ("embed/tok", np.s_[:jcfg.vocab])):
        bad = dict(flat, **{key: flat[key][cut]})
        with pytest.raises(ValueError, match=key):
            params_from_numpy(bad, tcfg, CPU)
