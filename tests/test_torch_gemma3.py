"""The port's gemma3_12b against the JAX reference, on the CPU: the config
field for field, reduced prefill and decode logits and greedy serving with
prompts shorter than, as long as and longer than the reduced local window
(16), the ring wrapping in decode; qk-norm before rope with each layer's
rope theta, the sandwich norms' weights and the embedding scale in bf16.
Tolerance 1e-4 in float32 (``_torch_dense``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, TOL, assert_configs_match, assert_prefill_and_decode_match,
                          assert_serve_tokens_match, both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM

ARCH = "gemma3_12b"
WINDOW = 16  # the reduced local layers' window


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_count_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)


def test_full_config_is_gemma3_12b():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (48, 3840, 262144)
    assert [l.attn.window for l in cfg.period] == [1024] * 5 + [0]
    assert [l.attn.rope_theta for l in cfg.period] == [1e4] * 5 + [1e6]
    assert all(l.attn.qk_norm and l.post_norm for l in cfg.period)
    assert cfg.embed_scale and cfg.tie_embeddings
    assert TM.param_count(cfg) == 11_765_788_416


@pytest.mark.parametrize("prompt_len", [WINDOW // 2, WINDOW, WINDOW + 8])
def test_prefill_and_decode_match_reference(reduced, prompt_len):
    """Shorter than, as long as and longer than the local window; 12 decode
    steps wrap every local layer's ring."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=12)


@pytest.mark.parametrize("prompt_len", [WINDOW // 2, WINDOW, WINDOW + 8])
def test_serve_greedy_tokens_match_reference(reduced, prompt_len):
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len, gen=12)


def test_rope_theta_of_each_layer_reaches_its_attention():
    """The reduced config with the full config's thetas (1e4 local, 1e6
    global; the reduced one leaves both at 1e4): prefill and decode still
    match, and the global layer's theta changes the logits."""
    def thetas(cfg, local, glob):
        return dataclasses.replace(cfg, period=tuple(
            dataclasses.replace(l, attn=dataclasses.replace(
                l.attn, rope_theta=glob if l.attn.window == 0 else local))
            for l in cfg.period))
    jcfg = thetas(jax_get_config(ARCH, True), 1e4, 1e6)
    tcfg = thetas(get_config(ARCH, True), 1e4, 1e6)
    jparams, tparams = both_params(jcfg, tcfg, seed=3)
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, WINDOW + 8, steps=4)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab, (2, 24)))
    _, a = TM.prefill(tparams, tcfg, {"tokens": tokens})
    _, b = TM.prefill(tparams, thetas(tcfg, 1e4, 1e4), {"tokens": tokens})
    assert (a - b).abs().max() > 1e-3


def test_qk_norm_and_sandwich_norm_weights_carry_across(reduced):
    """q_norm, k_norm (head_dim) and the attention's and FFN's post_ln
    (d_model) of every layer come across from the reference's flat keys,
    their shapes checked."""
    jcfg, tcfg, jparams, tparams = reduced
    flat = reference_flat(jparams)
    for j in range(len(jcfg.period)):
        for i in range(jcfg.n_periods):
            layer = tparams["period"][j][i]
            for part, name in (("attn", "q_norm"), ("attn", "k_norm"), ("attn", "post_ln"),
                               ("ffn", "post_ln")):
                np.testing.assert_array_equal(
                    np32(layer[part][name]), flat[f"period/{j}/{part}/{name}"][i])
    flat["period/2/attn/q_norm"] = np.ones((jcfg.n_periods, 8), np.float32)
    with pytest.raises(ValueError, match="q_norm"):
        params_from_numpy(flat, tcfg, CPU)


def test_embedding_scale_is_applied_in_bf16_as_the_reference_does(reduced):
    """h = table[tokens] * sqrt(d) with the scale rounded to the table's
    dtype first: bit for bit in bf16, prefill and decode alike."""
    jcfg, tcfg, jparams, _ = reduced
    table = np.asarray(jparams["embed"]["tok"], np.float32) * 7
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 5))
    jtab = {"embed": {"tok": jnp.asarray(table).astype(jnp.bfloat16)}}
    ttab = {"embed": {"tok": torch.from_numpy(table).to(torch.bfloat16)}}
    want = JM._embed(jtab, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = TM._embed(ttab, tcfg, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(got), np.asarray(want, np.float32))


def test_decode_logits_carry_the_scaled_embedding(reduced):
    """One decode step from a zero cache: the scaled embedding enters
    decode as it enters prefill (logits at 1e-4)."""
    jcfg, tcfg, jparams, tparams = reduced
    tok = np.array([3, 7])
    jl, _ = JM.decode_step(jparams, jcfg, JM.init_cache(jcfg, 2, 8),
                           {"token": jnp.asarray(tok, jnp.int32),
                            "cur_len": jnp.asarray(0, jnp.int32)})
    tl, _ = TM.decode_step(tparams, tcfg, TM.init_cache(tcfg, 2, 8, CPU),
                           {"token": torch.from_numpy(tok), "cur_len": 0})
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
