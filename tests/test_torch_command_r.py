"""The port's command_r_plus_104b against the JAX reference, on the CPU: the
config field for field, the parallel residual block in prefill and decode,
reduced prefill and decode logits and greedy serving, and the parallel
block's unused ``ffn/ln`` handled as the reference handles it. Tolerance
1e-4 in float32 (``_torch_dense``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, TOL, assert_configs_match, assert_prefill_and_decode_match,
                          assert_serve_tokens_match, both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

ARCH = "command_r_plus_104b"


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_count_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)


def test_full_config_is_command_r_plus():
    cfg = get_config(ARCH)
    (layer,) = cfg.period
    assert layer.parallel and layer.attn.q_group == 12 and layer.attn.head_dim == 128
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (64, 12288, 256000)
    assert TM.param_count(cfg) == 103_810_609_152


def _layer(params, i=0):
    return params["period"][0][i]


def test_parallel_block_matches_reference_in_prefill_and_decode(reduced):
    """One parallel block: x + attn(norm x) + ffn(norm x), one shared norm,
    with its cache, then a decode step on that cache."""
    jcfg, tcfg, jparams, tparams = reduced
    x = np.random.default_rng(2).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jp = {k: {n: a[0] for n, a in v.items()} for k, v in jparams["period"][0].items()}
    jy, _, jc = JB.block_train(jp, jnp.asarray(x), jcfg.period[0], want_cache=True)
    ty, _, tc = TB.block_train(_layer(tparams), torch.from_numpy(x), tcfg.period[0],
                               want_cache=True)
    np.testing.assert_allclose(np32(ty), np32(jy), **TOL)
    x1 = x[:, 0] * 0.5
    jbig = {k: jnp.pad(v, ((0, 0), (0, 4), (0, 0), (0, 0))) for k, v in jc.items()}
    tbig = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in tc.items()}
    jd, _ = JB.block_decode(jp, jnp.asarray(x1), jbig, 12, jcfg.period[0])
    td, _ = TB.block_decode(_layer(tparams), torch.from_numpy(x1), tbig, 12, tcfg.period[0])
    np.testing.assert_allclose(np32(td), np32(jd), **TOL)


@pytest.mark.parametrize("prompt_len", [8, 32])
def test_prefill_and_decode_match_reference(reduced, prompt_len):
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=10)


def test_serve_greedy_tokens_match_reference(reduced):
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len=32, gen=16)


def test_unused_ffn_norm_is_carried_and_ignored_as_in_the_reference(reduced):
    """The parallel block reads ``attn/ln`` for both branches. ``ffn/ln`` is
    a leaf of both trees all the same: it must be in the checkpoint, it
    comes across, and changing it changes neither package's logits."""
    jcfg, tcfg, jparams, tparams = reduced
    flat = reference_flat(jparams)
    np.testing.assert_array_equal(np32(_layer(tparams)["ffn"]["ln"]), flat["period/0/ffn/ln"][0])
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 16))
    _, want = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    flat["period/0/ffn/ln"] = flat["period/0/ffn/ln"] * 3 + 1
    moved = params_from_numpy(flat, tcfg, CPU)
    _, got = TM.prefill(moved, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    jmoved = dict(jparams, period=({**jparams["period"][0], "ffn": {
        **jparams["period"][0]["ffn"], "ln": jnp.asarray(flat["period/0/ffn/ln"])}},))
    _, jgot = JM.prefill(jmoved, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    np.testing.assert_allclose(np32(jgot), np32(want), rtol=0, atol=0)
    del flat["period/0/ffn/ln"]
    with pytest.raises(KeyError, match="ffn/ln"):
        params_from_numpy(flat, tcfg, CPU)
