"""The port's h2o_danube_1_8b against the JAX reference, on the CPU: the
config field for field, reduced prefill and decode logits and greedy serving
with prompts shorter than, as long as and longer than the reduced window
(32), the ring wrapping in decode and ``rehome`` in each regime, and the
untied head carried across. Tolerance 1e-4 in float32 (``_torch_dense``)."""

import numpy as np
import pytest
import torch

from _torch_dense import (CPU, assert_configs_match, assert_prefill_and_decode_match,
                          assert_serve_tokens_match, both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import rehome
from repro_torch.models import model as TM
from repro_torch.models.blocks import _qkv
from repro_torch.models.common import rms_norm

ARCH = "h2o_danube_1_8b"
WINDOW = 32  # the reduced config's window


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_count_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)


def test_full_config_is_h2o_danube_1_8b():
    cfg = get_config(ARCH)
    (layer,) = cfg.period
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.tie_embeddings) == (24, 2560, 32000, False)
    assert (layer.attn.n_heads, layer.attn.n_kv_heads, layer.attn.head_dim,
            layer.attn.window) == (32, 8, 80, 4096)
    assert TM.param_count(cfg) == 1_831_201_280


@pytest.mark.parametrize("prompt_len", [WINDOW // 2, WINDOW, WINDOW + 16])
def test_prefill_and_decode_match_reference(reduced, prompt_len):
    """Shorter than, as long as and longer than the window; 20 decode steps
    wrap the ring in each regime."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=20)


@pytest.mark.parametrize("prompt_len", [WINDOW // 2, WINDOW, WINDOW + 16])
def test_serve_greedy_tokens_match_reference(reduced, prompt_len):
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len, gen=20)


@pytest.mark.parametrize("prompt_len,cache_len,slots", [
    (WINDOW // 2, 100, WINDOW),        # shorter: slots 0 .. T-1 hold positions 0 .. T-1
    (WINDOW, 100, WINDOW),             # as long: the ring fills the cache
    (WINDOW + 16, 100, WINDOW),        # longer: the ring is copied whole
    (WINDOW // 2, WINDOW // 2 + 4, WINDOW // 2 + 4),  # a cache below the window
])
def test_rehome_puts_each_position_where_decode_reads_it(reduced, prompt_len, cache_len, slots):
    """After ``rehome`` the key of prompt position p sits at the slot decode
    would write it to, ``p % S`` with ``S = min(cache_len, window)``, for the
    positions the window still sees; every other slot is zero."""
    _, tcfg, _, tparams = reduced
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab, (2, prompt_len)))
    full = TM._embed(tparams, tcfg, tokens)
    small, _ = TM.prefill(tparams, tcfg, {"tokens": tokens})
    big = rehome(TM.init_cache(tcfg, 2, cache_len, CPU), small)
    k = big["period"][0][0]["k"]
    assert k.shape[1] == slots
    # Recompute layer 0's keys from the prompt to know which position is which.
    p = tparams["period"][0][0]["attn"]
    _, keys, _ = _qkv(rms_norm(full, p["ln"]), p, tcfg.period[0].attn,
                      torch.arange(prompt_len)[None, :])
    seen = set()
    for pos in range(max(0, prompt_len - WINDOW), prompt_len):
        torch.testing.assert_close(k[:, pos % slots], keys[:, pos])
        seen.add(pos % slots)
    for slot in set(range(slots)) - seen:
        assert not k[:, slot].any()


def test_untied_head_carries_across(reduced):
    jcfg, tcfg, jparams, tparams = reduced
    flat = reference_flat(jparams)
    assert tparams["head"].shape == (tcfg.d_model, tcfg.vocab)
    np.testing.assert_array_equal(np32(tparams["head"]), flat["head"])
    flat["head"] = flat["head"][:, :-1]
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(flat, tcfg, CPU)
    del flat["head"]
    with pytest.raises(KeyError, match="head"):
        params_from_numpy(flat, tcfg, CPU)
