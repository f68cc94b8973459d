"""The port's deepseek_v2_lite_16b against the JAX reference, on the CPU:
the config field for field and its parameter counts, the MLA attention
layer alone (prefill core, absorbed decode core, the latent decode
attention) at 1e-5, reduced prefill and decode logits and latent caches
(the dense prefix layer's too) at 1e-4 across several decode steps,
greedy serving, and the reference's parameters carried across (the
unstacked prefix layer, the 3-D ``w_uk`` / ``w_uv``, the float32 router).
Weights are the reference's PRNGKey(0) init (``_torch_dense``); inputs are
numpy draws given to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, assert_caches_match, assert_configs_match,
                          assert_prefill_and_decode_match, assert_serve_tokens_match,
                          both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

ARCH = "deepseek_v2_lite_16b"
TOL5 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


def _layer(reduced, where: str):
    """(reference layer cfg, port layer cfg, reference attention params,
    port attention params) of the dense prefix layer or the first MoE one."""
    jcfg, tcfg, jparams, tparams = reduced
    if where == "prefix":
        return (jcfg.prefix[0], tcfg.prefix[0], jparams["prefix"][0]["attn"],
                tparams["prefix"][0]["attn"])
    jp = {k: v[0] for k, v in jparams["period"][0]["attn"].items()}
    return jcfg.period[0], tcfg.period[0], jp, tparams["period"][0][0]["attn"]


def _draw(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_counts_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)
    assert TM.active_param_count(get_config(ARCH, reduced_cfg)) == \
        JM.active_param_count(jax_get_config(ARCH, reduced_cfg))


def test_full_config_is_deepseek_v2_lite():
    cfg = get_config(ARCH)
    (first,), (layer,) = cfg.prefix, cfg.period
    a, m = layer.attn, layer.moe
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.tie_embeddings) == (27, 2048, 102400, False)
    assert first.attn == a and (first.ffn_kind, first.dense.d_ff) == ("dense", 10944)
    assert (a.n_heads, a.n_kv_heads, a.kv_lora_rank, a.qk_nope_dim, a.qk_rope_dim,
            a.v_head_dim, a.is_mla) == (16, 16, 512, 128, 64, 128, True)
    assert (m.n_experts, m.top_k, m.d_ff, m.n_shared, m.d_ff_shared, m.capacity_factor,
            m.group, m.norm_topk) == (64, 6, 1408, 2, 2816, 1.25, 2048, False)
    assert TM.param_count(cfg) == 15_706_484_224
    assert TM.active_param_count(cfg) == 2_661_150_208


@pytest.mark.parametrize("where", ["prefix", "period"])
@pytest.mark.parametrize("T,pos0", [(8, 0), (40, 0), (13, 5)])
def test_mla_attn_core_matches_reference(reduced, where, T, pos0):
    """The MLA prefill core alone (q split into nope and rope halves, the
    latent ``c`` and the shared rope key, k and v up-projected, attention
    at q/k head dim 24 and v head dim 16), its output and latent cache at
    1e-5; T 40 is ragged against the reduced chunk of 32."""
    jl, tl, jp, tp = _layer(reduced, where)
    (h,) = _draw(T + pos0, (2, T, 64))
    jout, jcache = JB.attn_core(jp, jnp.asarray(h), jl, pos0=pos0, want_cache=True,
                                q_chunk=32, kv_chunk=32)
    tout, tcache = TB.attn_core(tp, torch.from_numpy(h), tl, pos0=pos0, want_cache=True,
                                q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(np32(tout), np32(jout), **TOL5)
    assert tcache.keys() == jcache.keys() == {"c", "kr"}
    for name in ("c", "kr"):
        np.testing.assert_allclose(np32(tcache[name]), np32(jcache[name]), **TOL5)


@pytest.mark.parametrize("cur_len", [0, 6, 11, 17])
def test_mla_decode_core_matches_reference(reduced, cur_len):
    """The absorbed decode core alone over a latent cache of 12 slots: the
    new token's latent written at ``cur_len % 12`` (17 wraps the ring), the
    output at 1e-5 and both caches after the write."""
    jl, tl, jp, tp = _layer(reduced, "period")
    a = tl.attn
    h, c, kr = _draw(cur_len, (3, 64), (3, 12, a.kv_lora_rank), (3, 12, a.qk_rope_dim))
    jout, jcache = JB._attn_decode_core(jp, jnp.asarray(h), {"c": jnp.asarray(c),
                                                            "kr": jnp.asarray(kr)},
                                        jnp.int32(cur_len), jl)
    tcache = {"c": torch.from_numpy(c.copy()), "kr": torch.from_numpy(kr.copy())}
    tout, tcache = TB._attn_decode_core(tp, torch.from_numpy(h), tcache, cur_len, tl)
    np.testing.assert_allclose(np32(tout), np32(jout), **TOL5)
    for name in ("c", "kr"):
        np.testing.assert_allclose(np32(tcache[name]), np32(jcache[name]), **TOL5)


@pytest.mark.parametrize("valid", [1, 7, 12])
def test_mla_decode_attention_matches_reference(valid):
    """The latent-space decode attention alone (B 2, H 4, R 32, S 12),
    scale 1/sqrt(qk_nope + qk_rope), the slots past ``valid`` masked."""
    cfg = dict(n_heads=4, n_kv_heads=4, head_dim=24, kv_lora_rank=32, qk_nope_dim=16,
               qk_rope_dim=8, v_head_dim=16)
    arrs = _draw(valid, (2, 4, 16), (2, 4, 8), (2, 12, 32), (2, 12, 8), (32, 4, 16),
                 (32, 4, 16))
    ref = JA.mla_decode_attention(*map(jnp.asarray, arrs), jnp.int32(valid), JA.AttnCfg(**cfg))
    out = TA.mla_decode_attention(*map(torch.from_numpy, arrs), valid, TA.AttnCfg(**cfg))
    assert out.shape == (2, 4, 16)
    np.testing.assert_allclose(np32(out), np32(ref), **TOL5)


@pytest.mark.parametrize("prompt_len,batch", [(8, 2), (32, 2), (24, 4)])
def test_prefill_and_decode_match_reference(reduced, prompt_len, batch):
    """Prefill (the dense prefix layer, then two MoE layers in groups of
    16 tokens), then 6 decode steps: logits and every layer's latent cache
    at 1e-4 after the prefill, the re-home and each step."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=6,
                                    batch=batch)


def test_prefill_cache_is_latent_for_every_layer(reduced):
    """The prefix layer's cache sits in ``cache["prefix"]``, the MoE layers'
    in ``cache["period"][0][i]``, each the (B, T, 32) latent and the (B, T,
    8) rope key; ``init_cache`` gives the reference's shapes."""
    jcfg, tcfg, _, tparams = reduced
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab, (2, 16)))
    cache, _ = TM.prefill(tparams, tcfg, {"tokens": tokens})
    layers = list(cache["prefix"]) + list(cache["period"][0])
    assert len(layers) == tcfg.n_layers == 3
    for c in layers:
        assert {k: tuple(v.shape) for k, v in c.items()} == {"c": (2, 16, 32), "kr": (2, 16, 8)}
    big = TM.init_cache(tcfg, 2, 40, CPU)
    jbig = JM.init_cache(jcfg, 2, 40)
    assert {k: tuple(v.shape) for k, v in big["prefix"][0].items()} == \
        {k: v.shape for k, v in jbig["prefix"][0].items()}
    assert {k: tuple(v.shape) for k, v in big["period"][0][1].items()} == \
        {k: v.shape[1:] for k, v in jbig["period"][0].items()}
    assert_caches_match(big, jbig, jcfg)


@pytest.mark.parametrize("prompt_len", [16, 32])
def test_serve_greedy_tokens_match_reference(reduced, prompt_len):
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len, gen=12)


def test_params_from_numpy_carries_the_reference_parameters(reduced):
    """The reference's PRNGKey(0) init carried across: the unstacked
    ``prefix/0/...`` leaves, the 3-D ``w_uk`` / ``w_uv`` (R, H, D) leaves
    (not expert tensors: unstacked only on the period axis), the router
    float32 under a bfloat16 cast, every leaf equal to the reference's."""
    jcfg, tcfg, jparams, _ = reduced
    flat = reference_flat(jparams)
    assert flat["prefix/0/attn/w_uk"].shape == (32, 4, 16)
    assert flat["period/0/attn/w_uv"].shape == (2, 32, 4, 16)
    tp = params_from_numpy(flat, tcfg, CPU)
    assert len(tp["prefix"]) == 1 and len(tp["period"][0]) == 2
    np.testing.assert_array_equal(tp["prefix"][0]["attn"]["w_uk"].numpy(),
                                  flat["prefix/0/attn/w_uk"])
    np.testing.assert_array_equal(tp["prefix"][0]["ffn"]["w_gate"].numpy(),
                                  flat["prefix/0/ffn/w_gate"])
    for i in range(2):
        np.testing.assert_array_equal(tp["period"][0][i]["attn"]["w_uv"].numpy(),
                                      flat["period/0/attn/w_uv"][i])
        np.testing.assert_array_equal(tp["period"][0][i]["ffn"]["w_gate"].numpy(),
                                      flat["period/0/ffn/w_gate"][i])
    bf = params_from_numpy(flat, tcfg, CPU, dtype=torch.bfloat16)
    assert bf["period"][0][1]["ffn"]["w_router"].dtype == torch.float32
    assert bf["prefix"][0]["attn"]["w_uk"].dtype == torch.bfloat16
    assert bf["period"][0][1]["attn"]["w_uk"].shape == (32, 4, 16)
