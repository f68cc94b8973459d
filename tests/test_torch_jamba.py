"""The port's jamba_1_5_large_398b against the JAX reference, on the CPU:
the config field for field and its parameter counts, reduced prefill and
decode logits and the hybrid cache (attention KV leaves beside Mamba states
and conv tails), a prefill that drops tokens, greedy serving,
``train_loss`` with its MoE aux loss and every gradient, ``train()``
against the reference's ``train()`` and at the depth of the params given.
Weights are the reference's PRNGKey(0) init; tolerance 1e-4 in float32
(``_torch_dense``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, assert_configs_match, assert_loss_and_grads_match,
                          assert_prefill_and_decode_match, assert_serve_tokens_match,
                          both_params, np32)
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.configs.jamba_1_5_large_398b import SERVED_CUT
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.serve import rehome
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.common import ParamSpec

ARCH = "jamba_1_5_large_398b"


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_counts_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)
    assert TM.active_param_count(get_config(ARCH, reduced_cfg)) == \
        JM.active_param_count(jax_get_config(ARCH, reduced_cfg))


def test_full_config_is_jamba_1_5_large():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.tie_embeddings) == (72, 8192, 65536, False)
    assert [(l.mixer, l.ffn_kind) for l in cfg.period] == \
        [("attn", "dense")] + [("mamba", "moe" if i % 2 else "dense") for i in range(1, 8)]
    a, mb = cfg.period[0].attn, cfg.period[1].mamba
    d, m = cfg.period[0].dense, cfg.period[1].moe
    assert (a.n_heads, a.n_kv_heads, a.head_dim, a.rope_theta) == (64, 8, 128, 1e4)
    assert (mb.d_inner, mb.n_heads, mb.head_dim, mb.n_groups, mb.d_state, mb.d_conv,
            mb.chunk) == (16384, 256, 64, 8, 128, 4, 128)
    assert (d.d_ff, d.kind) == (24576, "swiglu")
    assert (m.n_experts, m.top_k, m.d_ff, m.n_shared, m.capacity_factor, m.group,
            m.norm_topk) == (16, 2, 24576, 0, 1.25, 2048, True)
    assert TM.param_count(cfg) == 398_636_186_880
    assert TM.active_param_count(cfg) == JM.active_param_count(jax_get_config(ARCH))


def test_served_cut_is_the_period_s_first_four_layers():
    """The depth one card serves: every layer kind at full width, 23.03 B
    parameters, where one period is 45.25 B."""
    full = get_config(ARCH)
    cut = dataclasses.replace(full, **SERVED_CUT)
    assert cut.n_layers == 4 and cut.period == full.period[:4]
    assert [(l.mixer, l.ffn_kind) for l in cut.period] == \
        [("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe")]
    jcut = dataclasses.replace(jax_get_config(ARCH), period=jax_get_config(ARCH).period[:4],
                               n_periods=1)
    assert TM.param_count(cut) == JM.param_count(jcut) == 23_025_240_320
    assert TM.param_count(dataclasses.replace(full, n_periods=1)) == 45_247_354_112


def test_serve_runs_at_the_period_cut_of_the_params_given():
    """``serve(params=...)`` with the period cut to its first layers, as the
    card serves full-width jamba at ``SERVED_CUT``: the run keeps the cut's
    layers (cache, prefill) and its tokens are the cut model's greedy picks;
    params deeper than the period are refused."""
    from repro_torch.launch.serve import pick, prompt_inputs, serve, step_inputs

    full = get_config(ARCH, True)
    cut = dataclasses.replace(full, period=full.period[:2], n_periods=1)
    params = TM.init_params(cut, torch.Generator().manual_seed(7), CPU)
    assert TM.at_depth_of(full, params) == cut
    run = dict(batch=2, prompt_len=16, gen=3, cache_len=24, seed=0)
    out = serve(ARCH, device="cpu", params=params, log=lambda _: None, **run)
    rng = np.random.default_rng(0)
    small, logits = TM.prefill(params, cut, prompt_inputs(cut, rng, 2, 16, "cpu"))
    assert [len(per) for per in small["period"]] == [1, 1]
    cache = rehome(TM.init_cache(cut, 2, 24, CPU), small)
    for s in range(3):
        tok = pick(cut, logits, True, None)
        np.testing.assert_array_equal(out["tokens"][:, s], tok.numpy())
        logits, cache = TM.decode_step(params, cut, cache,
                                       step_inputs(cut, tok, rng, "cpu") | {"cur_len": 16 + s})
    deeper = dict(params, period=params["period"] * 3)
    with pytest.raises(ValueError, match="period layers"):
        TM.at_depth_of(full, deeper)


@pytest.mark.parametrize("prompt_len,batch", [(16, 2), (40, 2), (32, 4)])
def test_prefill_and_decode_match_reference(reduced, prompt_len, batch):
    """Prefill groups of 16 tokens (dropless: group <= 4E), the scan over
    one, three (the last a partial chunk) and two chunks of 16, then decode
    steps: logits and every layer's cache, KV leaves and Mamba states."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=4,
                                    batch=batch)


def _dropping(cfg, moe_cls):
    """The MoE layers at group 32 > 4E and capacity factor 1.0 (cap 8 a
    slot)."""
    def lay(layer):
        if layer.ffn_kind != "moe":
            return layer
        moe = moe_cls(**(dataclasses.asdict(layer.moe) | dict(group=32, capacity_factor=1.0)))
        return dataclasses.replace(layer, moe=moe)
    return dataclasses.replace(cfg, period=tuple(lay(l) for l in cfg.period))


def test_prefill_matches_reference_where_tokens_drop(reduced):
    """Groups of 32 > 4E at capacity factor 1.0: the prefill drops tokens
    in the Mamba layers' MoE FFNs, in both packages the same ones."""
    jcfg, tcfg, jparams, tparams = reduced
    jd = _dropping(jcfg, type(jcfg.period[1].moe))
    td = _dropping(tcfg, TMOE.MoECfg)
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 64))
    _, jl = JM.prefill(jparams, jd, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with TMOE.recording_routes() as routes:
        _, tl = TM.prefill(tparams, td, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=1e-4, atol=1e-4)
    assert len(routes) == 4                   # 2 MoE layers a period, 2 periods
    m = td.period[1].moe
    _, cap = TMOE.capacity(m, 128)
    dropped = 0
    for _, top_i in routes:
        counts = torch.nn.functional.one_hot(top_i.reshape(-1, 32, m.top_k),
                                             m.n_experts).sum((1, 2))
        dropped += int((counts - cap).clamp(min=0).sum())
    assert cap == 8 and dropped > 0


@pytest.mark.parametrize("prompt_len", [16, 32])
def test_serve_greedy_tokens_match_reference(reduced, prompt_len):
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len, gen=10)


def test_train_loss_aux_and_gradients_match_reference(reduced):
    """Loss, NLL, the MoE aux loss (summed over the four MoE layers) and
    the gradient of every weight (attention, Mamba, dense FFN, router and
    experts) at 1e-4 of the largest entry of each tensor; 4 x 40 tokens."""
    jcfg, tcfg, jparams, tparams = reduced
    batch = TokenPipeline(PipelineConfig(vocab=tcfg.vocab, batch=4, seq=40,
                                         mode="cyclic")).batch_at(2)
    JM_aux = JM.train_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[1]
    with torch.no_grad():
        _, met = TM.train_loss(tparams, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert met["aux"].item() > 0
    np.testing.assert_allclose(met["aux"].item(), float(JM_aux["aux"]), rtol=1e-4, atol=1e-4)
    jgrads = assert_loss_and_grads_match(jcfg, tcfg, jparams, tparams, batch)
    names = set(_flatten_with_paths(jgrads))
    for leaf in ("period/0/attn/wq", "period/1/mamba/w_x", "period/1/mamba/A_log",
                 "period/1/ffn/w_router", "period/1/ffn/w_down", "period/2/ffn/w_gate"):
        assert leaf in names


def test_train_matches_reference_train(tmp_path):
    """Reduced jamba, 5 steps of 8 x 64 cyclic tokens (32 groups of 16, the
    MoE aux loss in every step), seed 0: the reference's ``train()`` and the
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
    """``train(params=...)`` with one period where the reduced config has
    two: the run keeps one, and its first loss is the one-period model's."""
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_config(ARCH, True), n_periods=1)
    assert get_config(ARCH, True).n_periods > 1
    params = TM.init_params(cfg, torch.Generator().manual_seed(5), CPU)
    out = train(ARCH, steps=2, ckpt_dir=str(tmp_path), ckpt_every=0, resume=False,
                device="cpu", params=params, log=lambda _: None)
    assert [len(per) for per in out["params"]["period"]] == [1, 1, 1, 1]
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=64,
                                         mode="cyclic")).batch_at(0)
    with torch.no_grad():
        want, _ = TM.train_loss(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["losses"][0], want.item(), rtol=1e-6)


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, ParamSpec):
        return {prefix: (tree.shape, tree.axes, str(tree.dtype).split(".")[-1], tree.init)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out |= _spec_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_hybrid_cache_layout_matches_reference(reduced_cfg):
    """The cache spec tree leaf for leaf against the reference's: KV leaves
    for the attention layer, a float32 state and three conv tails for each
    Mamba layer; and ``init_cache`` lays them out per layer."""
    jcfg, tcfg = jax_get_config(ARCH, reduced_cfg), get_config(ARCH, reduced_cfg)
    ref = {k: (tuple(s.shape), tuple(s.axes), jnp.dtype(s.dtype).name, s.init)
           for k, s in _flatten_with_paths(JM.cache_spec_tree(jcfg, 8, 1024)).items()}
    port = _spec_leaves(TM.cache_spec_tree(tcfg, 8, 1024))
    assert port == ref
    if not reduced_cfg:
        assert port["period/0/k"][0] == (9, 8, 1024, 8, 128)
        assert port["period/1/state"][:3:2] == ((9, 8, 256, 64, 128), "float32")
        assert port["period/1/cx"][0] == (9, 8, 3, 16384)
        assert port["period/1/cB"][0] == port["period/1/cC"][0] == (9, 8, 3, 1024)
        return
    cache = TM.init_cache(tcfg, 2, 24, CPU)
    assert [len(per) for per in cache["period"]] == [2, 2, 2, 2]
    assert set(cache["period"][0][1]) == {"k", "v"}
    for j in (1, 2, 3):
        assert set(cache["period"][j][0]) == {"state", "cx", "cB", "cC"}
        assert cache["period"][j][0]["state"].dtype == torch.float32
