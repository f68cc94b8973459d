"""The port's qwen2_moe_a2_7b against the JAX reference, on the CPU: the
config field for field and its parameter counts, reduced prefill and
decode logits and caches, greedy serving, ``train_loss`` with its MoE aux
loss and every gradient, ``train()`` against the reference's ``train()``
and at the depth of the params given, and the reference's parameters
carried across (the float32 router included). Weights are the reference's PRNGKey(0)
init; tolerance 1e-4 in float32 (``_torch_dense``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dense import (CPU, assert_configs_match, assert_prefill_and_decode_match,
                          assert_serve_tokens_match, both_params, np32, reference_flat)
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim.optimizer import tree_leaves, tree_map

ARCH = "qwen2_moe_a2_7b"


@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    return (jcfg, tcfg) + both_params(jcfg, tcfg)


@pytest.mark.parametrize("reduced_cfg", [False, True])
def test_config_and_param_counts_match_reference(reduced_cfg):
    assert_configs_match(ARCH, reduced_cfg)
    assert TM.active_param_count(get_config(ARCH, reduced_cfg)) == \
        JM.active_param_count(jax_get_config(ARCH, reduced_cfg))


def test_full_config_is_qwen1_5_moe_a2_7b():
    cfg = get_config(ARCH)
    (layer,) = cfg.period
    a, m = layer.attn, layer.moe
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.tie_embeddings) == (24, 2048, 151936, False)
    assert (a.n_heads, a.n_kv_heads, a.head_dim, a.bias, a.rope_theta) == (16, 16, 128, True, 1e6)
    assert (m.n_experts, m.top_k, m.d_ff, m.n_shared, m.d_ff_shared, m.capacity_factor,
            m.group, m.norm_topk) == (60, 4, 1408, 4, 5632, 1.25, 2048, False)
    assert TM.param_count(cfg) == 14_315_735_040
    assert TM.active_param_count(cfg) == 2_689_124_352


@pytest.mark.parametrize("prompt_len,batch", [(8, 2), (32, 2), (24, 4)])
def test_prefill_and_decode_match_reference(reduced, prompt_len, batch):
    """Prefill groups of 16 tokens (one, four and six groups), then decode
    steps of ``batch`` tokens, dropless as group <= 4E."""
    jcfg, tcfg, jparams, tparams = reduced
    assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len, steps=6,
                                    batch=batch)


def test_prefill_matches_reference_where_tokens_drop(reduced):
    """Groups of 64 > 4E at capacity factor 1.0 (cap 8 a slot): the prefill
    drops tokens, in both packages the same ones."""
    jcfg, tcfg, jparams, tparams = reduced

    def dropping(cfg, moe_cls):
        layer = cfg.period[0]
        moe = moe_cls(**(dataclasses.asdict(layer.moe) | dict(group=64, capacity_factor=1.0)))
        return dataclasses.replace(cfg, period=(dataclasses.replace(layer, moe=moe),))

    jd = dropping(jcfg, type(jcfg.period[0].moe))
    td = dropping(tcfg, TMOE.MoECfg)
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 64))
    _, jl = JM.prefill(jparams, jd, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with TMOE.recording_routes() as routes:
        _, tl = TM.prefill(tparams, td, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=1e-4, atol=1e-4)
    k = td.period[0].moe.top_k
    dropped = 0
    for _, top_i in routes:
        counts = torch.nn.functional.one_hot(top_i.reshape(2, 64, k), 8).sum(1)
        dropped += int((counts - 8).clamp(min=0).sum())
    assert dropped > 0


@pytest.mark.parametrize("prompt_len", [16, 32])
def test_serve_greedy_tokens_match_reference(reduced, prompt_len):
    assert_serve_tokens_match(ARCH, reduced[3], prompt_len, gen=12)


def test_train_loss_aux_and_gradients_match_reference(reduced):
    """Loss, NLL, the MoE aux loss (summed over the layers) and the
    gradient of every weight, router included, at 1e-4 of the largest
    entry of each tensor; 4 x 40 tokens, ten groups of 16."""
    from test_torch_train_dense import _assert_trees_close

    jcfg, tcfg, jparams, tparams = reduced
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
    _assert_trees_close(got, jgrads, 1e-4, "grad")


def test_train_matches_reference_train(tmp_path):
    """Reduced qwen2, 5 steps of 8 x 64 cyclic tokens (32 groups of 16, the
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
    """``train(params=...)`` with one layer where the reduced config has
    more: the run keeps one layer, and its first loss is the one-layer
    model's (as the card trains qwen2 cut in depth)."""
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(get_config(ARCH, True), n_periods=1)
    assert get_config(ARCH, True).n_periods > 1
    params = TM.init_params(cfg, torch.Generator().manual_seed(5), CPU)
    out = train(ARCH, steps=2, ckpt_dir=str(tmp_path), ckpt_every=0, resume=False,
                device="cpu", params=params, log=lambda _: None)
    assert [len(per) for per in out["params"]["period"]] == [1]
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=64,
                                         mode="cyclic")).batch_at(0)
    with torch.no_grad():
        want, _ = TM.train_loss(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["losses"][0], want.item(), rtol=1e-6)


def test_params_from_numpy_carries_the_moe_leaves(reduced):
    """Every MoE leaf of the reference arrives with its shape and values,
    the router in float32 even where the rest is cast to bf16."""
    jcfg, tcfg, jparams, _ = reduced
    flat = reference_flat(jparams)
    moved = params_from_numpy(flat, tcfg, CPU)
    ffn = moved["period"][0][1]["ffn"]
    assert set(ffn) == {"ln", "w_router", "w_gate", "w_up", "w_down", "ws_gate", "ws_up",
                        "ws_down"}
    for name, t in ffn.items():
        np.testing.assert_array_equal(t.numpy(), flat[f"period/0/ffn/{name}"][1])
    half = params_from_numpy(flat, tcfg, CPU, dtype=torch.bfloat16)["period"][0][0]["ffn"]
    assert half["w_router"].dtype == torch.float32 and half["w_gate"].dtype == torch.bfloat16
    bad = dict(flat)
    bad["period/0/ffn/w_up"] = bad["period/0/ffn/w_up"][:, :4]
    with pytest.raises(ValueError, match="w_up"):
        params_from_numpy(bad, tcfg, CPU)
