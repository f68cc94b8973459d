"""Shared parity checks of the attention configs (gemma3_12b,
h2o_danube_1_8b, command_r_plus_104b; qwen2_moe_a2_7b and
deepseek_v2_lite_16b; musicgen_medium and internvl2_76b, whose inputs are
codebook tokens and embeddings) between the port and the JAX reference, on
the CPU, for ``tests/test_torch_{gemma3,danube,command_r,qwen2_moe,deepseek,
musicgen,internvl2}.py``.

Weights are a JAX PRNGKey(0) init of the reduced config carried over as
numpy through ``params_from_numpy``; inputs are numpy draws given to both.
Tolerance 1e-4 in float32: the two packages sum the same float32 products
in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs.base import get_config as jax_get_config
from repro.launch.serve import serve as jax_serve
from repro.models import model as JM
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import rehome, serve
from repro_torch.models import model as TM

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def reference_flat(jparams) -> dict:
    return {k: np.asarray(v) for k, v in _flatten_with_paths(jparams).items()}


def both_params(jcfg, tcfg, seed: int = 0):
    """A JAX init of ``jcfg`` and the same weights in the port's tree."""
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(reference_flat(jparams), tcfg, CPU)


def assert_configs_match(arch: str, reduced: bool) -> None:
    assert dataclasses.asdict(get_config(arch, reduced)) == \
        dataclasses.asdict(jax_get_config(arch, reduced))
    assert TM.param_count(get_config(arch, reduced)) == \
        JM.param_count(jax_get_config(arch, reduced))


def jax_rehome(big, small):
    """The reference's ``rehome`` (``repro/launch/serve.py``, a closure of
    ``serve``), leaf by leaf."""
    small = small.astype(big.dtype)
    if big.shape == small.shape:
        return small
    diff = [i for i, (a, b) in enumerate(zip(big.shape, small.shape)) if a != b]
    assert len(diff) == 1, (big.shape, small.shape)
    return jax.lax.dynamic_update_slice_in_dim(big, small, 0, diff[0])


def assert_caches_match(tcache, jcache, cfg) -> None:
    """The port's per-layer caches (``cache["prefix"][l]``,
    ``cache["period"][j][i]``) against the reference's (``cache["prefix"][l]``,
    stacked ``cache["period"][j][name][i]``), every leaf: ``k`` and ``v``, or
    MLA's latent ``c`` and ``kr``."""
    for l in range(len(cfg.prefix)):
        assert tcache["prefix"][l].keys() == jcache["prefix"][l].keys()
        for name, t in tcache["prefix"][l].items():
            np.testing.assert_allclose(np32(t), np32(jcache["prefix"][l][name]), **TOL)
    for j in range(len(cfg.period)):
        for i in range(cfg.n_periods):
            assert tcache["period"][j][i].keys() == jcache["period"][j].keys()
            for name, t in tcache["period"][j][i].items():
                np.testing.assert_allclose(np32(t), np32(jcache["period"][j][name][i]), **TOL)


def frontend_inputs(cfg, rng, batch: int, prompt_len: int, steps: int) -> tuple:
    """Numpy inputs of ``cfg``'s frontend: a prefill batch and ``steps``
    decode-step inputs. Tokens (B, T), then (B,) a step; codebooks (B, T, K),
    then (B, K); embeds float32 standard normals (B, T, d), then (B, d)."""
    if cfg.frontend == "embeds":
        prompt = rng.standard_normal((batch, prompt_len, cfg.d_model)).astype(np.float32)
        forced = rng.standard_normal((steps, batch, cfg.d_model)).astype(np.float32)
        return {"embeds": prompt}, [{"embed": x} for x in forced]
    books = (cfg.n_codebooks,) if cfg.frontend == "codebooks" else ()
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len) + books)
    forced = rng.integers(0, cfg.vocab, (steps, batch) + books)
    return {"tokens": prompt}, [{"token": t} for t in forced]


def to_jax(inputs: dict) -> dict:
    """Numpy inputs as the reference takes them: ids int32, embeddings float32."""
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in inputs.items()}


def to_torch(inputs: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


def assert_prefill_and_decode_match(jcfg, tcfg, jparams, tparams, prompt_len: int,
                                    steps: int, batch: int = 2, seed: int = 0) -> None:
    """Prefill ``prompt_len`` positions in both packages, re-home each cache
    into a decode cache of ``prompt_len + steps`` slots with its own
    package's ``rehome``, then decode ``steps`` forced inputs (tokens,
    codebook tokens or embeddings, as the frontend takes them): logits and
    caches at 1e-4 after the prefill, after the re-home and after every
    step (a windowed layer's ring wraps once the steps pass the window)."""
    rng = np.random.default_rng(seed + prompt_len)
    prompt, forced = frontend_inputs(jcfg, rng, batch, prompt_len, steps)
    cap = prompt_len + steps
    jcache, jl = JM.prefill(jparams, jcfg, to_jax(prompt))
    tcache, tl = TM.prefill(tparams, tcfg, to_torch(prompt))
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_caches_match(tcache, jcache, jcfg)
    jbig = jax.tree.map(jax_rehome, JM.init_cache(jcfg, batch, cap), jcache)
    tbig = rehome(TM.init_cache(tcfg, batch, cap, CPU), tcache)
    assert_caches_match(tbig, jbig, jcfg)
    jdecode = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b))
    for s in range(steps):
        jl, jbig = jdecode(jparams, jbig, to_jax(forced[s])
                           | {"cur_len": jnp.asarray(prompt_len + s, jnp.int32)})
        tl, tbig = TM.decode_step(tparams, tcfg, tbig,
                                  to_torch(forced[s]) | {"cur_len": prompt_len + s})
        np.testing.assert_allclose(np32(tl), np32(jl), err_msg=f"step {s}", **TOL)
    assert_caches_match(tbig, jbig, jcfg)


def assert_loss_and_grads_match(jcfg, tcfg, jparams, tparams, batch: dict) -> dict:
    """``train_loss`` of both packages on the numpy ``batch``: the loss and
    its NLL at 1e-4, the gradient of every weight at 1e-4 of the largest
    entry of its reference tensor. Returns the reference's gradients."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.optim.optimizer import tree_leaves, tree_map

    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), tparams)
    loss, met = TM.train_loss(leaves, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(met["nll"].item(), float(jmet["nll"]), **TOL)
    got = {k: np32(v) for k, v in _flatten(tree_map(lambda _: next(grads), tparams)).items()}
    want = reference_flat(jgrads)
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"grad {k}")
    return jgrads


def assert_serve_tokens_match(arch: str, tparams, prompt_len: int, gen: int) -> None:
    """Greedy ``serve()`` of the reduced config in both packages, the port
    given the reference's PRNGKey(0) weights: the same tokens ((B, gen, K)
    for codebooks)."""
    kw = dict(reduced=True, seed=0, prompt_len=prompt_len, gen=gen,
              cache_len=prompt_len + gen, log=lambda _: None)
    ref = jax_serve(arch, **kw)
    out = serve(arch, device="cpu", params=tparams, **kw)
    np.testing.assert_array_equal(out["tokens"], np.asarray(ref["tokens"]))
