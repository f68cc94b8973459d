"""The port's serving slice against the JAX reference, on the CPU.

Weights go across as numpy: the in-repo checkpoint ``ckpt_29`` (reduced
smollm_360m, float32) is loaded into both packages, and a JAX PRNGKey(0)
init is converted for the serve comparison. Tolerance 1e-4 in float32:
the two packages sum the same float32 products in different orders.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths, load_checkpoint
from repro.configs.base import get_config as jax_get_config
from repro.launch.serve import serve as jax_serve
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch.checkpoint.convert import load_params_npz, params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM

CKPT = (Path(__file__).resolve().parents[1]
        / "runs/quickstart/smollm_360m_reduced/ckpt_29")
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module")
def ckpt_params():
    cfg = jax_get_config("smollm_360m", reduced=True)
    _, jparams, _ = load_checkpoint(str(CKPT), JM.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = get_config("smollm_360m", reduced=True)
    tparams = params_from_numpy(load_params_npz(str(CKPT)), tcfg, CPU)
    return cfg, jparams, tcfg, tparams


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7, 12)[None, :].repeat(2, 0)
    np.testing.assert_allclose(
        _np(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
        _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), **TOL)


def test_param_count_matches_reference():
    for reduced in (False, True):
        assert TM.param_count(get_config("smollm_360m", reduced)) == \
            JM.param_count(jax_get_config("smollm_360m", reduced))


def test_ckpt29_prefill_and_decode_match_reference(ckpt_params):
    cfg, jparams, tcfg, tparams = ckpt_params
    B, T, steps, cap = 2, 32, 16, 64
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (B, T))
    forced = rng.integers(0, cfg.vocab, (steps, B))

    jcache, jlogits = JM.prefill(jparams, cfg, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tcache, tlogits = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    for j in range(len(cfg.period)):
        for name in ("k", "v"):
            for i in range(cfg.n_periods):
                np.testing.assert_allclose(_np(tcache["period"][j][i][name]),
                                           _np(jcache["period"][j][name][i]), **TOL)

    jbig = jax.tree.map(
        lambda big, small: jax.lax.dynamic_update_slice_in_dim(big, small, 0, 1),
        JM.init_cache(cfg, B, cap), jcache)
    tbig = TM.init_cache(tcfg, B, cap, CPU)
    for big, small in zip(tbig["period"][0], tcache["period"][0]):
        for name in ("k", "v"):
            big[name][:, :T] = small[name]

    jdecode = jax.jit(lambda p, c, b: JM.decode_step(p, cfg, c, b))
    for s in range(steps):
        jl, jbig = jdecode(jparams, jbig, {"token": jnp.asarray(forced[s], jnp.int32),
                                           "cur_len": jnp.asarray(T + s, jnp.int32)})
        tl, tbig = TM.decode_step(tparams, tcfg, tbig,
                                  {"token": torch.from_numpy(forced[s]), "cur_len": T + s})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for i in range(cfg.n_periods):
        np.testing.assert_allclose(_np(tbig["period"][0][i]["k"]),
                                   _np(jbig["period"][0]["k"][i]), **TOL)


def test_serve_greedy_tokens_match_reference():
    cfg = jax_get_config("smollm_360m", reduced=True)
    flat = {k: np.asarray(v) for k, v in
            _flatten_with_paths(JM.init_params(cfg, jax.random.PRNGKey(0))).items()}
    tparams = params_from_numpy(flat, get_config("smollm_360m", reduced=True), CPU)
    ref = jax_serve("smollm_360m", reduced=True, seed=0, log=lambda _: None)
    out = serve("smollm_360m", reduced=True, seed=0, device="cpu", params=tparams,
                log=lambda _: None)
    np.testing.assert_array_equal(out["tokens"], np.asarray(ref["tokens"]))


def test_params_from_numpy_checks_shapes(ckpt_params):
    _, _, tcfg, _ = ckpt_params
    flat = load_params_npz(str(CKPT))
    flat["final_ln"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_ln"):
        params_from_numpy(flat, tcfg, CPU)
    del flat["final_ln"]
    with pytest.raises(KeyError, match="final_ln"):
        params_from_numpy(flat, tcfg, CPU)


def test_bfloat16_checkpoint_leaves_load_as_bfloat16(tmp_path):
    from repro.checkpoint.checkpoint import save_checkpoint
    cfg = jax_get_config("smollm_360m", reduced=True)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                           JM.init_params(cfg, jax.random.PRNGKey(1)))
    save_checkpoint(str(tmp_path), 0, jparams)
    flat = load_params_npz(str(tmp_path))
    tparams = params_from_numpy(flat, get_config("smollm_360m", reduced=True), CPU)
    wq = tparams["period"][0][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(wq), np.asarray(jparams["period"][0]["attn"]["wq"][1], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gradient_matches_reference_custom_vjp(dtype):
    """The reference's custom backward: float32 math, dx in x's dtype and
    dscale in float32. float32 at 1e-5; bf16 at 2e-2 (dx is rounded to bf16
    on both sides; dscale sums 3 x 7 float32 products)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 7, 32)) * 2).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((3, 7, 32)).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx, jg = jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd)
    _, vjp = jax.vjp(jcommon.rms_norm, jx, jnp.asarray(scale))
    want_dx, want_ds = vjp(jg)
    tx = torch.from_numpy(x).to(td).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    dx, ds = torch.autograd.grad(tcommon.rms_norm(tx, ts), (tx, ts),
                                 torch.from_numpy(g).to(td))
    assert dx.dtype == td and ds.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(dx), _np(jnp.asarray(want_dx, jnp.float32)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(ds), np.asarray(want_ds), rtol=tol, atol=tol)
