"""The port's Mamba-2 serving slice against the JAX reference, on the CPU.

Inputs are made with numpy and given to both packages; model weights are a
JAX PRNGKey(0) init carried over with ``params_from_numpy``. Tolerance 1e-4
in float32 (the bar the smollm checkpoint test uses): the two packages sum
the same float32 products in different orders. The SSD scan itself is held
at the reference's SSD bar, 1e-3, where a decode step continues a chunked
prefill (as ``tests/test_kernels.py`` does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths, save_checkpoint
from repro.configs.base import get_config as jax_get_config
from repro.launch.serve import serve as jax_serve
from repro.models import blocks as JB
from repro.models import mamba2 as JMB
from repro.models import model as JM
from repro_torch.checkpoint.convert import load_params_npz, params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import rehome, serve
from repro_torch.models import blocks as TB
from repro_torch.models import mamba2 as TMB
from repro_torch.models import model as TM
from repro_torch.models.common import ParamSpec, tree_map_specs

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ARCH = "mamba2_2_7b"


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _ssd_inputs(bt, t, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((bt, t, h, p)) * 0.5).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((bt, t, h)))).astype(np.float32),
            (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32),
            (rng.standard_normal((bt, t, g, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((bt, t, g, n)) * 0.5).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32))


def _reference_flat(cfg):
    return {k: np.asarray(v) for k, v in
            _flatten_with_paths(JM.init_params(cfg, jax.random.PRNGKey(0))).items()}


@pytest.fixture(scope="module")
def reduced_params():
    cfg = jax_get_config(ARCH, reduced=True)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = get_config(ARCH, reduced=True)
    tparams = params_from_numpy(_reference_flat(cfg), tcfg, CPU)
    return cfg, jparams, tcfg, tparams


@pytest.mark.parametrize("t,k,c", [(9, 4, 6), (2, 4, 5), (16, 3, 8)])
def test_causal_conv_matches_reference(t, k, c):
    rng = np.random.default_rng(t + k + c)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    np.testing.assert_allclose(
        _np(TMB._causal_conv(torch.from_numpy(x), torch.from_numpy(w))),
        _np(JMB._causal_conv(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)


def test_segsum_matches_reference():
    dA = -np.abs(np.random.default_rng(0).standard_normal((3, 8))).astype(np.float32)
    np.testing.assert_allclose(_np(TMB._segsum(torch.from_numpy(dA))),
                               _np(JMB._segsum(jnp.asarray(dA))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,chunk,g", [(40, 16, 2), (32, 16, 1), (7, 16, 4)])
def test_ssd_chunked_matches_reference(t, chunk, g):
    args = _ssd_inputs(2, t, 4, 8, g, 16, seed=t + g)
    yr, sr = JMB.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, s = TMB.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert tuple(s.shape) == (2, 4, 8, 16)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL)
    np.testing.assert_allclose(_np(s), _np(sr), **TOL)


def test_ssd_chunked_bf16_matches_reference():
    args = list(_ssd_inputs(2, 24, 4, 8, 2, 8, seed=5))
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
        targs[i] = targs[i].bfloat16()
    yr, sr = JMB.ssd_chunked(*jargs, chunk=16)
    y, s = TMB.ssd_chunked(*targs, chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(s), _np(sr), rtol=1e-3, atol=1e-3)


def test_ssd_decode_step_matches_reference():
    x, dt, A, B, C, D = _ssd_inputs(2, 1, 4, 8, 2, 16, seed=9)
    state = np.random.default_rng(1).standard_normal((2, 4, 8, 16)).astype(np.float32)
    args = (state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    yr, sr = JMB.ssd_decode_step(*map(jnp.asarray, args))
    y, s = TMB.ssd_decode_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(y), _np(yr), **TOL)
    np.testing.assert_allclose(_np(s), _np(sr), **TOL)


def test_ssd_decode_continues_chunked():
    """ssd_chunked final state + ssd_decode_step ≡ one longer ssd_chunked
    (prefill→decode continuity for the SSM cache), as in test_kernels.py."""
    bt, t, h, p, g, n = 2, 32, 4, 8, 2, 8
    x, dt, A, B, C, D = map(torch.from_numpy, _ssd_inputs(bt, t + 1, h, p, g, n, seed=2))
    y_full, s_full = TMB.ssd_chunked(x, dt, A, B, C, D, chunk=16)
    _, s_pre = TMB.ssd_chunked(x[:, :t], dt[:, :t], A, B[:, :t], C[:, :t], D, chunk=16)
    y_step, s_step = TMB.ssd_decode_step(s_pre, x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
    np.testing.assert_allclose(_np(y_step), _np(y_full[:, t]), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(s_step), _np(s_full), rtol=1e-3, atol=1e-3)


def _layer_params(lcfg, d, seed):
    """One mamba block's params as numpy, from the port's spec tree."""
    rng = np.random.default_rng(seed)

    def init(s: ParamSpec):
        if s.init == "ones":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        scale = 0.3 if s.init in ("zeros", "small") else 0.2
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return tree_map_specs(init, TB.block_specs(d, lcfg, torch.float32))["mamba"]


def test_mamba_train_hands_the_scan_contiguous_inputs(monkeypatch):
    """The conv's output is made contiguous once, so the scan's x, B and C
    need no copy in the kernel wrapper."""
    seen = []

    def spy(x4, dt, A, B5, C5, D, chunk):
        seen.extend([x4, B5, C5])
        return TMB.ssd_chunked(x4, dt, A, B5, C5, D, chunk)

    monkeypatch.setattr(TB, "_ssd", spy)
    m = TMB.MambaCfg(d_inner=32, d_state=16, d_conv=4, head_dim=8, n_groups=2, chunk=8)
    lcfg = TB.LayerCfg(mixer="mamba", mamba=m)
    p = {k: torch.from_numpy(v) for k, v in _layer_params(lcfg, 24, seed=4).items()}
    TB.mamba_train(p, torch.randn(2, 9, 24), lcfg)
    assert len(seen) == 3 and all(t.is_contiguous() for t in seen)


def test_mamba_train_and_decode_match_reference():
    """One block, P != N, G = 2: prefill output and cache, then three decode
    steps, each against the reference block; the cache ``state`` is
    (B, H, P, N) on both sides."""
    m = TMB.MambaCfg(d_inner=32, d_state=16, d_conv=4, head_dim=8, n_groups=2, chunk=8)
    tl = TB.LayerCfg(mixer="mamba", mamba=m)
    jl = JB.LayerCfg(mixer="mamba", mamba=JMB.MambaCfg(**dataclasses.asdict(m)))
    d, B, T = 24, 2, 13
    p = _layer_params(tl, d, seed=4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    jout, jcache = JB.mamba_train(jp, jnp.asarray(x), jl, want_cache=True)
    tout, tcache = TB.mamba_train(tp, torch.from_numpy(x), tl, want_cache=True)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    spec = TB.cache_specs(tl, B, 64, torch.float32)
    assert set(tcache) == set(jcache) == set(spec)
    assert tuple(tcache["state"].shape) == spec["state"].shape == (B, 4, 8, 16)
    for name in spec:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), **TOL)
    for step in range(3):
        xt = rng.standard_normal((B, d)).astype(np.float32)
        jout, jcache = JB.mamba_decode(jp, jnp.asarray(xt), jcache, jl)
        tout, tcache = TB.mamba_decode(tp, torch.from_numpy(xt), tcache, tl)
        np.testing.assert_allclose(_np(tout), _np(jout), **TOL, err_msg=f"step {step}")
        for name in spec:
            np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), **TOL)


def test_reduced_mamba2_prefill_and_decode_match_reference(reduced_params):
    cfg, jparams, tcfg, tparams = reduced_params
    B, T, steps, cap = 2, 32, 16, 64
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (B, T))
    forced = rng.integers(0, cfg.vocab, (steps, B))

    jcache, jlogits = JM.prefill(jparams, cfg, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tcache, tlogits = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    for name in ("state", "cx", "cB", "cC"):
        for i in range(cfg.n_periods):
            np.testing.assert_allclose(_np(tcache["period"][0][i][name]),
                                       _np(jcache["period"][0][name][i]), **TOL)

    jbig = JM.init_cache(cfg, B, cap)
    jbig = jax.tree.map(lambda big, small: small.astype(big.dtype), jbig, jcache)
    tbig = rehome(TM.init_cache(tcfg, B, cap, CPU), tcache)
    jdecode = jax.jit(lambda p, c, b: JM.decode_step(p, cfg, c, b))
    for s in range(steps):
        jl, jbig = jdecode(jparams, jbig, {"token": jnp.asarray(forced[s], jnp.int32),
                                           "cur_len": jnp.asarray(T + s, jnp.int32)})
        tl, tbig = TM.decode_step(tparams, tcfg, tbig,
                                  {"token": torch.from_numpy(forced[s]), "cur_len": T + s})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL, err_msg=f"step {s}")
    for i in range(cfg.n_periods):
        np.testing.assert_allclose(_np(tbig["period"][0][i]["state"]),
                                   _np(jbig["period"][0]["state"][i]), **TOL)


@pytest.mark.parametrize("prompt_len", [32, 40])
def test_serve_greedy_tokens_match_reference(reduced_params, prompt_len):
    _, _, _, tparams = reduced_params
    quiet = dict(reduced=True, seed=0, prompt_len=prompt_len, log=lambda _: None)
    ref = jax_serve(ARCH, **quiet)
    out = serve(ARCH, device="cpu", params=tparams, **quiet)
    np.testing.assert_array_equal(out["tokens"], np.asarray(ref["tokens"]))


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_matches_reference(reduced):
    assert TM.param_count(get_config(ARCH, reduced)) == \
        JM.param_count(jax_get_config(ARCH, reduced))


def test_full_config_spec_trees_match_reference_leaf_for_leaf():
    def leaves(tree):
        return {k: (tuple(s.shape), tuple(s.axes), jnp.dtype(s.dtype).name, s.init)
                for k, s in _flatten_with_paths(tree).items()}

    def port_leaves(tree, prefix=""):
        if isinstance(tree, ParamSpec):
            return {prefix: (tree.shape, tree.axes, str(tree.dtype).split(".")[-1],
                             tree.init)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out |= port_leaves(v, f"{prefix}/{k}" if prefix else str(k))
        return out

    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    ref = leaves(JM.param_specs(jcfg))
    port = port_leaves(TM.param_specs(tcfg))
    assert port == ref
    assert port["period/0/mamba/A_log"][2] == "float32"
    assert port["period/0/mamba/w_z"] == ((64, 2560, 5120), ("stack", "embed", "mlp"),
                                          "bfloat16", "normal")
    assert port_leaves(TM.cache_spec_tree(tcfg, 8, 1024)) == \
        leaves(JM.cache_spec_tree(jcfg, 8, 1024))


def test_bf16_mamba_checkpoint_crosses_over_with_f32_leaves_kept(tmp_path):
    cfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), param_dtype="bfloat16")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(1))
    save_checkpoint(str(tmp_path), 0, jparams)
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True), param_dtype="bfloat16")
    tparams = params_from_numpy(load_params_npz(str(tmp_path)), tcfg, CPU)
    layer = tparams["period"][0][1]["mamba"]
    assert layer["w_z"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias", "norm_gate", "ln"):
        assert layer[name].dtype == torch.float32, name
    for name in ("w_z", "conv_x", "D"):
        np.testing.assert_array_equal(
            _np(layer[name]), np.asarray(jparams["period"][0]["mamba"][name][1], np.float32))


def test_prefill_cache_holds_copies_not_views_of_the_projections(reduced_params):
    """The conv buffers keep the last d_conv - 1 steps; a view would keep
    each layer's whole (B, T, d_inner) projection alive with the cache."""
    _, _, tcfg, tparams = reduced_params
    cache, _ = TM.prefill(tparams, tcfg, {"tokens": torch.zeros((2, 40), dtype=torch.int64)})
    for layer in cache["period"][0]:
        for name in ("cx", "cB", "cC"):
            t = layer[name]
            assert t.shape[1] == 3
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
