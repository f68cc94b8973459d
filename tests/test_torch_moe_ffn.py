"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe.moe_ffn`` on the CPU: out and aux loss in float32 at
1e-5, on numpy inputs and weights drawn from a seed. Cases: the reduced
qwen2 layer (group 16 <= 4E: dropless), groups larger than 4E at capacity
factor 1.0 (tokens dropped), a router of zeros (every probability tied: the
lower expert index must win), ``norm_topk`` on and off, with and without
shared experts, and a token count that does not split into groups. The
backward too: every gradient of the layer against ``jax.grad`` of the
reference's at 1e-4 of each tensor's largest entry in every case, the
batched products' ``autograd.Function`` against autograd of the plain
product, the combine's owner-per-row gather backward, and two backward
passes giving the same bits."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch.configs.base import get_config
from repro_torch.kernels.tile_matmul.ops import batched_product
from repro_torch.kernels.tile_matmul.ref import ACTS, tile_matmul_batched_ref, tile_matmul_ref
from repro_torch.models import moe as TMOE

TOL = dict(rtol=1e-5, atol=1e-5)
REDUCED = get_config("qwen2_moe_a2_7b", reduced=True).period[0].moe
D = 64


def _jcfg(cfg: TMOE.MoECfg) -> JMOE.MoECfg:
    return JMOE.MoECfg(**dataclasses.asdict(cfg))


def _weights(cfg: TMOE.MoECfg, seed: int, zero_router: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in TMOE.moe_specs(D, cfg, torch.float32).items():
        out[name] = (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
    if zero_router:
        out["w_router"][:] = 0.0
    return out


def _both(cfg: TMOE.MoECfg, T: int, seed: int = 0, zero_router: bool = False):
    w = _weights(cfg, seed, zero_router)
    x = np.random.default_rng(seed + 1).standard_normal((T, D)).astype(np.float32)
    j_out, j_aux = JMOE.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()},
                                _jcfg(cfg))
    t_out, t_aux = TMOE.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                      for k, v in w.items()}, cfg)
    return (np.asarray(j_out), float(j_aux)), (t_out.numpy(), float(t_aux))


def _kept(cfg: TMOE.MoECfg, T: int, seed: int = 0, zero_router: bool = False) -> int:
    """How many (token, slot) pairs the layer keeps."""
    w = {k: torch.from_numpy(v) for k, v in _weights(cfg, seed, zero_router).items()}
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((T, D))
                         .astype(np.float32))
    with TMOE.recording_routes() as routes:
        TMOE.moe_ffn(x, w, cfg)
    (_, top_i), = routes
    group, cap = TMOE.capacity(cfg, T)
    counts = torch.nn.functional.one_hot(top_i.reshape(T // group, group, -1),
                                         cfg.n_experts).sum(1)      # (G, k, E)
    return int(counts.clamp(max=cap).sum())


CASES = {
    "reduced": (REDUCED, 64),
    "drops": (dataclasses.replace(REDUCED, group=64, capacity_factor=1.0), 128),
    "norm_topk": (dataclasses.replace(REDUCED, norm_topk=True), 64),
    "norm_topk_drops": (dataclasses.replace(REDUCED, norm_topk=True, group=64,
                                            capacity_factor=1.0), 128),
    "no_shared": (dataclasses.replace(REDUCED, n_shared=0, d_ff_shared=0), 64),
    "no_shared_drops": (dataclasses.replace(REDUCED, n_shared=0, d_ff_shared=0, group=64,
                                            capacity_factor=1.0), 128),
    "top1_one_group": (dataclasses.replace(REDUCED, top_k=1, group=48), 48),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case):
    cfg, T = CASES[case]
    (j_out, j_aux), (t_out, t_aux) = _both(cfg, T)
    np.testing.assert_allclose(t_out, j_out, **TOL)
    np.testing.assert_allclose(t_aux, j_aux, **TOL)


@pytest.mark.parametrize("case", ["drops", "norm_topk_drops", "no_shared_drops"])
def test_drop_cases_really_drop(case):
    """Groups of 64 > 4E at capacity factor 1.0: cap 8 a slot, and some
    expert's queue overflows."""
    cfg, T = CASES[case]
    assert TMOE.capacity(cfg, T) == (64, 8)
    assert _kept(cfg, T) < T * cfg.top_k


@pytest.mark.parametrize("norm_topk", [False, True])
def test_tied_router_takes_the_lower_expert_index(norm_topk):
    """A router of zeros ties every probability: each token takes experts
    0 .. k-1, as ``jax.lax.top_k`` picks, and past capacity they drop."""
    cfg = dataclasses.replace(REDUCED, group=64, capacity_factor=1.0, norm_topk=norm_topk)
    (j_out, j_aux), (t_out, t_aux) = _both(cfg, 128, zero_router=True)
    np.testing.assert_allclose(t_out, j_out, **TOL)
    np.testing.assert_allclose(t_aux, j_aux, **TOL)
    x = torch.zeros((128, D))
    with TMOE.recording_routes() as routes:
        TMOE.moe_ffn(x, {k: torch.from_numpy(v)
                         for k, v in _weights(cfg, 0, zero_router=True).items()}, cfg)
    (probs, top_i), = routes
    assert torch.equal(top_i, torch.arange(cfg.top_k).expand(128, cfg.top_k))
    assert _kept(cfg, 128, zero_router=True) == 2 * cfg.top_k * 8


def test_tokens_that_do_not_split_into_groups_raise():
    with pytest.raises(ValueError, match="groups of 16"):
        TMOE.moe_ffn(torch.zeros((40, D)), {k: torch.from_numpy(v) for k, v in
                                            _weights(REDUCED, 0).items()}, REDUCED)


@pytest.mark.parametrize("cfg,tokens,want", [
    (REDUCED, 64, (16, 16)),                                  # 16 <= 4E: dropless
    (get_config("qwen2_moe_a2_7b").period[0].moe, 8192, (2048, 43)),   # prefill 8 x 1024
    (get_config("qwen2_moe_a2_7b").period[0].moe, 8, (8, 8)),          # decode: dropless
    (get_config("qwen2_moe_a2_7b").period[0].moe, 1024, (1024, 22)),   # 2 x 512
])
def test_capacity_is_the_reference_rule(cfg, tokens, want):
    assert TMOE.capacity(cfg, tokens) == want


@pytest.mark.parametrize("act", ["none", "silu"])
def test_batched_plain_version_is_one_product_an_expert(act):
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 7, 24, generator=g), torch.randn(5, 24, 16, generator=g)
    out = batched_product(x, w, activation=act)
    assert out.shape == (5, 7, 16)
    for e in range(5):
        assert torch.equal(out[e], tile_matmul_ref(x[e], w[e], activation=act))


def _grads_both(cfg: TMOE.MoECfg, T: int, seed: int = 0):
    """The gradient of ``sum(out * c) + aux`` with respect to x and every
    weight, by ``jax.grad`` of the reference's layer and by autograd of the
    port's (the batched products' backward, ``_Batched``, and the
    combine's, ``_Gather``), on one numpy cotangent ``c``."""
    w = _weights(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    c = rng.standard_normal((T, D)).astype(np.float32)

    def jloss(x, w):
        out, aux = JMOE.moe_ffn(x, w, _jcfg(cfg))
        return jnp.sum(out * c) + aux

    jx, jw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                            {k: jnp.asarray(v) for k, v in w.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out, aux = TMOE.moe_ffn(tx, tw, cfg)
    (out * torch.from_numpy(c)).sum().add(aux).backward()
    want = {"x": np.asarray(jx)} | {k: np.asarray(v) for k, v in jw.items()}
    got = {"x": tx.grad.numpy()} | {k: v.grad.numpy() for k, v in tw.items()}
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_gradients_match_reference(case):
    """x, the router, the three expert weights and the shared weights, each
    within 1e-4 of its tensor's largest entry (float32), in every case:
    dropless, dropping, ``norm_topk``, no shared experts, one group."""
    cfg, T = CASES[case]
    got, want = _grads_both(cfg, T)
    assert got.keys() == want.keys() and "w_router" in got
    for name, ref in want.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got[name], ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("trans", ["trans_x", "trans_w"])
def test_batched_plain_version_reads_either_operand_transposed(trans):
    """``tile_matmul_batched_ref`` in the gradients' layouts is one
    ``tile_matmul_ref`` an expert in the same layout: ``x^T @ w`` with x
    stored (E, K, M), ``x @ w^T`` with w stored (E, N, K)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 24, 7, generator=g) if trans == "trans_x" else \
        torch.randn(4, 7, 24, generator=g)
    w = torch.randn(4, 16, 24, generator=g) if trans == "trans_w" else \
        torch.randn(4, 24, 16, generator=g)
    out = tile_matmul_batched_ref(x, w, **{trans: True})
    assert out.shape == (4, 7, 16)
    for e in range(4):
        assert torch.equal(out[e], tile_matmul_ref(x[e], w[e], **{trans: True}))
        torch.testing.assert_close(out[e], (x[e].T @ w[e]) if trans == "trans_x"
                                   else (x[e] @ w[e].T), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["none", "silu"])
def test_batched_product_backward_is_autograd_of_the_plain_product(act):
    """``batched_product`` under autograd (``_Batched``: z recomputed for the
    activation, then ``dz @ w^T`` and ``x^T @ dz`` as batched products)
    gives autograd's gradients of the plain per-expert product."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 9, 24, generator=g, dtype=torch.float64).float().requires_grad_()
    w = torch.randn(3, 24, 16, generator=g).requires_grad_()
    dy = torch.randn(3, 9, 16, generator=g)
    out = batched_product(x, w, activation=act)
    dx, dw = torch.autograd.grad(out, (x, w), dy)
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    plain = torch.stack([ACTS[act](xr[e] @ wr[e]) for e in range(3)])
    want_dx, want_dw = torch.autograd.grad(plain, (xr, wr), dy)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-5)


def test_combine_gather_backward_gives_each_row_its_one_gradient():
    """``_Gather``'s backward against autograd's gather backward (which adds
    by index): equal where the kept indices are unique; the rows no pair
    reads get zero, and a dropped pair (index ``len(y)``) reads row 0 and
    sends nothing back."""
    g = torch.Generator().manual_seed(3)
    y = torch.randn(10, 5, generator=g).requires_grad_()
    idx = torch.tensor([3, 10, 0, 7, 10, 9, 1])
    gout = torch.randn(len(idx), 5, generator=g)
    got = TMOE._Gather.apply(y, idx)
    assert torch.equal(got[1], y[0]) and torch.equal(got[0], y[3])
    (dy,) = torch.autograd.grad(got, y, gout)
    keep = idx < 10
    (want,) = torch.autograd.grad(y[idx[keep]], y, gout[keep])
    assert torch.equal(dy, want)
    assert not dy[[2, 4, 5, 6, 8]].any()


def test_moe_ffn_backward_gives_the_same_bits_twice():
    """Two backward passes of one dropping layer from the same state: every
    gradient the same bits (no accumulation by index)."""
    cfg, T = CASES["drops"]
    runs = [_grads_both(cfg, T)[0] for _ in range(2)]
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])


def test_moe_ffn_gradient_flows_on_the_cpu():
    """Training's path on the CPU: the plain products are differentiable,
    and the aux loss reaches the router."""
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in _weights(REDUCED, 0).items()}
    x = torch.randn(32, D, generator=torch.Generator().manual_seed(3))
    out, aux = TMOE.moe_ffn(x, w, REDUCED)
    (out.square().mean() + aux).backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in w.values())
    assert w["w_gate"].grad.abs().sum() > 0 and w["w_router"].grad.abs().sum() > 0


def test_route_recording_sees_only_its_own_thread():
    """A recording collects this thread's calls, not a concurrent thread's
    (the ACAN runner runs handler threads beside its caller)."""
    w = {k: torch.from_numpy(v) for k, v in _weights(REDUCED, 0).items()}
    x = torch.randn(32, D, generator=torch.Generator().manual_seed(5))
    with TMOE.recording_routes() as routes:
        other = threading.Thread(target=TMOE.moe_ffn, args=(x, w, REDUCED))
        other.start()
        other.join()
        TMOE.moe_ffn(x[:16], w, REDUCED)
    assert [top_i.shape[0] for _, top_i in routes] == [16]
