"""The port's flash_attention module and model attention against the JAX
reference, on the CPU.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, as ``tests/test_kernels.py`` runs it) and through the port's plain
version; the model-level ``gqa_attention`` / ``decode_attention`` are held
against their reference counterparts. Tolerances: 2e-4 float32, 2e-2
bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as TA

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,g,tq,tk,d,window,softcap", [
    (2, 3, 24, 40, 16, 0, 0.0),     # G = 3, q_offset = 16, Tq < Tkv
    (1, 3, 32, 32, 16, 8, 0.0),     # sliding window
    (2, 1, 16, 24, 32, 0, 30.0),    # softcap, q_offset = 8
    (1, 2, 40, 40, 16, 12, 20.0),   # window + softcap
    (1, 2, 24, 40, 80, 16, 0.0),    # D = 80 (h2o_danube), G = 2, window, q_offset = 16
    (1, 12, 13, 29, 80, 9, 0.0),    # D = 80, G = 12, window, ragged Tq = 13
    (1, 2, 21, 37, 256, 9, 0.0),    # D = 256 (gemma3), G = 2, window, ragged Tq = 21
    (1, 12, 11, 24, 256, 0, 0.0),   # D = 256, G = 12, ragged Tq = 11
])
def test_plain_version_matches_reference_kernel(bh, g, tq, tk, d, window, softcap,
                                                dtype):
    """Ragged lengths run as one reference block (its blocks must tile T)."""
    (jq, jk, jv), (tq_, tk_, tv) = _inputs(
        bh * 100 + tq + tk, [(bh, g, tq, d), (bh, tk, d), (bh, tk, d)], dtype)
    q_off = tk - tq
    ref = jax_flash(jq, jk, jv, window=window, softcap=softcap, q_offset=q_off,
                    bq=8 if tq % 8 == 0 else tq, bk=8 if tk % 8 == 0 else tk,
                    interpret=True)
    out = flash_attention_ref(tq_, tk_, tv, window=window, softcap=softcap,
                              q_offset=q_off)
    assert out.dtype == tq_.dtype
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("window,softcap,q_offset,tq,tk", [
    (0, 0.0, 0, 20, 20), (6, 0.0, 0, 20, 20), (0, 25.0, 9, 11, 20)])
def test_gqa_attention_matches_reference(window, softcap, q_offset, tq, tk):
    """Model layer, ragged lengths against chunk 8: the CPU path is the
    chunked twin; the (B, T, H, D) wrapper folds to the same result."""
    B, Hkv, G, D = 2, 2, 3, 16
    (jq, jk, jv), (q, k, v) = _inputs(
        5, [(B, tq, Hkv * G, D), (B, tk, Hkv, D), (B, tk, Hkv, D)], "float32")
    jcfg = JA.AttnCfg(n_heads=Hkv * G, n_kv_heads=Hkv, head_dim=D, window=window,
                      softcap=softcap)
    tcfg = TA.AttnCfg(n_heads=Hkv * G, n_kv_heads=Hkv, head_dim=D, window=window,
                      softcap=softcap)
    # The reference's gqa_attention takes Tq == Tkv; continuation goes
    # through chunked_attention with a q_offset.
    jk_rep, jv_rep = jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2)
    ref = JA.chunked_attention(jq, jk_rep, jv_rep, window=window, softcap=softcap,
                               q_offset=q_offset, q_chunk=8, kv_chunk=8)
    chunked = TA.chunked_attention(q, k.repeat_interleave(G, 2),
                                   v.repeat_interleave(G, 2), window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    wrapped = attention(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    if tq == tk:
        jg = JA.gqa_attention(jq, jk, jv, jcfg, q_chunk=8, kv_chunk=8)
        tg = TA.gqa_attention(q, k, v, tcfg, q_chunk=8, kv_chunk=8)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q_offset,tq,tk,hkv,g", [(0, 20, 20, 4, 1), (9, 11, 20, 4, 1),
                                                  (0, 37, 37, 2, 2)])
def test_attention_with_v_head_dim_unlike_q_matches_reference(q_offset, tq, tk, hkv, g):
    """MLA's shape, q/k head dim 24 and v head dim 16 (deepseek's reduced
    192 / 128), through ``ops.attention`` (the folded layout's plain version
    on a CPU tensor) and ``gqa_attention`` against the reference's
    ``chunked_attention``, which takes Dv != Dk; the reference's Pallas
    kernel cannot (its v block takes q's head dim), so it is not run here.
    Ragged against chunk 8, continuation by ``q_offset``."""
    B, Dk, Dv = 2, 24, 16
    (jq, jk, jv), (q, k, v) = _inputs(
        7 + tq, [(B, tq, hkv * g, Dk), (B, tk, hkv, Dk), (B, tk, hkv, Dv)], "float32")
    ref = JA.chunked_attention(jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2),
                               q_offset=q_offset, q_chunk=8, kv_chunk=8)
    assert ref.shape == (B, tq, hkv * g, Dv)
    wrapped = attention(q, k, v, q_offset=q_offset)
    assert wrapped.shape == (B, tq, hkv * g, Dv)
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    if tq == tk:
        cfg = TA.AttnCfg(n_heads=hkv * g, n_kv_heads=hkv, head_dim=Dk)
        out = TA.gqa_attention(q, k, v, cfg, q_chunk=8, kv_chunk=8)
        jout = JA.gqa_attention(jq, jk, jv, JA.AttnCfg(n_heads=hkv * g, n_kv_heads=hkv,
                                                       head_dim=Dk), q_chunk=8, kv_chunk=8)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("softcap,valid", [(0.0, 7), (30.0, 12)])
def test_decode_attention_matches_reference(softcap, valid):
    B, S, Hkv, G, D = 2, 12, 2, 3, 16
    (jq, jk, jv), (q, k, v) = _inputs(
        11, [(B, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)], "float32")
    kw = dict(n_heads=Hkv * G, n_kv_heads=Hkv, head_dim=D, softcap=softcap)
    ref = JA.decode_attention(jq, jk, jv, jnp.int32(valid), JA.AttnCfg(**kw))
    out = TA.decode_attention(q, k, v, valid, TA.AttnCfg(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_non_cpu_tensor_goes_to_the_kernel_never_the_plain_version():
    q = torch.empty((1, 8, 3, 16), device="meta")
    k = torch.empty((1, 8, 1, 16), device="meta")
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, k, k)
    assert kernel.flash_attention.launches == before


@pytest.mark.parametrize("dtype,d,aligned,path", [
    (torch.bfloat16, 64, True, "mma"),       # every serving prefill
    (torch.bfloat16, 128, True, "mma"),
    (torch.bfloat16, 16, True, "mma"),
    (torch.bfloat16, 80, True, "mma"),       # h2o_danube_1_8b's prefill
    (torch.bfloat16, 256, True, "mma"),      # gemma3_12b's prefill
    (torch.bfloat16, 256, False, "ffma"),
    (torch.float32, 80, True, "ffma"),
    (torch.float32, 256, True, "ffma"),
    (torch.bfloat16, 64, False, "ffma"),     # cp.async needs 16-byte rows
    (torch.float32, 64, True, "ffma"),       # float32 parity runs
    (torch.float32, 128, False, "ffma"),
])
def test_path_choice(dtype, d, aligned, path):
    assert kernel.choose_path(dtype, d, aligned) == path
    assert set(kernel.flash_attention.paths) == set(kernel.PATH_CODES) == {"mma", "ffma"}


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 48), (torch.bfloat16, 512),
                                     (torch.float32, 8), (torch.float16, 64)])
def test_path_choice_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        kernel.choose_path(dtype, d, True)


@pytest.mark.parametrize("dtype,aligned,path", [
    (torch.bfloat16, True, "mma"),           # deepseek_v2_lite_16b's prefill (wgmma)
    (torch.bfloat16, False, "ffma"),
    (torch.float32, True, "ffma"),           # float32 parity runs
])
def test_path_choice_for_mla_head_dim_pair(dtype, aligned, path):
    """MLA's (192, 128) takes the path of a head dim of the forward; the
    reduced deepseek config's (24, 16) takes ffma in either dtype."""
    assert kernel.HEAD_DIM_PAIRS == ((192, 128), (24, 16))
    assert kernel.FFMA_PAIRS == ((24, 16),)
    assert kernel.choose_path(dtype, 192, aligned, 128) == path
    assert kernel.choose_path(dtype, 128, aligned, 128) == path
    assert kernel.choose_path(dtype, 24, aligned, 16) == "ffma"


@pytest.mark.parametrize("d,dv", [(192, 64), (128, 192), (192, 192), (128, 64), (24, 24)])
def test_path_choice_refuses_an_unknown_head_dim_pair(d, dv):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="Dv"):
            kernel.choose_path(dtype, d, True, dv)


def test_mla_pair_on_a_non_cpu_tensor_goes_to_the_kernel_and_its_backward_raises():
    """Off the CPU the pair reaches the kernels' checks, forward and
    backward alike (a meta tensor is no CUDA tensor: each raises there,
    launching nothing, never the plain version)."""
    q = torch.empty((1, 8, 2, 192), device="meta")
    k = torch.empty((1, 8, 2, 192), device="meta")
    v = torch.empty((1, 8, 2, 128), device="meta")
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, k, v)
    assert kernel.flash_attention.launches == before
    qf, kf, vf, of = (torch.empty(s, device="meta") for s in (
        (2, 1, 8, 192), (2, 8, 192), (2, 8, 128), (2, 1, 8, 128)))
    lse = torch.empty((2, 1, 8), device="meta")
    before = kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_bwd(qf, kf, vf, of, of, lse)
    assert kernel.flash_attention_bwd.launches == before


# ---------------------------------------------------------------------------
# Gradients (training): the port's autograd Function (plain forward with the
# row log-sum-exp, explicit backward formula, on CPU tensors) against
# jax.grad of the reference's plain attention in the same folded layout.
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref  # noqa: E402

GRAD_CASES = [  # (B, Tq, Tkv, Hq, Hkv, D, window, softcap)
    (2, 24, 24, 3, 1, 16, 0, 0.0),      # causal, G = 3
    (1, 30, 30, 4, 2, 16, 7, 0.0),      # sliding window, G = 2
    (2, 20, 20, 2, 2, 32, 0, 25.0),     # softcap, G = 1
    (1, 13, 29, 6, 2, 16, 0, 0.0),      # q_offset = 16, ragged Tq / Tkv
    (2, 17, 40, 3, 1, 16, 9, 20.0),     # window + softcap + q_offset
    # The dense configs' head dims: 80 (h2o_danube_1_8b, G 4, windowed) and
    # 256 (gemma3_12b, G 2, local and global), each also at G 12; ragged Tq.
    (1, 19, 30, 8, 2, 80, 7, 0.0),      # D = 80, G = 4, window, q_offset = 11
    (1, 13, 13, 12, 1, 80, 0, 0.0),     # D = 80, G = 12, global, ragged Tq = 13
    (2, 15, 20, 8, 2, 80, 6, 20.0),     # D = 80, window + softcap + q_offset
    (1, 21, 37, 4, 2, 256, 9, 0.0),     # D = 256, G = 2, window, q_offset = 16
    (2, 17, 17, 4, 2, 256, 0, 0.0),     # D = 256, G = 2, global, ragged Tq = 17
    (1, 11, 24, 12, 1, 256, 5, 0.0),    # D = 256, G = 12, window, ragged Tq = 11
    # MLA's (q/k, v) head-dim pairs: deepseek_v2_lite_16b's (192, 128) and
    # its reduced config's (24, 16), G 1 as MLA has it and G 3 with a window.
    (1, 21, 37, 2, 2, (192, 128), 0, 0.0),   # G = 1, q_offset = 16, ragged
    (2, 17, 17, 4, 2, (192, 128), 7, 0.0),   # G = 2, window
    (2, 24, 24, 4, 4, (24, 16), 0, 0.0),     # the reduced config's layer, G = 1
    (1, 13, 29, 6, 2, (24, 16), 5, 0.0),     # G = 3, window, q_offset = 16
]


def _pair(d):
    """(head dim of q and k, head dim of v) of a case's D: an int or a pair."""
    return d if isinstance(d, tuple) else (d, d)


def _jax_bthd_attention(q, k, v, **kw):
    """The reference's ops.attention layout around its plain version (v of
    its own head dim Dv)."""
    B, Tq, Hq, D = q.shape
    Tkv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qf = q.transpose(0, 2, 1, 3).reshape(B * Hkv, G, Tq, D)
    kf = k.transpose(0, 2, 1, 3).reshape(B * Hkv, Tkv, D)
    vf = v.transpose(0, 2, 1, 3).reshape(B * Hkv, Tkv, Dv)
    out = jax_flash_ref(qf, kf, vf, **kw)
    return out.reshape(B, Hq, Tq, Dv).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,hq,hkv,d,window,softcap", GRAD_CASES)
def test_attention_gradients_match_reference(b, tq, tk, hq, hkv, d, window, softcap, dtype):
    """dq, dk, dv of ``sum(g * attention(q, k, v))``: float32 at 2e-4; bf16
    at 2e-2 of each gradient's largest entry (the two sides round P and the
    products at different places). At an MLA pair, dv and the output
    gradient are of v's head dim."""
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=tk - tq)
    d, dv = _pair(d)
    (jq, jk, jv, jg), (tq_, tk_, tv, tg) = _inputs(
        b * 1000 + tq * 10 + tk, [(b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, dv),
                                  (b, tq, hq, dv)], dtype)
    want = jax.grad(lambda q, k, v: (_jax_bthd_attention(q, k, v, **kw).astype(jnp.float32)
                                     * jg.astype(jnp.float32)).sum(),
                    argnums=(0, 1, 2))(jq, jk, jv)
    args = [t.requires_grad_() for t in (tq_, tk_, tv)]
    got = torch.autograd.grad(attention(*args, **kw), args, tg)
    tol = DTYPES[dtype][2]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == args[0].dtype and g.shape == args["qkv".index(name)].shape
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max() if dtype == "bfloat16" else 1.0
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol * scale,
                                   err_msg=f"d{name}")


def test_plain_forward_log_sum_exp_matches_reference_scores():
    """The row log-sum-exp the forward keeps for the backward: logsumexp of
    the reference's masked, softcapped scores."""
    (jq, jk, _), (tq_, tk_, tv) = _inputs(3, [(2, 3, 12, 16), (2, 20, 16), (2, 20, 16)],
                                          "float32")
    kw = dict(causal=True, window=6, softcap=15.0, q_offset=8)
    out, lse = flash_attention_ref(tq_, tk_, tv, return_lse=True, **kw)
    s = jnp.einsum("bgqd,bkd->bgqk", jq, jk) / 4.0
    s = jnp.tanh(s / 15.0) * 15.0
    qp, kp = 8 + jnp.arange(12)[:, None], jnp.arange(20)[None, :]
    s = jnp.where((kp <= qp) & (kp > qp - 6), s, -1e30)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=2e-6, atol=2e-6)
    assert torch.equal(out, flash_attention_ref(tq_, tk_, tv, **kw))


def test_backward_formula_matches_autograd_of_the_plain_forward():
    """The explicit formula (``Dv = rowsum(dO o O)``) against torch.autograd
    through the plain forward, G = 4 folded as the kernels fold it."""
    (_, _, _, _), (q, k, v, do) = _inputs(
        11, [(2, 4, 9, 16), (2, 15, 16), (2, 15, 16), (2, 4, 9, 16)], "float32")
    kw = dict(causal=True, window=5, softcap=10.0, q_offset=6)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention_ref(*args, return_lse=True, **kw)
    want = torch.autograd.grad(out, args, do)
    got = flash_attention_bwd_ref(q, k, v, out.detach(), do, lse.detach(), **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("d", [48, 512])
def test_backward_takes_every_head_dim_the_forward_takes(d):
    """The backward's head dims are the forward's; a head dim neither takes
    raises a ValueError before any launch (never a plain backward, never
    the C entry's error). The backward's tiles: 64 rows or keys, but 32 on
    the ffma path at D = 256 (``ffma_tile`` in the CUDA source)."""
    assert kernel.BWD_HEAD_DIMS == kernel.HEAD_DIMS and d not in kernel.HEAD_DIMS
    q = torch.zeros((1, 2, 8, d), device="meta")
    k = torch.zeros((1, 8, d), device="meta")
    lse = torch.zeros((1, 2, 8), device="meta")
    before = kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="D in"):
        kernel.flash_attention_bwd(q, k, k, q, q, lse)
    assert kernel.flash_attention_bwd.launches == before
    assert {(h, p): kernel.bwd_tile(h, p) for h in kernel.HEAD_DIMS for p in kernel.PATH_CODES} \
        == {(h, p): 32 if (h, p) == (256, "ffma") else 64
            for h in kernel.HEAD_DIMS for p in kernel.PATH_CODES}
    assert {kernel.bwd_tile(h, p, v) for h, v in kernel.HEAD_DIM_PAIRS
            for p in kernel.PATH_CODES} == {64}


def test_attention_gradient_of_a_non_cpu_tensor_goes_to_the_kernel():
    q = torch.empty((1, 8, 3, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 8, 1, 16), device="meta", requires_grad=True)
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, k, k)
    assert kernel.flash_attention.launches == before


WALK_CASES = [  # (G, Tq, Tkv, causal, window, q_offset)
    (3, 512, 512, True, 0, 0),       # smollm_360m's training shape
    (3, 512, 512, True, 128, 0),     # sliding window
    (3, 256, 512, True, 0, 256),     # q_offset
    (1, 130, 130, True, 0, 0),       # ragged tiles, G = 1
    (3, 77, 133, True, 0, 56),       # ragged, q_offset
    (3, 300, 300, True, 100, 0),     # a window crossing tile edges
    (3, 200, 264, True, 70, 64),     # window + q_offset
    (8, 50, 70, True, 0, 20),        # G = 8
    (1, 65, 65, False, 0, 0),        # not causal
    (2, 1, 1, True, 0, 0),           # one step
    (5, 100, 100, True, 0, 0),       # G = 5 folds rows across tile edges
    (3, 130, 200, True, 10, 70),     # a window narrower than a tile
    (3, 64, 640, True, 0, 576),      # one row tile sees every key tile
    (1, 200, 77, False, 0, 0),       # not causal, fewer keys than rows
    (4, 96, 200, True, 33, 104),     # window + q_offset, G = 4
]


def _visible(g, tq, tk, causal, window, q_offset):
    """(folded row, key) pairs the attention sees: (G * Tq, Tkv) bools."""
    qpos = q_offset + torch.arange(g * tq) // g
    kp = torch.arange(tk)
    vis = torch.ones(g * tq, tk, dtype=torch.bool)
    if causal:
        vis &= kp[None] <= qpos[:, None]
    if window > 0:
        vis &= kp[None] > qpos[:, None] - window
    return vis


def _assert_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset, tile,
                                                warpgroups=kernel.DKV_WARPGROUPS[64]):
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    R, T = g * tq, tile
    vis = _visible(g, tq, tk, causal, window, q_offset)
    dq, dkv = kernel.bwd_walks(g, tq, tk, tile=tile, warpgroups=warpgroups, **kw)
    by_dq = torch.zeros(R, tk, dtype=torch.int32)
    for r0, kv0s in dq.items():
        for kv0 in kv0s:
            by_dq[r0:r0 + T, kv0:kv0 + T] += 1
    by_dkv = torch.zeros(R, tk, dtype=torch.int32)
    for kv0, walks in dkv.items():
        assert len(walks) == warpgroups
        for r0s in walks:
            for r0 in r0s:
                by_dkv[r0:r0 + T, kv0:kv0 + T] += 1
    for by in (by_dq, by_dkv):
        assert (by[vis] == 1).all() and (by <= 1).all()
    V = kernel.BWD_TILE
    for r0 in range(0, R, V):
        for kv0 in range(0, tk, V):
            if kernel.bwd_tile_visible(g, tq, tk, r0, kv0, **kw):
                assert vis[r0:r0 + V, kv0:kv0 + V].all()


@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_backward_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset):
    """The backward kernels' band arithmetic (``kernel.bwd_walks``, mirrored
    by ``csrc/flash_attention_bwd.cu``) at 64-row tiles: the dQ blocks' key
    tiles and the dK/dV warpgroups' row tiles each hold every visible
    (folded row, key) pair exactly once, and a tile pair the wgmma kernels
    leave unmasked (``bwd_tile_visible``) holds only visible pairs."""
    _assert_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset,
                                               kernel.BWD_TILE)


@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_backward_walks_at_d80_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset):
    """The same for the D = 80 wgmma kernels, whose dK/dV blocks split the
    walk over ``DKV_WARPGROUPS[80]`` warpgroups."""
    assert kernel.DKV_WARPGROUPS[80] == 2
    _assert_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset,
                                               kernel.BWD_TILE, kernel.DKV_WARPGROUPS[80])


@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_backward_walks_at_d128_cover_each_visible_pair_once(g, tq, tk, causal, window,
                                                             q_offset):
    """The same for the D = 128 wgmma kernels, whose dK/dV block is one
    warpgroup walking its keys' band whole (``DKV_WARPGROUPS[128]``)."""
    assert kernel.DKV_WARPGROUPS[128] == 1
    _assert_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset,
                                               kernel.BWD_TILE, kernel.DKV_WARPGROUPS[128])


@pytest.mark.parametrize("pair", [(192, 128), (24, 16)])
@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_backward_walks_at_mla_pairs_cover_each_visible_pair_once(g, tq, tk, causal, window,
                                                                  q_offset, pair):
    """The same at MLA's head-dim pairs' tiles (``kernel.bwd_tile`` of each
    path: 64 rows, the role-split dK/dV kernel at (192, 128) walking every
    row tile of its keys' band, ``DKV_WARPGROUPS[(192, 128)]``, as the ffma
    kernels do)."""
    assert kernel.DKV_WARPGROUPS[(192, 128)] == 1
    paths = ("ffma",) if pair in kernel.FFMA_PAIRS else tuple(kernel.PATH_CODES)
    for tile in {kernel.bwd_tile(*pair[:1], p, pair[1]) for p in paths}:
        _assert_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset, tile, 1)


@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_backward_walks_at_the_ffma_tile_of_d256_cover_each_visible_pair_once(
        g, tq, tk, causal, window, q_offset):
    """The same at the ffma path's 32-row tiles at D = 256
    (``kernel.bwd_tile(256, "ffma")``)."""
    assert kernel.bwd_tile(256, "ffma") == 32
    _assert_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset,
                                               kernel.bwd_tile(256, "ffma"))


def _assert_forward_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset, d):
    kw = dict(causal=causal, window=window, q_offset=q_offset, d=d)
    R, W = g * tq, kernel.FWD_TILE
    nc, T = kernel.FWD_WG[d]
    vis = _visible(g, tq, tk, causal, window, q_offset)
    by = torch.zeros(R, tk, dtype=torch.int32)
    for r0, walks in kernel.fwd_walks(g, tq, tk, **kw).items():
        assert len(walks) == nc
        for w, kv0s in enumerate(walks):
            rw = r0 + W * w
            assert kv0s == sorted(kv0s) and len(set(kv0s)) == len(kv0s)
            for kv0 in kv0s:
                by[rw:rw + W, kv0:kv0 + T] += 1
                if kernel.fwd_tile_visible(g, tq, tk, rw, kv0, **kw):
                    assert vis[rw:rw + W, kv0:kv0 + T].all()
    assert (by[vis] == 1).all() and (by <= 1).all()


@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_forward_walks_at_d256_cover_each_visible_pair_once(g, tq, tk, causal, window,
                                                            q_offset):
    """The D = 256 forward's band arithmetic (``kernel.fwd_walks``, mirrored
    by ``flash_fwd_wg256`` in ``csrc/flash_attention.cu``): each warpgroup's
    computed key tiles hold every visible (folded row, key) pair of its 64
    rows exactly once, and a tile it computes without its mask
    (``fwd_tile_visible``) holds only visible pairs."""
    assert kernel.FWD_ROWS == 128
    _assert_forward_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset, 256)


@pytest.mark.parametrize("d", [80, 128, (192, 128)])
@pytest.mark.parametrize("g,tq,tk,causal,window,q_offset", WALK_CASES)
def test_forward_walks_at_d80_and_d128_cover_each_visible_pair_once(g, tq, tk, causal, window,
                                                                    q_offset, d):
    """The same for ``flash_fwd_wg<DK, DV>`` at D = 80 and 128 and at MLA's
    (192, 128), whose key tiles (``kernel.FWD_WG``) are wider than a
    warpgroup's 64 rows."""
    _assert_forward_walks_cover_each_visible_pair_once(g, tq, tk, causal, window, q_offset, d)
