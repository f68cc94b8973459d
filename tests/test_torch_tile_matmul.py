"""The port's tile_matmul module against the JAX reference, on the CPU.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, through ``repro.kernels.tile_matmul.ops.matmul``, as
``tests/test_kernels.py`` runs it) and through the port's wrapper, which on
a CPU tensor runs the plain PyTorch version. Tolerances are the
reference's own: 2e-4 in float32, 2e-2 in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tile_matmul.ops import matmul as jax_matmul
from repro.models.mlp import DenseFfnCfg as JDenseFfnCfg
from repro.models.mlp import dense_ffn as jax_dense_ffn
from repro_torch.kernels.tile_matmul import kernel
from repro_torch.kernels.tile_matmul.ops import matmul
from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref
from repro_torch.models.mlp import DenseFfnCfg, dense_ffn

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "tanh", "relu", "silu", "gelu"])
@pytest.mark.parametrize("m,k,n,bias", [(24, 40, 20, True), (8, 96, 48, False),
                                        (3, 16, 8, True), (64, 128, 72, False)])
def test_matmul_matches_reference_kernel(m, k, n, bias, act, dtype):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    jb, tb = _both(b, dtype) if bias else (None, None)
    ref = jax_matmul(jx, jw, jb, activation=act, bm=16, bn=8, bk=16)
    out = matmul(tx, tw, tb, activation=act)
    assert out.dtype == tx.dtype and out.shape == (m, n)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_matmul_folds_leading_axes_and_out_dtype():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((12, 7)).astype(np.float32))
    out = matmul(x.bfloat16(), w.bfloat16(), out_dtype=torch.float32)
    assert out.shape == (2, 5, 7) and out.dtype == torch.float32
    torch.testing.assert_close(out, x.bfloat16().float() @ w.bfloat16().float(),
                               rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 64)[:, None]
    out = tile_matmul_ref(x, torch.ones(1, 1), activation="gelu")
    torch.testing.assert_close(out, torch.nn.functional.gelu(x, approximate="tanh"))
    assert (out - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_non_cpu_tensor_goes_to_the_kernel_never_the_plain_version():
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((8, 4), device="meta")
    before = kernel.tile_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        matmul(x, w)
    assert kernel.tile_matmul.launches == before


# (M, K, N, dtype, 16-byte aligned) -> path. Every projection of both
# serving paths (smollm_360m, mamba2_2_7b) at prefill (M 4096) and decode
# (M 8), then the shapes TMA or the 16-byte weight loads cannot address.
_SERVING = sorted({(960, 960), (960, 320), (960, 2560), (2560, 960),
                   (2560, 5120), (2560, 128), (2560, 80), (5120, 2560)})
PATH_CASES = (
    [(4096, k, n, torch.bfloat16, True, "wgmma") for k, n in _SERVING]
    + [(8, k, n, torch.bfloat16, True, "skinny") for k, n in _SERVING]
    + [(4096, k, n, torch.float32, True, "ffma") for k, n in _SERVING]
    + [(8, k, n, torch.float32, True, "skinny") for k, n in _SERVING]
    + [(257, 40, 20, torch.bfloat16, True, "mma"),    # N % 8 != 0
       (300, 36, 128, torch.bfloat16, True, "mma"),   # K % 8 != 0
       (300, 960, 320, torch.bfloat16, False, "mma"),  # unaligned pointer
       (3, 40, 20, torch.bfloat16, True, "mma"),      # 40-byte weight rows
       (3, 40, 20, torch.float32, True, "skinny"),    # 80-byte weight rows
       (8, 40, 18, torch.float32, True, "ffma"),      # 72-byte weight rows
       (8, 960, 320, torch.bfloat16, False, "mma"),
       (16, 96, 80, torch.bfloat16, True, "skinny"),
       (17, 96, 80, torch.bfloat16, True, "wgmma"),
       (4097, 72, 136, torch.bfloat16, True, "wgmma"),
       (64, 0, 8, torch.bfloat16, True, "mma")])      # K = 0: no TMA box


@pytest.mark.parametrize("m,k,n,dtype,aligned,path", PATH_CASES)
def test_path_choice(m, k, n, dtype, aligned, path):
    assert kernel.choose_path(m, n, k, dtype, aligned) == path
    assert set(kernel.tile_matmul.paths) == set(kernel.PATH_CODES) == {
        "wgmma", "mma", "skinny", "ffma"}


def test_path_choice_ignores_m_above_the_decode_bound():
    """Tile shape and K order depend on (N, K) only: every M > 16 of a
    shape takes one path, so a row's result does not depend on its batch."""
    for k, n in _SERVING:
        assert {kernel.choose_path(m, n, k, torch.bfloat16, True)
                for m in (17, 300, 4096, 4097, 65536)} == {"wgmma"}


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_dense_ffn_matches_reference(kind):
    rng = np.random.default_rng(3)
    d, f = 24, 40
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"w_up": rng.standard_normal((d, f)) * 0.2,
         "w_down": rng.standard_normal((f, d)) * 0.2}
    if kind == "swiglu":
        p["w_gate"] = rng.standard_normal((d, f)) * 0.2
    else:
        p["b_up"] = rng.standard_normal(f) * 0.1
        p["b_down"] = rng.standard_normal(d) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ref = jax_dense_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                        JDenseFfnCfg(d_ff=f, kind=kind))
    out = dense_ffn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                    DenseFfnCfg(d_ff=f, kind=kind))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Gradients (training): the port's autograd Function against jax.grad of the
# reference's plain product (its Pallas kernel has no backward).
# ---------------------------------------------------------------------------

from repro.kernels.tile_matmul.ref import tile_matmul_ref as jax_tile_matmul_ref  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "tanh", "relu", "silu", "gelu"])
@pytest.mark.parametrize("m,k,n,bias", [(24, 40, 20, True), (64, 128, 72, False),
                                        (3, 16, 8, True)])
def test_matmul_gradients_match_reference(m, k, n, bias, act, dtype):
    """dx, dw and db of ``sum(g * act(x @ w + b))`` against jax.grad, with the
    forward in ``dtype`` and float32 accumulation in both. float32 at 2e-4;
    bf16 at 2e-2 of each gradient's largest entry (dw sums M products and
    reaches about 8 here): the port rounds dz to bf16 before its two
    products, as the kernels take bf16 operands, where JAX multiplies the
    float32 cotangent."""
    rng = np.random.default_rng(m * 100 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    g = rng.standard_normal((m, n)).astype(np.float32)
    jd, td, tol = DTYPES[dtype]

    def jloss(xx, ww, bb):
        y = jax_tile_matmul_ref(xx, ww, bb, activation=act, out_dtype=jnp.float32)
        return (y * jnp.asarray(g)).sum()

    jargs = [jnp.asarray(a).astype(jd) for a in (x, w)] + [
        jnp.asarray(b).astype(jd) if bias else None]
    want = jax.grad(jloss, argnums=(0, 1, 2) if bias else (0, 1))(*jargs)
    targs = [torch.from_numpy(a).to(td).requires_grad_() for a in (x, w)] + [
        torch.from_numpy(b).to(td).requires_grad_() if bias else None]
    y = matmul(*targs, activation=act, out_dtype=torch.float32)
    got = torch.autograd.grad(y, [t for t in targs if t is not None], torch.from_numpy(g))
    for gt, wt in zip(got, want):
        assert gt.dtype == td
        wt = np.asarray(wt, np.float32)
        scale = np.abs(wt).max() if dtype == "bfloat16" else 1.0
        np.testing.assert_allclose(gt.float().numpy(), wt, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("trans_x,trans_w", [(False, False), (False, True), (True, False)])
def test_plain_version_layouts_match_the_reference_kernel(trans_x, trans_w):
    """``trans_x`` / ``trans_w`` read the stored operand transposed: the
    same product as the reference kernel (interpret mode) on the
    transposed arrays."""
    rng = np.random.default_rng(7)
    m, k, n = 48, 40, 24
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    ref = jax_matmul(jnp.asarray(x), jnp.asarray(w), activation="silu", bm=16, bn=8, bk=8)
    xs = np.ascontiguousarray(x.T) if trans_x else x
    ws = np.ascontiguousarray(w.T) if trans_w else w
    out = tile_matmul_ref(torch.from_numpy(xs), torch.from_numpy(ws), activation="silu",
                          trans_x=trans_x, trans_w=trans_w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,k,n,dtype,layout,path", [
    (960, 4096, 320, torch.bfloat16, "x^T@w", "wgmma"),    # smollm dw of wk
    (960, 300, 320, torch.bfloat16, "x^T@w", "wgmma"),     # K counts x^T's rows
    (4096, 2560, 960, torch.bfloat16, "x@w^T", "wgmma"),   # smollm dx of w_gate
    (8, 960, 320, torch.bfloat16, "x@w^T", "wgmma"),       # small M: never skinny
    (8, 960, 320, torch.float32, "x^T@w", "ffma"),
    (300, 40, 20, torch.float32, "x@w^T", "ffma"),
])
def test_path_choice_with_layouts(m, k, n, dtype, layout, path):
    assert kernel.choose_path(m, n, k, dtype, True, layout) == path


@pytest.mark.parametrize("m,k,n,aligned,layout", [
    (300, 40, 20, True, "x@w^T"),      # N % 8 != 0
    (300, 36, 128, True, "x@w^T"),     # w^T's rows are K = 36 long
    (300, 40, 128, True, "x^T@w"),     # x^T's rows are M = 300 long
    (4096, 960, 320, False, "x@w^T"),  # unaligned
])
def test_path_choice_refuses_a_transposed_operand_wgmma_cannot_take(m, k, n, aligned,
                                                                    layout):
    """mma and skinny take only the plain layout: a bf16 gradient product
    wgmma cannot address raises instead of falling back."""
    with pytest.raises(ValueError, match="wgmma"):
        kernel.choose_path(m, n, k, torch.bfloat16, aligned, layout)
    with pytest.raises(ValueError, match="at most one"):
        kernel.layout_of(True, True)


def test_gradient_of_a_non_cpu_tensor_goes_to_the_kernel():
    """The backward's products go to the kernel wrapper for a non-CPU
    tensor (which raises for a meta tensor), never to the plain version."""
    x = torch.empty((4, 8), device="meta", requires_grad=True)
    w = torch.empty((8, 4), device="meta", requires_grad=True)
    before = kernel.tile_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        matmul(x, w)
    assert kernel.tile_matmul.launches == before


@pytest.mark.parametrize("m,k,n,dtype,layout,path", [
    (688, 1408, 2048, torch.bfloat16, "x@w^T", "wgmma"),   # qwen2 dx of the gate / up
    (2048, 688, 1408, torch.bfloat16, "x^T@w", "wgmma"),   # their dw: K = 688 rows an expert
    (688, 2048, 1408, torch.bfloat16, "x@w^T", "wgmma"),   # dx of the down product
    (1408, 688, 2048, torch.bfloat16, "x^T@w", "wgmma"),   # its dw
    (2048, 688, 1408, torch.float32, "x^T@w", "ffma"),
    (1, 64, 128, torch.bfloat16, "x@w^T", "wgmma"),        # M 1: never skinny batched
])
def test_path_choice_of_the_batched_gradient_layouts(m, k, n, dtype, layout, path):
    """A batched launch in either transposed layout takes wgmma (bf16) or
    ffma (float32), as the plain batched product does; the counters hold a
    key for each batched layout."""
    assert kernel.choose_path(m, n, k, dtype, True, layout, batched=True) == path
    assert set(kernel.tile_matmul.layouts) == {
        "x@w", "x@w^T", "x^T@w", "batched", "batched x@w^T", "batched x^T@w"}
    assert kernel.BATCHED[layout] in kernel.tile_matmul.layouts


def test_the_output_counter_keys_each_operand_and_output_type():
    """``tile_matmul.outputs`` holds a key for each operand and output type
    the kernel takes; the float32 z of a bf16 product's fused activation
    counts under ``bfloat16->float32``."""
    assert set(kernel.tile_matmul.outputs) == {
        "float32->float32", "float32->bfloat16", "bfloat16->float32", "bfloat16->bfloat16"}
    assert kernel.OUTPUTS[torch.bfloat16, torch.float32] == "bfloat16->float32"
    assert set(kernel.OUTPUTS.values()) == set(kernel.tile_matmul.outputs)


def test_batched_path_choice_refuses_what_wgmma_cannot_address():
    """bf16 x^T stored with rows of M = 100 elements (not a multiple of 8)
    has no wgmma path, and batched there is no other: it raises."""
    with pytest.raises(ValueError, match="batched x\\^T@w"):
        kernel.choose_path(100, 128, 688, torch.bfloat16, True, "x^T@w", batched=True)


def test_batched_gradient_of_a_non_cpu_tensor_goes_to_the_kernel():
    """Under autograd off the CPU the batched product is ``_Batched``, whose
    forward is the kernel wrapper (which raises for a meta tensor), never
    the plain version; nothing is counted."""
    from repro_torch.kernels.tile_matmul.ops import batched_product
    x = torch.empty((2, 3, 8), device="meta", requires_grad=True)
    before = kernel.tile_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        batched_product(x, torch.empty((2, 8, 8), device="meta"))
    assert kernel.tile_matmul.launches == before
