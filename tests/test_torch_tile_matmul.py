"""The port's tile_matmul module against the JAX reference, on the CPU.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, through ``repro.kernels.tile_matmul.ops.matmul``, as
``tests/test_kernels.py`` runs it) and through the port's wrapper, which on
a CPU tensor runs the plain PyTorch version. Tolerances are the
reference's own: 2e-4 in float32, 2e-2 in bfloat16.
"""

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
