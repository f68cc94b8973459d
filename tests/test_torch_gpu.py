"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the reference package, so it collects on a host
with only PyTorch. Every test needs a CUDA device; the ``cuda`` fixture
decides that at run time and skips with a reason where there is none.
Run on the card with ``python -m pytest tests/test_torch_gpu.py -m gpu``.

Tolerances: 2e-2 in bfloat16 (the kernels round P and outputs to bf16 at
other places than the plain versions' float32 einsums), 2e-4 in float32
(both sum float32 products, in different orders). ssd_scan is held at the
reference's SSD bar, 1e-3, for its float32 outputs and float32 state: its
plain version is a different algorithm (per-timestep recurrence against
chunks), which changes the order of many more sums. Its backward is held
against the plain adjoint relative to each gradient's largest entry: 1e-3
in float32, 2e-2 in bfloat16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_plain, ssd_plain_bwd
from repro_torch.kernels.tile_matmul import kernel as tm_kernel
from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
ACTS = ["none", "tanh", "relu", "silu", "gelu"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dtype)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 960, 320), (3, 40, 20), (16, 2560, 960),
                                   (300, 960, 320), (17, 72, 136), (257, 40, 20),
                                   (8, 5120, 2560), (4096, 2560, 80)])
def test_tile_matmul_matches_plain(cuda, m, k, n, dtype):
    x = _randn((m, k), dtype, cuda, m + k)
    w = _randn((k, n), dtype, cuda, n, 0.05)
    b = _randn((n,), dtype, cuda, 7)
    for act in ACTS:
        for bias in (None, b):
            out = tm_kernel.tile_matmul(x, w, bias, activation=act)
            ref = tile_matmul_ref(x, w, bias, activation=act)
            torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])


def test_tile_matmul_bf16_in_float32_out(cuda):
    x = _randn((64, 96), torch.bfloat16, cuda, 1)
    w = _randn((96, 48), torch.bfloat16, cuda, 2)
    out = tm_kernel.tile_matmul(x, w, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.float() @ w.float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_matmul_is_deterministic_and_batch_invariant(cuda, dtype):
    x = _randn((300, 960), dtype, cuda, 3)
    w = _randn((960, 320), dtype, cuda, 4, 0.05)
    full = tm_kernel.tile_matmul(x, w)
    assert torch.equal(full, tm_kernel.tile_matmul(x, w))
    assert torch.equal(full[:64], tm_kernel.tile_matmul(x[:64].contiguous(), w))


WGMMA_CASES = [  # (m, k, n) of the TMA + wgmma path: bf16, K and N multiples of 8
    (17, 96, 80),       # N below one tile, K not a multiple of BK = 64, M tail 17
    (300, 72, 128),     # N one clipped tile, K = 72, M tail 300
    (4097, 2560, 80),   # M = 4096 + 1, mamba2's dt projection
    (300, 960, 320),    # smollm's k/v projection, N over two 128 tiles
    (129, 128, 2560),   # the 256-wide tiles, M one row past a tile
    (64, 2560, 5120),   # mamba2's z/x projection, fewer rows than a tile
]


@pytest.mark.parametrize("m,k,n", WGMMA_CASES)
def test_tile_matmul_wgmma_path_matches_plain(cuda, m, k, n):
    x = _randn((m, k), torch.bfloat16, cuda, m + k)
    w = _randn((k, n), torch.bfloat16, cuda, n, k ** -0.5)
    b = _randn((n,), torch.bfloat16, cuda, 7)
    before = tm_kernel.tile_matmul.paths["wgmma"]
    for act in ACTS:
        for bias in (None, b):
            out = tm_kernel.tile_matmul(x, w, bias, activation=act)
            ref = tile_matmul_ref(x, w, bias, activation=act)
            assert out.dtype == torch.bfloat16 and out.shape == (m, n)
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert tm_kernel.tile_matmul.paths["wgmma"] == before + 2 * len(ACTS)


@pytest.mark.parametrize("m,k,n", [(300, 96, 80), (4097, 2560, 128)])
def test_tile_matmul_wgmma_bf16_in_float32_out(cuda, m, k, n):
    x = _randn((m, k), torch.bfloat16, cuda, 1)
    w = _randn((k, n), torch.bfloat16, cuda, 2, k ** -0.5)
    b = _randn((n,), torch.bfloat16, cuda, 3)
    before = tm_kernel.tile_matmul.paths["wgmma"]
    out = tm_kernel.tile_matmul(x, w, b, activation="gelu", out_dtype=torch.float32)
    assert tm_kernel.tile_matmul.paths["wgmma"] == before + 1
    assert out.dtype == torch.float32
    ref = tile_matmul_ref(x, w, b, activation="gelu", out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)


def test_tile_matmul_wgmma_is_batch_invariant_at_prefill_size(cuda):
    """M = 4096 (a prefill of 8 x 512) against its first 300 rows, at
    mamba2's widest projection: bit-identical, and deterministic."""
    x = _randn((4096, 2560), torch.bfloat16, cuda, 3)
    w = _randn((2560, 5120), torch.bfloat16, cuda, 4, 0.02)
    before = tm_kernel.tile_matmul.paths["wgmma"]
    full = tm_kernel.tile_matmul(x, w)
    assert torch.equal(full, tm_kernel.tile_matmul(x, w))
    assert torch.equal(full[:300], tm_kernel.tile_matmul(x[:300].contiguous(), w))
    assert tm_kernel.tile_matmul.paths["wgmma"] == before + 3


@pytest.mark.parametrize("m,k,n,dtype,path", [
    (4096, 960, 320, torch.bfloat16, "wgmma"), (257, 40, 20, torch.bfloat16, "mma"),
    (8, 2560, 80, torch.bfloat16, "skinny"), (8, 960, 320, torch.float32, "skinny"),
    (300, 960, 320, torch.float32, "ffma")])
def test_tile_matmul_counts_launches_per_path(cuda, m, k, n, dtype, path):
    x = _randn((m, k), dtype, cuda, 1)
    w = _randn((k, n), dtype, cuda, 2, 0.05)
    before, total = dict(tm_kernel.tile_matmul.paths), tm_kernel.tile_matmul.launches
    tm_kernel.tile_matmul(x, w)
    after = tm_kernel.tile_matmul.paths
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in tm_kernel.PATH_CODES}
    assert tm_kernel.tile_matmul.launches == total + 1


def test_tile_matmul_c_entry_refuses_a_path_the_shape_cannot_take(cuda):
    """The C side checks the wrapper's choice and never switches paths."""
    x = _randn((257, 40), torch.bfloat16, cuda, 1)
    w = _randn((40, 20), torch.bfloat16, cuda, 2)
    out = torch.empty((257, 20), dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    codes = tm_kernel.PATH_CODES
    for path in ("wgmma", "skinny", "ffma"):
        err = tm_kernel._lib()(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 257, 20, 40,
                               1, 1, 0, codes[path], 0, stream)
        assert err == 1, path  # cudaErrorInvalidValue


def test_tile_matmul_counts_launches_and_rejects_bad_input(cuda):
    x = _randn((8, 16), torch.float32, cuda, 5)
    before = tm_kernel.tile_matmul.launches
    tm_kernel.tile_matmul(x, _randn((16, 8), torch.float32, cuda, 6))
    assert tm_kernel.tile_matmul.launches == before + 1
    with pytest.raises(ValueError):
        tm_kernel.tile_matmul(x, _randn((16, 8), torch.bfloat16, cuda, 6))
    with pytest.raises(ValueError):
        tm_kernel.tile_matmul(x.t(), _randn((8, 8), torch.float32, cuda, 6))
    assert tm_kernel.tile_matmul.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,d,window,softcap,causal", [
    (10, 3, 512, 512, 64, 0, 0.0, True),     # smollm prefill, 2 sequences
    (4, 3, 77, 133, 64, 0, 0.0, True),       # ragged, q_offset = 56
    (4, 3, 200, 200, 64, 48, 0.0, True),     # sliding window
    (4, 2, 96, 96, 128, 0, 30.0, True),      # softcap, D = 128
    (2, 1, 65, 65, 32, 0, 0.0, False),       # not causal
    (3, 4, 40, 40, 16, 16, 20.0, True),      # window + softcap, D = 16
])
def test_flash_attention_matches_plain(cuda, bh, g, tq, tk, d, window, softcap,
                                       causal, dtype):
    q = _randn((bh, g, tq, d), dtype, cuda, 1)
    k = _randn((bh, tk, d), dtype, cuda, 2)
    v = _randn((bh, tk, d), dtype, cuda, 3)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    out = fa_kernel.flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


FLASH_MMA_CASES = [  # (bh, g, tq, tk, d, window, softcap): bf16 through mma
    (6, 1, 130, 130, 64, 0, 0.0),      # G = 1, ragged Tq = Tkv
    (4, 3, 77, 133, 64, 0, 0.0),       # G = 3, q_offset = 56, both ragged
    (2, 8, 50, 70, 128, 0, 0.0),       # G = 8, D = 128, q_offset = 20
    (4, 3, 300, 300, 64, 100, 0.0),    # window crossing tile edges
    (3, 8, 90, 190, 128, 0, 30.0),     # softcap, q_offset = 100
    (2, 3, 200, 264, 64, 70, 25.0),    # window + softcap + q_offset
]


@pytest.mark.parametrize("bh,g,tq,tk,d,window,softcap", FLASH_MMA_CASES)
def test_flash_attention_mma_path_matches_plain(cuda, bh, g, tq, tk, d, window, softcap):
    q = _randn((bh, g, tq, d), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, d), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, d), torch.bfloat16, cuda, 3)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=tk - tq)
    before = dict(fa_kernel.flash_attention.paths)
    out = fa_kernel.flash_attention(q, k, v, **kw)
    assert fa_kernel.flash_attention.paths["mma"] == before["mma"] + 1
    assert fa_kernel.flash_attention.paths["ffma"] == before["ffma"]
    ref = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"), (torch.float32, "ffma")])
def test_flash_attention_is_deterministic_and_counts_its_path(cuda, dtype, path):
    q = _randn((4, 3, 200, 64), dtype, cuda, 1)
    k = _randn((4, 200, 64), dtype, cuda, 2)
    v = _randn((4, 200, 64), dtype, cuda, 3)
    paths, total = dict(fa_kernel.flash_attention.paths), fa_kernel.flash_attention.launches
    first = fa_kernel.flash_attention(q, k, v, window=90)
    assert torch.equal(first, fa_kernel.flash_attention(q, k, v, window=90))
    after = fa_kernel.flash_attention.paths
    assert {p: after[p] - paths[p] for p in after} == {
        p: 2 * int(p == path) for p in fa_kernel.PATH_CODES}
    assert fa_kernel.flash_attention.launches == total + 2


def test_flash_attention_bf16_ffma_path_matches_mma(cuda):
    """The first (FFMA) kernel still takes bf16 when asked, as chip_smoke.py
    times it; both agree with the plain version."""
    q = _randn((4, 3, 128, 64), torch.bfloat16, cuda, 4)
    k = _randn((4, 128, 64), torch.bfloat16, cuda, 5)
    v = _randn((4, 128, 64), torch.bfloat16, cuda, 6)
    ref = flash_attention_ref(q, k, v)
    for path in ("mma", "ffma"):
        out = fa_kernel.flash_attention(q, k, v, path=path)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_c_entry_refuses_a_path_the_inputs_cannot_take(cuda):
    q = _randn((1, 1, 16, 64), torch.float32, cuda, 1)
    k = _randn((1, 16, 64), torch.float32, cuda, 2)
    out = torch.empty_like(q)
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    lib, codes = fa_kernel._lib(), fa_kernel.PATH_CODES
    # float32 through mma; bf16 through mma from an unaligned pointer; D = 48
    assert lib(q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(), None, 1, 1, 16, 16,
               64, 0, 1, 0, 0.0, 0, 0.125, codes["mma"], stream) == 1
    qb = _randn((1, 1, 17, 64), torch.bfloat16, cuda, 1)
    kb = _randn((1, 16, 64), torch.bfloat16, cuda, 2)
    assert lib(qb.data_ptr() + 2, kb.data_ptr(), kb.data_ptr(), qb.data_ptr() + 2, None, 1,
               1, 16, 16, 64, 1, 1, 0, 0.0, 0, 0.125, codes["mma"], stream) == 1
    for path in ("mma", "ffma"):
        assert lib(qb.data_ptr(), kb.data_ptr(), kb.data_ptr(), qb.data_ptr(), None, 1, 1,
                   16, 16, 48, 1, 1, 0, 0.0, 0, 0.125, codes[path], stream) == 1


def test_gqa_attention_on_cuda_matches_cpu_chunked_twin(cuda):
    from repro_torch.models.attention import AttnCfg, gqa_attention
    cfg = AttnCfg(n_heads=15, n_kv_heads=5, head_dim=64, window=0)
    q = _randn((2, 100, 15, 64), torch.float32, "cpu", 1)
    k = _randn((2, 100, 5, 64), torch.float32, "cpu", 2)
    v = _randn((2, 100, 5, 64), torch.float32, "cpu", 3)
    before = fa_kernel.flash_attention.launches
    out = gqa_attention(q.to(cuda), k.to(cuda), v.to(cuda), cfg)
    assert fa_kernel.flash_attention.launches == before + 1
    ref = gqa_attention(q, k, v, cfg, q_chunk=32, kv_chunk=32)
    torch.testing.assert_close(out.cpu(), ref, rtol=2e-4, atol=2e-4)


def test_reduced_serve_on_cuda_matches_cpu(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = get_config("smollm_360m", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    quiet = dict(seed=0, log=lambda _: None)
    on_cpu = serve("smollm_360m", device="cpu", params=params, **quiet)
    on_gpu = serve("smollm_360m", device=cuda, params=_to(params, cuda), **quiet)
    np.testing.assert_array_equal(on_gpu["tokens"], on_cpu["tokens"])


def _ssd_inputs(bt, t, h, p, g, n, dtype, device, seed):
    """x, B, C in ``dtype``; dt (post-softplus), A (< 0) and D in float32."""
    x = _randn((bt, t, h, p), dtype, device, seed, 0.5)
    dt = torch.nn.functional.softplus(_randn((bt, t, h), torch.float32, device, seed + 1))
    A = -torch.exp(_randn((h,), torch.float32, device, seed + 2, 0.3))
    B = _randn((bt, t, g, n), dtype, device, seed + 3, 0.5)
    C = _randn((bt, t, g, n), dtype, device, seed + 4, 0.5)
    D = 1.0 + _randn((h,), torch.float32, device, seed + 5, 0.1)
    return x, dt, A, B, C, D


SSD_CASES = [  # (bt, t, h, p, g, n)
    (2, 512, 8, 64, 1, 128),     # the serving head shape, fewer heads
    (1, 200, 4, 64, 1, 128),     # ragged last chunk
    (2, 77, 6, 32, 3, 64),       # ragged, G = 3
    (1, 64, 4, 16, 4, 16),       # reduced widths, G = H
    (1, 1, 2, 8, 1, 8),          # a single step
    (1, 130, 2, 128, 2, 128),    # P = 128
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,t,h,p,g,n", SSD_CASES)
def test_ssd_scan_matches_plain(cuda, bt, t, h, p, g, n, dtype):
    args = _ssd_inputs(bt, t, h, p, g, n, dtype, cuda, seed=t + h + g)
    before = ssd_kernel.ssd_scan.launches
    y, s = ssd_kernel.ssd_scan(*args)
    assert ssd_kernel.ssd_scan.launches == before + 1
    yr, sr = ssd_plain(*args)
    assert y.dtype == dtype and y.shape == (bt, t, h, p)
    assert s.dtype == torch.float32 and s.shape == (bt, h, n, p)
    ytol = 1e-3 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), rtol=ytol, atol=ytol)
    torch.testing.assert_close(s, sr, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_is_deterministic(cuda, dtype):
    args = _ssd_inputs(2, 300, 8, 64, 2, 128, dtype, cuda, seed=9)
    y1, s1 = ssd_kernel.ssd_scan(*args)
    y2, s2 = ssd_kernel.ssd_scan(*args)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


SSD_MMA_CASES = [  # (bt, t, h, p, g, n): bf16 through mma
    (2, 333, 8, 64, 2, 128),     # ragged T, G = 2
    (1, 77, 6, 64, 3, 128),      # ragged, G = 3, under two chunks
    (1, 64, 4, 96, 4, 64),       # one chunk, G = H, N 64, three slices of P
]


@pytest.mark.parametrize("bt,t,h,p,g,n", SSD_MMA_CASES)
def test_ssd_scan_mma_path_matches_plain(cuda, bt, t, h, p, g, n):
    args = _ssd_inputs(bt, t, h, p, g, n, torch.bfloat16, cuda, seed=t + g)
    before = dict(ssd_kernel.ssd_scan.paths)
    y, s = ssd_kernel.ssd_scan(*args)
    assert ssd_kernel.ssd_scan.paths["mma"] == before["mma"] + 1
    assert ssd_kernel.ssd_scan.paths["ffma"] == before["ffma"]
    yr, sr = ssd_plain(*args)
    torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(s, sr, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"), (torch.float32, "ffma")])
def test_ssd_scan_counts_launches_per_path(cuda, dtype, path):
    args = _ssd_inputs(1, 100, 4, 64, 1, 128, dtype, cuda, seed=2)
    before, total = dict(ssd_kernel.ssd_scan.paths), ssd_kernel.ssd_scan.launches
    ssd_kernel.ssd_scan(*args)
    after = ssd_kernel.ssd_scan.paths
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in ssd_kernel.PATH_CODES}
    assert ssd_kernel.ssd_scan.launches == total + 1


def test_ssd_scan_bf16_ffma_path_matches_plain(cuda):
    """The first (FFMA) kernel still takes bf16 when asked, as chip_smoke.py
    times it."""
    args = _ssd_inputs(1, 150, 4, 64, 2, 128, torch.bfloat16, cuda, seed=3)
    yr, sr = ssd_plain(*args)
    for path in ("mma", "ffma"):
        y, s = ssd_kernel.ssd_scan(*args, path=path)
        torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(s, sr, rtol=1e-3, atol=1e-3)


def test_ssd_scan_c_entry_refuses_a_path_the_inputs_cannot_take(cuda):
    x, dt, A, B, C, D = _ssd_inputs(1, 16, 4, 16, 2, 16, torch.bfloat16, cuda, seed=1)
    y = torch.empty_like(x)
    state = torch.empty((1, 4, 16, 16), dtype=torch.float32, device=cuda)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    ptrs = [t.data_ptr() for t in (x, dt, A, B, C, D, y, state)] + [None]  # no chunk states
    lib, codes = ssd_kernel._lib(), ssd_kernel.PATH_CODES
    # N = 16 and P = 16 are not mma shapes; float32 is not an mma type
    assert lib(*ptrs, 1, 16, 4, 2, 16, 16, 1, codes["mma"], stream) == 1
    assert lib(*ptrs, 1, 16, 4, 2, 16, 16, 0, codes["mma"], stream) == 1
    # ffma's shared memory: N = 512, P = 128 would take 560 KB
    assert lib(*ptrs, 1, 16, 4, 2, 512, 128, 1, codes["ffma"], stream) == 1


def test_ssd_scan_rejects_bad_input(cuda):
    x, dt, A, B, C, D = _ssd_inputs(1, 16, 4, 8, 2, 8, torch.float32, cuda, seed=1)
    before = ssd_kernel.ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(x, dt, A, B.bfloat16(), C, D)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(x, dt.bfloat16(), A, B, C, D)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(x, dt, A, B[:, :, :1].expand(1, 16, 3, 8), C, D)
    assert ssd_kernel.ssd_scan.launches == before


def test_mamba_train_on_cuda_matches_cpu_chunked_twin(cuda):
    """The kernel path's cache state comes back in the cache layout
    (B, H, P, N), P != N here."""
    from repro_torch.models import blocks as TB
    from repro_torch.models.mamba2 import MambaCfg
    from repro_torch.models.common import tree_initialize
    m = MambaCfg(d_inner=256, d_state=64, d_conv=4, head_dim=32, n_groups=2, chunk=32)
    lcfg = TB.LayerCfg(mixer="mamba", mamba=m)
    p = tree_initialize(TB.block_specs(96, lcfg, torch.float32),
                        torch.Generator().manual_seed(0), "cpu")["mamba"]
    x = _randn((2, 100, 96), torch.float32, "cpu", 1)
    before = ssd_kernel.ssd_scan.launches
    out, cache = TB.mamba_train(_to(p, cuda), x.to(cuda), lcfg, want_cache=True)
    assert ssd_kernel.ssd_scan.launches == before + 1
    ref, ref_cache = TB.mamba_train(p, x, lcfg, want_cache=True)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-3, atol=1e-3)
    assert cache["state"].shape == ref_cache["state"].shape == (2, 8, 32, 64)
    for name in ref_cache:
        torch.testing.assert_close(cache[name].cpu(), ref_cache[name], rtol=1e-3, atol=1e-3)


def test_reduced_mamba_serve_on_cuda_matches_cpu(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = get_config("mamba2_2_7b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    quiet = dict(arch="mamba2_2_7b", seed=0, prompt_len=40, log=lambda _: None)
    on_cpu = serve(device="cpu", params=params, **quiet)
    on_gpu = serve(device=cuda, params=_to(params, cuda), **quiet)
    np.testing.assert_array_equal(on_gpu["tokens"], on_cpu["tokens"])


# ---------------------------------------------------------------------------
# Training: the gradient layouts of tile_matmul, flash_attention's lse and
# backward kernel, and a reduced train step on the card against the CPU.
# ---------------------------------------------------------------------------

GRAD_SHAPES = [  # (tokens M, in K, out N) of a projection x (M, K) @ w (K, N)
    (4096, 960, 320),    # smollm's k/v projection at 8 x 512 tokens
    (300, 960, 2560),    # gate/up; dw reduces over 300 tokens, a ragged box
    (296, 72, 136),      # K and N below and across one 64-wide box
    (64, 2560, 80),      # fewer tokens than a tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GRAD_SHAPES)
def test_tile_matmul_gradient_layouts_match_plain(cuda, m, k, n, dtype):
    """dx = dz @ w^T (``trans_w``) and dw = x^T @ dz (``trans_x``), each
    operand read where it lies; bf16 through wgmma, float32 through ffma,
    each launch counted under its layout; dw repeats bit for bit."""
    fn = tm_kernel.tile_matmul
    path = "wgmma" if dtype == torch.bfloat16 else "ffma"
    x = _randn((m, k), dtype, cuda, m + k)
    w = _randn((k, n), dtype, cuda, n, k ** -0.5)
    dz = _randn((m, n), dtype, cuda, 3, m ** -0.5)
    for a, b, kw, layout in ((dz, w, dict(trans_w=True), "x@w^T"),
                             (x, dz, dict(trans_x=True), "x^T@w")):
        paths, layouts = dict(fn.paths), dict(fn.layouts)
        out = fn(a, b, **kw)
        assert fn.paths[path] == paths[path] + 1
        assert fn.layouts[layout] == layouts[layout] + 1
        ref = tile_matmul_ref(a, b, **kw)
        assert out.shape == ref.shape and out.dtype == dtype
        torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.equal(out, fn(a, b, **kw))


def test_tile_matmul_c_entry_refuses_a_layout_the_path_cannot_take(cuda):
    """Transposed operands only through wgmma and ffma; the C side refuses
    them on mma and skinny, and an unknown layout anywhere."""
    x = _randn((8, 64), torch.bfloat16, cuda, 1)
    w = _randn((64, 64), torch.bfloat16, cuda, 2)
    out = torch.empty((8, 64), dtype=torch.bfloat16, device=cuda)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    codes, layouts = tm_kernel.PATH_CODES, tm_kernel.LAYOUT_CODES
    for path in ("mma", "skinny"):
        for layout in ("x@w^T", "x^T@w"):
            assert tm_kernel._lib()(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 8, 64,
                                    64, 1, 1, 0, codes[path], layouts[layout], stream) == 1
    assert tm_kernel._lib()(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 8, 64, 64, 1,
                            1, 0, codes["wgmma"], 3, stream) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_backward_on_card_matches_cpu(cuda, dtype):
    """ops.matmul under autograd: on the card every product of the backward
    is a launch (the activation's z, dx, dw), on the CPU the plain version."""
    from repro_torch.kernels.tile_matmul.ops import matmul
    x0 = _randn((2, 150, 96), dtype, "cpu", 1)
    w0 = _randn((96, 80), dtype, "cpu", 2, 0.1)
    b0 = _randn((80,), dtype, "cpu", 3)
    g = _randn((2, 150, 80), torch.float32, "cpu", 4)
    for act in ACTS:
        grads = {}
        for dev in ("cpu", cuda):
            args = [t.to(dev).requires_grad_() for t in (x0, w0, b0)]
            before = tm_kernel.tile_matmul.launches
            y = matmul(*args, activation=act, out_dtype=torch.float32)
            grads[str(dev)] = torch.autograd.grad(y, args, g.to(dev))
            if dev != "cpu":
                assert tm_kernel.tile_matmul.launches == before + 3 + (act != "none")
        for a, b in zip(grads["cpu"], grads[str(cuda)]):
            scale = a.float().abs().max().item() if dtype == torch.bfloat16 else 1.0
            torch.testing.assert_close(b.cpu().float(), a.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,d,window,softcap", FLASH_MMA_CASES)
def test_flash_attention_backward_matches_plain(cuda, bh, g, tq, tk, d, window, softcap,
                                                dtype):
    """The forward's lse against the plain version's, then dq, dk, dv of the
    backward kernels against the explicit formula, from the kernel's own o
    and lse; repeat launches give the same bits."""
    q = _randn((bh, g, tq, d), dtype, cuda, 1)
    k = _randn((bh, tk, d), dtype, cuda, 2)
    v = _randn((bh, tk, d), dtype, cuda, 3)
    do = _randn((bh, g, tq, d), dtype, cuda, 4)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL[dtype], atol=TOL[dtype])
    before = fa_kernel.flash_attention_bwd.launches
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert fa_kernel.flash_attention_bwd.launches == before + 1
    for got, want in zip(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


FLASH_BWD_EDGE_CASES = [  # (bh, g, tq, tk, causal, window, softcap): bf16, D = 64 (wgmma)
    (2, 1, 65, 65, False, 0, 0.0),     # not causal, one row past a tile
    (3, 2, 1, 1, True, 0, 0.0),        # a single step
    (2, 3, 130, 200, True, 10, 0.0),   # a window narrower than a tile, q_offset = 70
    (2, 3, 64, 640, True, 0, 0.0),     # q_offset = 576: one row tile sees all key tiles
    (1, 5, 100, 100, True, 0, 15.0),   # G = 5 folds rows across tile edges, softcap
]


@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap", FLASH_BWD_EDGE_CASES)
def test_flash_attention_backward_wgmma_edges(cuda, bh, g, tq, tk, causal, window, softcap):
    """Shapes the D = 64 kernels' tiling makes special (partial tiles, the
    band split over the dK/dV warpgroups, tiles left unmasked) against the
    explicit formula at the bf16 bar; repeat launches give the same bits."""
    q = _randn((bh, g, tq, 64), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, 64), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, 64), torch.bfloat16, cuda, 3)
    do = _randn((bh, g, tq, 64), torch.bfloat16, cuda, 4)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert fa_kernel.flash_attention_bwd.paths["mma"] == before["mma"] + 1
    for got, want in zip(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"), (torch.float32, "ffma")])
def test_flash_attention_backward_counts_its_path(cuda, dtype, path):
    q = _randn((4, 3, 200, 64), dtype, cuda, 1)
    k = _randn((4, 200, 64), dtype, cuda, 2)
    do = _randn((4, 3, 200, 64), dtype, cuda, 3)
    o, lse = fa_kernel.flash_attention(q, k, k, return_lse=True)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    fa_kernel.flash_attention_bwd(q, k, k, o, do, lse)
    after = fa_kernel.flash_attention_bwd.paths
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in fa_kernel.PATH_CODES}


def test_flash_attention_backward_bf16_ffma_path_matches_mma(cuda):
    """The first (FFMA) backward still takes bf16 when asked, as
    chip_smoke.py times it; both agree with the plain formula."""
    q = _randn((4, 3, 130, 64), torch.bfloat16, cuda, 4)
    k = _randn((4, 150, 64), torch.bfloat16, cuda, 5)
    v = _randn((4, 150, 64), torch.bfloat16, cuda, 6)
    do = _randn((4, 3, 130, 64), torch.bfloat16, cuda, 7)
    kw = dict(window=60, q_offset=20)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    refs = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for path in ("mma", "ffma"):
        for got, want in zip(fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, path=path,
                                                           **kw), refs):
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_backward_c_entry_refuses_a_path_the_inputs_cannot_take(cuda):
    q = _randn((1, 1, 16, 64), torch.float32, cuda, 1)
    k = _randn((1, 16, 64), torch.float32, cuda, 2)
    o, lse = fa_kernel.flash_attention(q, k, k, return_lse=True)
    g = [torch.empty_like(t) for t in (q, k, k)]
    dvec = torch.empty_like(lse)
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    # float32 through mma; D = 48 through either
    args = [q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(), o.data_ptr(),
            lse.data_ptr()] + [t.data_ptr() for t in g] + [dvec.data_ptr()]
    lib = fa_kernel._lib_bwd()
    assert lib(*args, 1, 1, 16, 16, 64, 0, 1, 0, 0.0, 0, 0.125, 0, stream) == 1
    for path in (0, 1):
        assert lib(*args, 1, 1, 16, 16, 48, 0, 1, 0, 0.0, 0, 0.125, path, stream) == 1


def test_flash_attention_backward_not_causal(cuda):
    q = _randn((2, 1, 65, 32), torch.float32, cuda, 1)
    k = _randn((2, 65, 32), torch.float32, cuda, 2)
    v = _randn((2, 65, 32), torch.float32, cuda, 3)
    do = _randn((2, 1, 65, 32), torch.float32, cuda, 4)
    o, lse = fa_kernel.flash_attention(q, k, v, causal=False, return_lse=True)
    for got, want in zip(fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, causal=False),
                         flash_attention_bwd_ref(q, k, v, o, do, lse, causal=False)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_flash_attention_backward_rejects_bad_input(cuda):
    q = _randn((1, 1, 16, 64), torch.float32, cuda, 1)
    k = _randn((1, 16, 64), torch.float32, cuda, 2)
    o, lse = fa_kernel.flash_attention(q, k, k, return_lse=True)
    before = fa_kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bwd(q, k, k, o, o, lse[..., :8])
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bwd(q, k, k, o, o.bfloat16(), lse)
    assert fa_kernel.flash_attention_bwd.launches == before


def test_attention_backward_on_card_matches_cpu(cuda):
    """ops.attention under autograd, float32: forward and backward kernels on
    the card against the plain forward and formula on the CPU."""
    from repro_torch.kernels.flash_attention.ops import attention
    q0 = _randn((2, 90, 15, 64), torch.float32, "cpu", 1)
    k0 = _randn((2, 90, 5, 64), torch.float32, "cpu", 2)
    v0 = _randn((2, 90, 5, 64), torch.float32, "cpu", 3)
    g = _randn((2, 90, 15, 64), torch.float32, "cpu", 4)
    grads = {}
    for dev in ("cpu", cuda):
        args = [t.to(dev).requires_grad_() for t in (q0, k0, v0)]
        before = fa_kernel.flash_attention_bwd.launches
        out = attention(*args, window=40)
        grads[str(dev)] = torch.autograd.grad(out, args, g.to(dev))
        if dev != "cpu":
            assert fa_kernel.flash_attention_bwd.launches == before + 1
    for a, b in zip(grads["cpu"], grads[str(cuda)]):
        torch.testing.assert_close(b.cpu(), a, rtol=2e-4, atol=2e-4)


def test_reduced_train_step_on_card_matches_cpu(cuda):
    """One float32 train step of reduced smollm_360m (ffma products, ffma
    attention and its backward) against the plain path on the CPU: loss,
    grad norm and every updated weight. 1e-4 as the model-level bar; the
    weights, moved by about the learning rate, within 1e-2 of it."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptConfig, init_opt_state, tree_leaves
    cfg = get_config("smollm_360m", reduced=True)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=6, weight_decay=0.1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=4, seq=64,
                                         mode="cyclic")).batch_at(0)
    step = make_train_step(cfg, opt)
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        before = (tm_kernel.tile_matmul.launches, fa_kernel.flash_attention_bwd.launches)
        out[str(dev)] = step(p, init_opt_state(p, opt),
                             {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        if dev != "cpu":
            n = cfg.n_layers
            assert tm_kernel.tile_matmul.launches == before[0] + 7 * n * 4 + n
            assert fa_kernel.flash_attention_bwd.launches == before[1] + n
    (pc, _, mc), (pg, _, mg) = out["cpu"], out[str(cuda)]
    for key in ("loss", "grad_norm"):
        assert abs(mg[key] - mc[key]) <= 1e-4 * max(1.0, abs(mc[key])), (key, mg, mc)
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-2 * mc["lr"])


def test_train_runs_on_the_card_by_default(cuda, tmp_path):
    from repro_torch.launch.train import train
    before = fa_kernel.flash_attention_bwd.launches
    res = train("smollm_360m", steps=2, batch=2, seq=32, ckpt_dir=str(tmp_path),
                ckpt_every=0, log=lambda _: None)
    assert res["params"]["embed"]["tok"].is_cuda
    assert fa_kernel.flash_attention_bwd.launches == before + 2 * 2
    assert all(np.isfinite(res["losses"]))


# --- the scan's gradient -----------------------------------------------------

def _ssd_bwd_inputs(bt, t, h, p, g, n, dtype, device, seed):
    """The scan's inputs, dy in ``dtype`` and a float32 final-state gradient."""
    return (_ssd_inputs(bt, t, h, p, g, n, dtype, device, seed),
            _randn((bt, t, h, p), dtype, device, seed + 6, 0.5),
            _randn((bt, h, n, p), torch.float32, device, seed + 7, 0.5))


def _states(args):
    """The chunk states, written by a forward launch, that the backward reads."""
    states = torch.empty(ssd_kernel.chunk_states_shape(args[0], args[3]),
                         device=args[0].device)
    ssd_kernel.ssd_scan(*args, chunk_states=states)
    return states


def _assert_grads_close(got, want, rtol, names=("dx", "ddt", "dA", "dB", "dC", "dD")):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, a.dtype)
        # floored for a gradient that is exactly zero: dA at T = 1 (no
        # earlier state to decay), where the kernel's cancelling sums leave
        # float32 rounding of order 1e-8
        scale = max(b.float().abs().max().item(), 1e-4)
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=rtol * scale,
                                   msg=lambda m, c=name: f"{c}: {m}")


SSD_BWD_CASES = [  # (bt, t, h, p, g, n)
    (2, 200, 8, 64, 2, 128),     # ragged last chunk, G = 2
    (1, 77, 6, 32, 3, 64),       # under two chunks, G = 3, N 64, P 32
    (2, 512, 8, 64, 1, 128),     # the training head shape, fewer heads
    (1, 64, 4, 16, 4, 16),       # reduced widths, G = H (ffma in bf16 too)
    (1, 1, 2, 8, 1, 8),          # a single step
    (1, 150, 12, 64, 4, 64),     # G = 4: three heads a group, N 64, ragged
    (2, 130, 4, 32, 1, 128),     # N 128 with P 32, ragged
]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,t,h,p,g,n", SSD_BWD_CASES)
def test_ssd_scan_bwd_matches_plain(cuda, bt, t, h, p, g, n, dtype, with_dstate):
    args, dy, ds = _ssd_bwd_inputs(bt, t, h, p, g, n, dtype, cuda, seed=t + h + g)
    ds = ds if with_dstate else None
    states = _states(args)
    before = ssd_kernel.ssd_scan_bwd.launches
    got = ssd_kernel.ssd_scan_bwd(*args, dy, ds, states)
    assert ssd_kernel.ssd_scan_bwd.launches == before + 1
    _assert_grads_close(got, ssd_plain_bwd(*args, dy, ds),
                        1e-3 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("with_dstate", [False, True])
def test_ssd_scan_bwd_mma_single_step(cuda, with_dstate):
    """T = 1 through the mma kernel. Every gradient but dA at the bf16 bar.
    dA is exactly zero here: its one step's cum_bar is c . C_bar - dt (b .
    Bt) + <G, S>, terms of the size of dt_bar that cancel. The kernel forms
    them from hi + lo bf16 pairs (2^-16 of each operand left over) and the
    forward's chunk state, so dA is held to 2^-12 of dt_bar's largest entry
    instead of a floor of 1e-4."""
    args, dy, ds = _ssd_bwd_inputs(2, 1, 4, 32, 1, 64, torch.bfloat16, cuda, seed=5)
    ds = ds if with_dstate else None
    before = dict(ssd_kernel.ssd_scan_bwd.paths)
    got = ssd_kernel.ssd_scan_bwd(*args, dy, ds, _states(args))
    assert ssd_kernel.ssd_scan_bwd.paths["mma"] == before["mma"] + 1
    want = ssd_plain_bwd(*args, dy, ds)
    assert not want[2].any()
    keep = [i for i in range(6) if i != 2]
    _assert_grads_close([got[i] for i in keep], [want[i] for i in keep], 2e-2,
                        names=[("dx", "ddt", "dA", "dB", "dC", "dD")[i] for i in keep])
    assert got[2].abs().max() <= 2.0 ** -12 * want[1].abs().max(), (got[2], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_is_deterministic(cuda, dtype):
    """No atomics: two launches give the same bits, B's and C's gradients
    summed over 8 heads of a group included."""
    args, dy, ds = _ssd_bwd_inputs(2, 300, 16, 64, 2, 128, dtype, cuda, seed=9)
    states = _states(args)
    first = ssd_kernel.ssd_scan_bwd(*args, dy, ds, states)
    again = ssd_kernel.ssd_scan_bwd(*args, dy, ds, states)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"), (torch.float32, "ffma")])
def test_ssd_scan_bwd_counts_launches_per_path(cuda, dtype, path):
    args, dy, ds = _ssd_bwd_inputs(1, 100, 4, 64, 1, 128, dtype, cuda, seed=2)
    states = _states(args)
    fn = ssd_kernel.ssd_scan_bwd
    before, total = dict(fn.paths), fn.launches
    fn(*args, dy, ds, states)
    assert {p: fn.paths[p] - before[p] for p in fn.paths} == {
        p: int(p == path) for p in ssd_kernel.PATH_CODES}
    assert fn.launches == total + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_writes_the_chunk_states_the_backward_reads(cuda, dtype):
    """The forward's chunk states: zero first, the final state last, the
    state after two chunks as the plain scan's; the backward reading them
    is within the bar, by both paths in bf16."""
    args, dy, ds = _ssd_bwd_inputs(1, 150, 4, 64, 2, 128, dtype, cuda, seed=3)
    states = torch.empty(ssd_kernel.chunk_states_shape(args[0], args[3]), device=cuda)
    assert states.shape == (1, 4, 4, 128, 64)
    _, final = ssd_kernel.ssd_scan(*args, chunk_states=states)
    assert not states[:, :, 0].any() and torch.equal(states[:, :, -1], final)
    _, after_two_chunks = ssd_plain(*[a[:, :128] if a.dim() > 1 else a for a in args])
    torch.testing.assert_close(states[:, :, 2], after_two_chunks, rtol=1e-3, atol=1e-3)
    want = ssd_plain_bwd(*args, dy, ds)
    for path in ("mma", "ffma") if dtype == torch.bfloat16 else ("ffma",):
        got = ssd_kernel.ssd_scan_bwd(*args, dy, ds, states, path=path)
        _assert_grads_close(got, want, 2e-2 if dtype == torch.bfloat16 else 1e-3)


def test_ssd_scan_bwd_c_entry_refuses_a_path_the_inputs_cannot_take(cuda):
    (x, dt, A, B, C, D), dy, ds = _ssd_bwd_inputs(1, 16, 4, 16, 2, 16, torch.bfloat16,
                                                  cuda, seed=1)
    f32 = dict(dtype=torch.float32, device=cuda)
    outs = (torch.empty_like(x), torch.empty_like(dt), torch.empty((1, 4), **f32),
            torch.empty((1, 4), **f32), torch.empty((1, 16, 4, 16), **f32),
            torch.empty((1, 16, 4, 16), **f32), torch.empty((1, 4, 2, 16, 16), **f32),
            torch.empty_like(B), torch.empty_like(C))
    ptrs = [t.data_ptr() for t in (x, dt, A, B, C, D, dy, ds)] + [t.data_ptr() for t in outs]
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    lib, codes = ssd_kernel._lib_bwd(), ssd_kernel.PATH_CODES
    # N = 16 and P = 16 are not mma shapes; float32 is not an mma type
    assert lib(*ptrs, 1, 16, 4, 2, 16, 16, 1, codes["mma"], stream) == 1
    assert lib(*ptrs, 1, 16, 4, 2, 16, 16, 0, codes["mma"], stream) == 1
    # shared memory: N = 128 with P = 128 fits neither path
    assert lib(*ptrs, 1, 16, 4, 2, 128, 128, 1, codes["mma"], stream) == 1
    assert lib(*ptrs, 1, 16, 4, 2, 128, 128, 1, codes["ffma"], stream) == 1
    # the chunk states are read, never made here: a null pointer is refused
    no_states = ptrs[:14] + [None] + ptrs[15:]
    assert lib(*no_states, 1, 16, 4, 2, 16, 16, 1, codes["ffma"], stream) == 1


def test_ssd_scan_bwd_rejects_bad_input(cuda):
    args, dy, ds = _ssd_bwd_inputs(1, 16, 4, 8, 2, 8, torch.float32, cuda, seed=1)
    states = _states(args)
    fn = ssd_kernel.ssd_scan_bwd
    before = fn.launches
    with pytest.raises(ValueError):
        fn(*args, dy.bfloat16(), ds, states)
    with pytest.raises(ValueError):
        fn(*args, dy, ds[..., :4], states)
    with pytest.raises(ValueError):
        fn(*args, dy.cpu(), ds, states)
    with pytest.raises(ValueError):
        fn(*args, dy, ds, torch.empty((1, 4, 1, 8, 8), device=cuda))
    assert fn.launches == before


def test_ssd_backward_on_card_matches_cpu(cuda):
    """ops.ssd under autograd, float32: both kernels on the card against
    the plain recurrence and its adjoint on the CPU, a state gradient too."""
    from repro_torch.kernels.ssd_scan.ops import ssd
    args, dy, ds = _ssd_bwd_inputs(2, 90, 4, 32, 2, 64, torch.float32, "cpu", seed=4)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in args]
        before = ssd_kernel.ssd_scan_bwd.launches
        y, s = ssd(*leaves)
        grads[str(dev)] = torch.autograd.grad((y, s), leaves, (dy.to(dev), ds.to(dev)))
        if dev != "cpu":
            assert ssd_kernel.ssd_scan_bwd.launches == before + 1
    _assert_grads_close([g.cpu() for g in grads[str(cuda)]], grads["cpu"], 1e-3)


def test_reduced_mamba2_train_step_on_card_matches_cpu(cuda):
    """One float32 train step of reduced mamba2_2_7b (ffma products, the
    ffma scan and its backward) against the plain path on the CPU
    (``ssd_chunked`` under autograd): loss, grad norm and every updated
    weight, at the smollm step's bars. Per layer: 24 products (6 forward,
    6 recomputed, 6 dx, 6 dw), 2 scans and 1 scan backward."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptConfig, init_opt_state, tree_leaves
    cfg = get_config("mamba2_2_7b", reduced=True)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=6, weight_decay=0.1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=4, seq=100,
                                         mode="cyclic")).batch_at(0)
    step = make_train_step(cfg, opt)
    counters = (tm_kernel.tile_matmul, ssd_kernel.ssd_scan, ssd_kernel.ssd_scan_bwd)
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        before = [fn.launches for fn in counters]
        out[str(dev)] = step(p, init_opt_state(p, opt),
                             {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        if dev != "cpu":
            n = cfg.n_layers
            assert [fn.launches - b for fn, b in zip(counters, before)] == [24 * n, 2 * n, n]
    (pc, _, mc), (pg, _, mg) = out["cpu"], out[str(cuda)]
    for key in ("loss", "grad_norm"):
        assert abs(mg[key] - mc[key]) <= 1e-4 * max(1.0, abs(mc[key])), (key, mg, mc)
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-2 * mc["lr"])


# --- the ACAN runtime: kernels launched from handler threads -----------------

def _in_threads(n: int, fn) -> list:
    """``fn(i)`` on ``n`` threads released together; their results in order.
    A thread's exception is raised here."""
    import threading
    start, out, errors = threading.Barrier(n), [None] * n, []

    def run(i):
        try:
            start.wait(timeout=60)
            out[i] = fn(i)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("layout", ["x@w", "x@w^T", "x^T@w"])
def test_wgmma_launches_from_a_thread_that_made_no_cuda_call_yet(cuda, layout):
    """TMA descriptors need a current context, which a thread has only after
    its first CUDA runtime call: a thread whose first CUDA work is this
    launch (its output's memory comes from the allocator's cache) once
    failed with CUDA error 1."""
    x = _randn((256, 256), torch.bfloat16, cuda, 1)
    w = _randn((256, 256), torch.bfloat16, cuda, 2)
    kw = {"x@w": {}, "x@w^T": {"trans_w": True}, "x^T@w": {"trans_x": True}}[layout]
    want = tm_kernel.tile_matmul(x, w, **kw)
    tm_kernel.tile_matmul(x, w, **kw)   # leaves a freed block of the output's size
    torch.cuda.synchronize()
    got = _in_threads(1, lambda _i: tm_kernel.tile_matmul(x, w, **kw))[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_from_four_threads_give_the_bits_of_one(cuda, dtype):
    """Four threads launch tile_matmul (both gradient layouts too) and
    flash_attention at once, on inputs of their own: each output equals the
    same launch made from one thread."""
    def inputs(i):
        return (_randn((1024, 960), dtype, cuda, 10 + i), _randn((960, 320), dtype, cuda, 20 + i),
                _randn((5, 3, 512, 64), dtype, cuda, 30 + i),
                _randn((5, 512, 64), dtype, cuda, 40 + i), _randn((5, 512, 64), dtype, cuda, 50 + i))

    def launches(i, args):
        x, w, q, k, v = args
        z = tm_kernel.tile_matmul(x, w)
        return (z, tm_kernel.tile_matmul(z, w, trans_w=True),
                tm_kernel.tile_matmul(x, z, trans_x=True), fa_kernel.flash_attention(q, k, v))

    args = [inputs(i) for i in range(4)]
    alone = [launches(i, a) for i, a in enumerate(args)]
    torch.cuda.synchronize()
    for _ in range(3):
        together = _in_threads(4, lambda i: launches(i, args[i]))
        for one, many in zip(alone, together):
            assert all(torch.equal(a, b) for a, b in zip(one, many))


def test_launch_counters_are_exact_after_a_threaded_run(cuda):
    x = _randn((32, 64), torch.bfloat16, cuda, 1)
    w = _randn((64, 64), torch.bfloat16, cuda, 2)
    q = _randn((1, 1, 64, 16), torch.bfloat16, cuda, 3)
    kv = _randn((1, 64, 16), torch.bfloat16, cuda, 4)
    tm, fa = tm_kernel.tile_matmul, fa_kernel.flash_attention
    before = (tm.launches, dict(tm.paths), dict(tm.layouts), fa.launches, dict(fa.paths))

    def work(_i):
        for _ in range(250):
            tm(x, w)
            tm(x, w, trans_w=True)
            fa(q, kv, kv)

    _in_threads(8, work)
    assert tm.launches - before[0] == 8 * 250 * 2
    assert tm.paths["wgmma"] - before[1]["wgmma"] == 8 * 250 * 2
    assert tm.layouts["x@w"] - before[2]["x@w"] == 8 * 250
    assert tm.layouts["x@w^T"] - before[2]["x@w^T"] == 8 * 250
    assert fa.launches - before[3] == 8 * 250
    assert fa.paths["mma"] - before[4]["mma"] == 8 * 250


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_acan_runner_on_the_card_gives_the_same_bits_with_and_without_crashes(cuda, dtype):
    """Reduced smollm_360m trained by the ACAN runner on the card (three
    handler threads, each gradient through the kernels): a run with
    injected crashes gives the crash-free run's losses and params bit for
    bit, and the crash-free run re-issues nothing."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig
    cfg = dataclasses.replace(get_config("smollm_360m", reduced=True), param_dtype=dtype)
    runs = []
    for crash in (0.0, 0.25):
        before = fa_kernel.flash_attention_bwd.launches
        runner = ACANStepRunner(cfg, ACANTrainConfig(
            n_handlers=3, n_micro=3, micro_batch=2, seq=64, steps=3, timeout=5.0,
            handler_crash_prob=crash, ts_backend="checked+local"))
        res = runner.run()
        assert res.param_versions == 3 and res.ts_violations == 0 and res.ts_leaks == {}
        assert fa_kernel.flash_attention_bwd.launches - before >= 3 * 3 * cfg.n_layers
        final = runner.ts.try_read(("params", 3))[1]
        assert final["embed"]["tok"].is_cuda
        runs.append((res, [t.cpu() for t in tree_leaves(final)]))
    (clean, p0), (crashed, p1) = runs
    assert clean.reissues == 0 and crashed.crashes >= 1
    assert all(np.isfinite(clean.losses)) and crashed.losses == clean.losses
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# The paper MLP's tile products: float32 launches of SKINNY_MAX_M masked
# rows; (M, K, N) of its forward (K = n_in) and backward (K = n_out)
# products at the paper's width and on a ragged layer pair.
MLP_SHAPES = [(16, 256, 256, "skinny"), (16, 256, 1, "ffma"), (16, 1, 256, "skinny"),
              (16, 40, 24, "skinny"), (16, 24, 1, "ffma"), (16, 1, 24, "skinny")]


def _masked_rows(v, spans):
    rows = torch.zeros((len(spans), v.shape[0]), dtype=v.dtype, device=v.device)
    for i, (lo, hi) in enumerate(spans):
        rows[i, lo:hi] = v[lo:hi]
    return rows


@pytest.mark.parametrize("m,k,n,path", MLP_SHAPES)
def test_mlp_product_shapes_take_their_path_and_match_plain(cuda, m, k, n, path):
    x = _randn((m, k), torch.float32, cuda, k)
    w = _randn((k, n), torch.float32, cuda, n, k ** -0.5)
    before = dict(tm_kernel.tile_matmul.paths)
    out = tm_kernel.tile_matmul(x, w)
    assert tm_kernel.tile_matmul.paths[path] - before[path] == 1
    torch.testing.assert_close(out, tile_matmul_ref(x, w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,k,n,path", MLP_SHAPES)
def test_an_mlp_row_has_the_same_bits_whatever_shares_its_launch(cuda, m, k, n, path):
    """A re-issued MLP task runs in another handler batch: its row's bits
    must not depend on the other rows of the launch nor on its position."""
    v = _randn((k,), torch.float32, cuda, 5)
    w = _randn((k, n), torch.float32, cuda, 6, k ** -0.5)
    step = max(k // m, 1)
    spans = [(min(i * step, k - 1), min(i * step + step, k)) for i in range(m)]
    full = tm_kernel.tile_matmul(_masked_rows(v, spans), w)
    noise = _randn((m, k), torch.float32, cuda, 7)
    for i in (0, m // 2, m - 1):
        alone = torch.zeros((m, k), device=cuda)
        alone[m - 1 - i] = _masked_rows(v, [spans[i]])[0]
        assert torch.equal(tm_kernel.tile_matmul(alone, w)[m - 1 - i], full[i])
        mixed = noise.clone()
        mixed[i] = alone[m - 1 - i]
        assert torch.equal(tm_kernel.tile_matmul(mixed, w)[i], full[i])


def test_an_mlp_op_body_launches_from_a_fresh_thread(cuda):
    """The forward and backward bodies of the paper's layer 0 on handler
    batches of 16, run from a thread whose first CUDA work is the body:
    the values equal the main thread's, and each product was a launch."""
    from repro_torch.core.executor import ExecContext
    from repro_torch.core.program import GLOBAL_OPS
    from repro_torch.core.space import TupleSpace
    from repro_torch.programs import mlp

    layers = [mlp.LayerSpec(256, 256), mlp.LayerSpec(256, 1)]
    ts = TupleSpace()
    ts.put(("x", 0), _randn((256,), torch.float32, cuda, 1))
    ts.put(("w", 0), _randn((256, 256), torch.float32, cuda, 2, 1 / 16))
    ts.put(("dy", 0, 0), _randn((256,), torch.float32, cuda, 3))
    ctx = ExecContext(ts, {"lr": 0.002})

    def in_a_thread(body, tasks):
        return dict(_in_threads(1, lambda _i: body(ctx, tasks))[0])

    for op, stage in (("forward", "fwd_0"), ("backward", "bwd_0")):
        body = GLOBAL_OPS.resolve(op).batch_fn
        tasks = [p for t in mlp.prototype_tasks(layers, 0, 0)[stage]
                 for p in GLOBAL_OPS.partition(t, 256.0)][:16]
        want = dict(body(ctx, tasks))
        before = tm_kernel.tile_matmul.paths["skinny"]
        got = in_a_thread(body, tasks)
        assert tm_kernel.tile_matmul.paths["skinny"] - before == 1
        assert got.keys() == want.keys()
        assert all(v.is_cuda and torch.equal(v, want[k]) for k, v in got.items())


def test_the_paper_mlp_on_the_card_gives_the_same_bits_with_and_without_crashes(cuda):
    """Exp 3's faults at N = 64 on the card: the crash run's losses and
    weights are the crash-free run's, bit for bit."""
    from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, LayerSpec

    runs = []
    for plan in (FaultPlan(interval=1e9),
                 FaultPlan(interval=0.1, speed_levels=(1.0, 5.0, 10.0), p_speed_change=1.0,
                           p_handler_crash=1.0, p_manager_crash=1.0, seed=1)):
        cloud = ACANCloud(CloudConfig(
            layers=[LayerSpec(64, 64), LayerSpec(64, 1)], n_handlers=4, epochs=1,
            n_samples=10, task_cap=64.0, pouch_size=50, lr=0.02, time_scale=1e-6,
            initial_timeout=0.1, fault_plan=plan, ts_backend="checked+local"))
        res = cloud.run()
        assert res.ledger_ok and res.ts_violations == 0 and res.ts_leaks == {}
        runs.append((res, [cloud.ts.try_read((n, l))[1] for l in range(2) for n in "wb"]))
    (clean, w0), (crashed, w1) = runs
    assert crashed.manager_revivals >= 1 and crashed.handler_revivals >= 1
    assert [l for _, l in crashed.loss_history] == [l for _, l in clean.loss_history]
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(w0, w1))
