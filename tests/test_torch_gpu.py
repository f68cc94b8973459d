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
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


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
                               1, 1, 0, codes[path], 0, 1, stream)
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


# The batched expert products: x (E, M, K) @ w (E, K, N), one launch.
def _batched_plain(x, w, act):
    return torch.stack([tile_matmul_ref(x[e], w[e], activation=act) for e in range(len(x))])


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n", [
    (1, 1, 64, 128), (1, 688, 2048, 1408), (60, 1, 2048, 1408), (60, 32, 2048, 1408),
    (60, 32, 1408, 2048), (60, 688, 1408, 2048), (7, 100, 72, 136), (3, 250, 40, 24)])
def test_tile_matmul_batched_matches_plain(cuda, e, m, k, n, dtype, act):
    """Every expert against its own plain product; E 1 and 60 (qwen2's
    experts), M 1, 32 (decode) and 688 (prefill), ragged M, K and N."""
    x = _randn((e, m, k), dtype, cuda, 1)
    w = _randn((e, k, n), dtype, cuda, 2, k ** -0.5)
    fn = tm_kernel.tile_matmul
    before, layouts = dict(fn.paths), dict(fn.layouts)
    out = tm_kernel.tile_matmul(x, w, activation=act)
    path = "wgmma" if dtype == torch.bfloat16 else "ffma"
    assert {p: fn.paths[p] - before[p] for p in fn.paths} == {
        p: int(p == path) for p in tm_kernel.PATH_CODES}
    assert {q: fn.layouts[q] - layouts[q] for q in fn.layouts} == {
        q: int(q == "batched") for q in fn.layouts}
    torch.testing.assert_close(out.float(), _batched_plain(x, w, act).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_matmul_batched_rows_never_bleed_into_the_next_expert(cuda, dtype):
    """Every odd expert's x and w are NaN: an even expert's tile that read a
    row or a K row past its own (M 100 and K 72 leave ragged tiles) would
    turn NaN. The even experts match the plain version and are finite."""
    x = _randn((6, 100, 72), dtype, cuda, 3)
    w = _randn((6, 72, 136), dtype, cuda, 4, 0.1)
    x[1::2] = float("nan")
    w[1::2] = float("nan")
    out = tm_kernel.tile_matmul(x, w)
    assert torch.isfinite(out[0::2].float()).all()
    assert torch.isnan(out[1::2].float()).all()
    torch.testing.assert_close(out[0::2].float(), _batched_plain(x[0::2], w[0::2], "none")
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_tile_matmul_batched_is_deterministic_and_refuses_bad_input(cuda):
    x = _randn((4, 50, 64), torch.bfloat16, cuda, 5)
    w = _randn((4, 64, 64), torch.bfloat16, cuda, 6)
    assert torch.equal(tm_kernel.tile_matmul(x, w), tm_kernel.tile_matmul(x, w))
    before = tm_kernel.tile_matmul.launches
    for bad in (w[:3], w.transpose(1, 2), w.float()):
        with pytest.raises(ValueError):
            tm_kernel.tile_matmul(x, bad)
    with pytest.raises(ValueError):   # bf16 K not a multiple of 8: no wgmma
        tm_kernel.tile_matmul(x[..., :60].contiguous(), w[:, :60].contiguous())
    with pytest.raises(ValueError):   # no bias
        tm_kernel.tile_matmul(x, w, torch.zeros(64, dtype=x.dtype, device=cuda))
    with pytest.raises(ValueError):   # w^T stored (E, N, K) must have x's K
        tm_kernel.tile_matmul(x, torch.zeros(4, 64, 32, dtype=x.dtype, device=cuda),
                              trans_w=True)
    assert tm_kernel.tile_matmul.launches == before
    stream = torch.cuda.current_stream(cuda).cuda_stream
    out = torch.empty((4, 50, 64), dtype=torch.bfloat16, device=cuda)
    for path in ("mma", "skinny"):   # the C side takes only wgmma and ffma batched
        assert tm_kernel._lib()(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 50, 64, 64,
                                1, 1, 0, tm_kernel.PATH_CODES[path], 0, 4, stream) == 1


# The batched gradient layouts at qwen2_moe_a2_7b's training shapes (E 60,
# R 688 rows an expert, d 2048, d_ff 1408: dx of the gate / up products and
# of the down product, dw of each) and ragged ones: (E, R, K, N) of the
# forward product x (E, R, K) @ w (E, K, N) whose gradients are taken.
BATCHED_GRAD_SHAPES = [(60, 688, 2048, 1408), (60, 688, 1408, 2048), (3, 100, 72, 136),
                       (5, 48, 40, 24), (2, 1, 64, 128)]


def _batched_grad_products(e, r, k, n, dtype, cuda):
    """(a, b, kwargs, layout) of dx = dz @ w^T and dw = x^T @ dz."""
    x = _randn((e, r, k), dtype, cuda, 11)
    w = _randn((e, k, n), dtype, cuda, 12, k ** -0.5)
    dz = _randn((e, r, n), dtype, cuda, 13, r ** -0.5)
    return ((dz, w, dict(trans_w=True), "batched x@w^T"),
            (x, dz, dict(trans_x=True), "batched x^T@w"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,r,k,n", BATCHED_GRAD_SHAPES)
def test_tile_matmul_batched_gradient_layouts_match_plain(cuda, e, r, k, n, dtype):
    """The batched ``x@w^T`` (dx) and ``x^T@w`` (dw, its reduction over an
    expert's R rows: 688 leaves a 48-row K tail) in one launch each, bf16
    on wgmma, float32 on ffma, counted under their batched layouts; every
    expert against its own plain product; a repeat gives the same bits."""
    fn = tm_kernel.tile_matmul
    path = "wgmma" if dtype == torch.bfloat16 else "ffma"
    for a, b, kw, layout in _batched_grad_products(e, r, k, n, dtype, cuda):
        paths, layouts = dict(fn.paths), dict(fn.layouts)
        out = fn(a, b, **kw)
        assert {p: fn.paths[p] - paths[p] for p in fn.paths} == {
            p: int(p == path) for p in fn.paths}
        assert {q: fn.layouts[q] - layouts[q] for q in fn.layouts} == {
            q: int(q == layout) for q in fn.layouts}
        ref = torch.stack([tile_matmul_ref(a[i], b[i], **kw) for i in range(e)])
        assert out.shape == ref.shape and out.dtype == dtype
        torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.equal(out, fn(a, b, **kw))


@pytest.mark.parametrize("act", ["gelu", "silu", "none"])
def test_tile_matmul_counts_the_float32_z_of_a_bf16_gradient_by_output_type(cuda, act):
    """A bf16 product with a bias and a fused activation, differentiated:
    the forward, dx and dw write bf16; the backward's z of the activation
    is the one launch that writes float32 from bf16 operands (none without
    an activation). The counts are what chip_smoke.py reads as a train
    run's z launches."""
    from repro_torch.kernels.tile_matmul.ops import matmul
    fn = tm_kernel.tile_matmul
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(256, 192, generator=g, device=cuda).bfloat16().requires_grad_(True)
    w = (torch.randn(192, 320, generator=g, device=cuda) * 0.07).bfloat16().requires_grad_(True)
    b = torch.randn(320, generator=g, device=cuda).bfloat16().requires_grad_(True)
    before = dict(fn.outputs)
    matmul(x, w, b, activation=act).float().sum().backward()
    torch.cuda.synchronize()
    z = int(act != "none")
    assert {k: fn.outputs[k] - before[k] for k in fn.outputs} == {
        "bfloat16->bfloat16": 3, "bfloat16->float32": z, "float32->float32": 0,
        "float32->bfloat16": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_matmul_batched_gradient_layouts_never_bleed_into_the_next_expert(cuda, dtype):
    """Every odd expert's operands are NaN. dx and dw of the even experts
    (R 100: dw's last K box of each expert is partial, and the rows past it
    are the next expert's) match the plain version and are finite; the odd
    experts' are NaN."""
    for a, b, kw, _ in _batched_grad_products(6, 100, 72, 136, dtype, cuda):
        a[1::2] = float("nan")
        b[1::2] = float("nan")
        out = tm_kernel.tile_matmul(a, b, **kw)
        assert torch.isfinite(out[0::2].float()).all() and torch.isnan(out[1::2].float()).all()
        ref = torch.stack([tile_matmul_ref(a[i], b[i], **kw) for i in range(0, 6, 2)])
        torch.testing.assert_close(out[0::2].float(), ref.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("act", ["none", "silu"])
def test_batched_product_backward_on_the_card_launches_both_layouts(cuda, act):
    """``batched_product`` under autograd on the card: the forward one
    batched launch, the backward a float32 ``z`` launch (SiLU only), then
    dx and dw, one launch each in their batched layouts on wgmma; the
    gradients match the plain version of that backward (float32 products
    of ``dz = dy act'(z)`` rounded to bf16, as the port rounds it; bf16
    bar), and a second backward gives the same bits."""
    from repro_torch.kernels.tile_matmul.ops import batched_product
    from repro_torch.kernels.tile_matmul.ref import ACT_GRADS, tile_matmul_batched_ref
    x = _randn((4, 150, 96), torch.bfloat16, cuda, 21).requires_grad_()
    w = _randn((4, 96, 80), torch.bfloat16, cuda, 22, 0.1).requires_grad_()
    dy = _randn((4, 150, 80), torch.bfloat16, cuda, 23)
    fn = tm_kernel.tile_matmul
    layouts = dict(fn.layouts)
    out = batched_product(x, w, activation=act)
    grads = torch.autograd.grad(out, (x, w), dy, retain_graph=True)
    again = torch.autograd.grad(out, (x, w), dy)
    assert {q: fn.layouts[q] - layouts[q] for q in fn.layouts} == dict.fromkeys(
        fn.layouts, 0) | {"batched": 1 + 2 * (act != "none"), "batched x@w^T": 2,
                          "batched x^T@w": 2}
    xd, wd = x.detach(), w.detach()
    torch.testing.assert_close(out.float(), tile_matmul_batched_ref(xd, wd, activation=act)
                               .float(), rtol=2e-2, atol=2e-2)
    dz = dy.float()
    if act != "none":
        dz = dz * ACT_GRADS[act](tile_matmul_batched_ref(xd, wd, out_dtype=torch.float32))
    dz = dz.to(torch.bfloat16)
    want = (tile_matmul_batched_ref(dz, wd, trans_w=True),
            tile_matmul_batched_ref(xd, dz, trans_x=True))
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_tile_matmul_wgmma_kernels_hold_hgmma_without_spills(cuda):
    """The batched launch runs the wgmma kernels of the 2-D product, with the
    expert on blockIdx.z: their SASS holds HGMMA and TMA loads, and ptxas
    reports no spill and no stack frame for any of them."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build

    _build.load("tile_matmul")
    log = _build.build_log("tile_matmul")
    if not log:
        pytest.skip("library built by an earlier process: no ptxas log")
    name, seen = None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "tile_matmul_wgmma" in name and "spill stores" in line:
            assert "0 bytes stack" in line and "0 bytes spill stores" in line, (name, line)
            seen += 1
    assert seen > 0
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target("tile_matmul"))],
                          capture_output=True, text=True, check=True).stdout
    wg = [part for part in sass.split("Function : ")[1:] if "tile_matmul_wgmma" in part[:200]]
    assert wg and all("HGMMA" in part and "UTMALDG" in part for part in wg)


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
    # float32 through mma; bf16 through mma from an unaligned pointer; D = 48;
    # (D, Dv) pairs other than (192, 128) and (24, 16); (24, 16) through mma
    assert lib(q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(), None, 1, 1, 16, 16,
               64, 64, 0, 1, 0, 0.0, 0, 0.125, codes["mma"], stream) == 1
    qb = _randn((1, 1, 17, 64), torch.bfloat16, cuda, 1)
    kb = _randn((1, 16, 64), torch.bfloat16, cuda, 2)
    assert lib(qb.data_ptr() + 2, kb.data_ptr(), kb.data_ptr(), qb.data_ptr() + 2, None, 1,
               1, 16, 16, 64, 64, 1, 1, 0, 0.0, 0, 0.125, codes["mma"], stream) == 1
    for path in ("mma", "ffma"):
        for d, dv in ((48, 48), (192, 64), (128, 192), (192, 192)):
            assert lib(qb.data_ptr(), kb.data_ptr(), kb.data_ptr(), qb.data_ptr(), None, 1, 1,
                       16, 16, d, dv, 1, 1, 0, 0.0, 0, 0.125, codes[path], stream) == 1
    assert lib(qb.data_ptr(), kb.data_ptr(), kb.data_ptr(), qb.data_ptr(), None, 1, 1, 16, 16,
               24, 16, 1, 1, 0, 0.0, 0, 0.125, codes["mma"], stream) == 1


FLASH_NEW_D_CASES = [  # (bh, g, tq, tk, d, window): the dense configs' head dims
    (4, 2, 300, 300, 256, 0),       # gemma3_12b global, G = 2, ragged
    (4, 2, 300, 300, 256, 128),     # gemma3_12b local (windowed)
    (2, 12, 77, 133, 256, 40),      # G = 12, q_offset = 56, both ragged
    (2, 4, 200, 260, 256, 70),      # G = 4, window + q_offset = 60
    (1, 5, 129, 129, 256, 0),       # G = 5, global, ragged
    (2, 4, 600, 600, 80, 256),      # h2o_danube_1_8b (windowed), G = 4
    (3, 2, 130, 130, 80, 0),        # D = 80, G = 2, global, ragged
    (2, 12, 90, 190, 80, 70),       # D = 80, G = 12, window + q_offset = 100
]


def _flash_limit(ref, dtype):
    """TOL (|plain| + min(1, rms of the plain row)) per element: scaled to
    the output, whose rows are of size sqrt(e / keys seen)."""
    return TOL[dtype] * (ref.abs() + ref.square().mean(-1, keepdim=True).sqrt().clamp(max=1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,d,window", FLASH_NEW_D_CASES)
def test_flash_attention_new_head_dims_match_plain(cuda, bh, g, tq, tk, d, window, dtype):
    """D = 80 and 256 on the path their dtype takes (bf16: mma, float32:
    ffma), the row log-sum-exp too, and bf16 once more through ffma."""
    q = _randn((bh, g, tq, d), dtype, cuda, 1)
    k = _randn((bh, tk, d), dtype, cuda, 2)
    v = _randn((bh, tk, d), dtype, cuda, 3)
    kw = dict(causal=True, window=window, q_offset=tk - tq)
    ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    paths = [fa_kernel.choose_path(dtype, d, True)] + (["ffma"] if dtype == torch.bfloat16 else [])
    assert paths[0] == ("mma" if dtype == torch.bfloat16 else "ffma")
    for path in paths:
        before = dict(fa_kernel.flash_attention.paths)
        out, lse = fa_kernel.flash_attention(q, k, v, path=path, return_lse=True, **kw)
        assert fa_kernel.flash_attention.paths[path] == before[path] + 1
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= _flash_limit(ref.float(), dtype)).all()), diff.max().item()
        torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["gemma3_12b", "h2o_danube_1_8b", "command_r_plus_104b"])
def test_reduced_dense_config_logits_on_card_match_cpu(cuda, arch):
    """Float32 prefill past the reduced window, re-home, then decode steps
    that wrap the ring: logits on the card (every projection and attention
    through the kernels) against the plain path on the CPU at 1e-4."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import rehome
    from repro_torch.models import model as M
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    runs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        before = fa_kernel.flash_attention.launches
        small, logits = M.prefill(p, cfg, {"tokens": prompt.to(dev)})
        if dev != "cpu":
            assert fa_kernel.flash_attention.launches == before + cfg.n_layers
        cache = rehome(M.init_cache(cfg, 2, 80, dev), small)
        outs = [logits.cpu()]
        for step in range(36):
            tok = torch.full((2,), (7 * step) % cfg.vocab, dtype=torch.int64, device=dev)
            logits, cache = M.decode_step(p, cfg, cache, {"token": tok, "cur_len": 40 + step})
            outs.append(logits.cpu())
        runs[str(dev)] = outs
    for got, want in zip(runs[str(cuda)], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "gemma3_12b"])
def test_training_a_dense_config_on_the_card_runs_the_backward_kernel(cuda, tmp_path, arch):
    """Full-width h2o_danube_1_8b (D = 80) and gemma3_12b (D = 256), cut to
    one period through ``train(params=...)``: two steps, every attention's
    gradient one flash_attention_bwd launch on the mma path, finite losses."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), n_periods=1)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), cuda)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    res = train(arch, reduced=False, steps=2, batch=1, seq=64, ckpt_dir=str(tmp_path),
                ckpt_every=0, params=params, log=lambda _: None)
    after = fa_kernel.flash_attention_bwd.paths
    assert {p: after[p] - before[p] for p in after} == {"mma": 2 * cfg.n_layers, "ffma": 0}
    assert all(np.isfinite(res["losses"]))


def test_qwen2_remat_recomputes_the_routing_and_the_gradients_bit_for_bit(cuda):
    """Full-width qwen2_moe_a2_7b cut to 2 layers, bf16, 2 x 1024 tokens
    (one group of 2048, capacity 43: tokens drop). Under remat "nothing"
    the backward recomputes each layer's forward, routing included, into
    buffers of the same shape whatever the routing: the gradients of every
    weight equal those under remat "none" bit for bit only if every token
    is routed again as it was. A second "nothing" pass from the same state
    gives the same bits (the MoE backward adds nothing by index). Each
    expert product's dx and dw are one batched launch each, a layer a
    pass."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"), n_periods=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), cuda)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, batch=2, seq=1024, mode="cyclic")).batch_at(0).items()}
    fn = tm_kernel.tile_matmul
    runs = []
    for remat in ("nothing", "none", "nothing"):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        layouts = dict(fn.layouts)
        loss, _ = M.train_loss(leaves, dataclasses.replace(cfg, remat=remat), batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
        torch.cuda.synchronize()
        assert {q: fn.layouts[q] - layouts[q] for q in ("batched x@w^T", "batched x^T@w")} \
            == {"batched x@w^T": 3 * cfg.n_layers, "batched x^T@w": 3 * cfg.n_layers}
        runs.append((loss.detach(), grads))
        del leaves
    (l0, g0), (l1, g1), (l2, g2) = runs
    assert torch.isfinite(l0) and torch.equal(l0, l1) and torch.equal(l0, l2)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g2))


@pytest.mark.parametrize("arch,reduced", [("musicgen_medium", False),
                                          ("jamba_1_5_large_398b", True)])
def test_remat_dots_launches_each_forward_once_and_gives_the_gradients_of_nothing(
        cuda, arch, reduced):
    """Full-width musicgen_medium at 2 layers in bf16 (2 x 512 codebook
    tokens), and the reduced jamba in float32 (attention, Mamba and MoE
    layers). Under remat "dots" the backward's recompute gets every kernel
    forward's output back: tile_matmul's forward launches (``x@w``) fall to
    the products and fused gates' z a layer, flash_attention and ssd_scan to
    one a layer; "nothing" launches each forward twice. The loss and every
    gradient are the same bits under "nothing", "dots" and "none"."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.frontend import pipeline_for
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    cfg = get_config(arch, reduced=reduced)
    if not reduced:
        cfg = dataclasses.replace(cfg, n_periods=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), cuda)
    pipe = pipeline_for(cfg, 2, 512 if not reduced else 64)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in pipe.batch_at(0).items()}
    layers = [*cfg.prefix, *cfg.period * cfg.n_periods]
    attn = sum(lc.mixer == "attn" for lc in layers)
    scan = len(layers) - attn
    counters = {"tile_matmul": tm_kernel.tile_matmul, "flash_attention": fa_kernel.flash_attention,
                "ssd_scan": ssd_kernel.ssd_scan}
    runs = {}
    for remat in ("nothing", "dots", "none"):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        before = {k: fn.launches for k, fn in counters.items()}
        x_at_w = tm_kernel.tile_matmul.layouts["x@w"]
        loss, _ = M.train_loss(leaves, dataclasses.replace(cfg, remat=remat), batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
        torch.cuda.synchronize()
        launched = {k: fn.launches - before[k] for k, fn in counters.items()}
        runs[remat] = (loss.detach(), grads, tm_kernel.tile_matmul.layouts["x@w"] - x_at_w,
                       launched["flash_attention"], launched["ssd_scan"])
        del leaves
    loss, grads, fwd, _, _ = runs["nothing"]
    for remat in ("dots", "none"):
        assert torch.equal(runs[remat][0], loss)
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], grads)), remat
        assert runs[remat][3:] == (attn, scan), (remat, runs[remat][3:])
    assert runs["nothing"][3:] == (2 * attn, 2 * scan)
    kept = runs["dots"][2]
    assert runs["none"][2] == kept and fwd - kept == kept - sum(
        lc.ffn_kind == "dense" or (lc.ffn_kind == "moe" and lc.moe.n_shared > 0)
        for lc in layers), (fwd, kept)


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
                                    64, 1, 1, 0, codes[path], layouts[layout], 1,
                                    stream) == 1
    assert tm_kernel._lib()(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 8, 64, 64, 1,
                            1, 0, codes["wgmma"], 3, 1, stream) == 1


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


def _flash_bwd_limit(want, dtype):
    """TOL (|plain| + max(rms of the plain gradient's row, rms of the
    whole)) per element: scaled to the gradient, whose rows are of size
    sqrt(e / keys or rows seen); the whole's rms floors rows that are
    rounding noise (one key seen: dS = 0)."""
    rms = want.square().mean(-1, keepdim=True).sqrt()
    return TOL[dtype] * (want.abs() + rms.clamp(min=want.square().mean().sqrt().item()))


def _assert_attention_grads_close(grads, refs, dtype):
    for got, want in zip(grads, refs):
        assert got.dtype == dtype and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= _flash_bwd_limit(want.float(), dtype)).all()), diff.max().item()


FLASH_BWD_NEW_D_CASES = [  # (bh, g, tq, tk, d, window, softcap): the dense configs' head dims
    (4, 2, 300, 300, 256, 0, 0.0),      # gemma3_12b global, G = 2, ragged
    (4, 2, 300, 300, 256, 128, 15.0),   # gemma3_12b local, softcap
    (2, 12, 77, 133, 256, 40, 0.0),     # G = 12, q_offset = 56, both ragged
    (2, 4, 200, 260, 256, 70, 0.0),     # G = 4, window + q_offset = 60
    (1, 5, 129, 129, 256, 0, 30.0),     # G = 5, global, softcap, ragged
    (2, 4, 600, 600, 80, 256, 0.0),     # h2o_danube_1_8b (windowed), G = 4
    (3, 2, 70, 70, 80, 0, 20.0),        # D = 80, G = 2, global, softcap, ragged
    (2, 12, 90, 190, 80, 70, 0.0),      # D = 80, G = 12, window + q_offset = 100
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,d,window,softcap", FLASH_BWD_NEW_D_CASES)
def test_flash_attention_backward_new_head_dims_match_plain(cuda, bh, g, tq, tk, d, window,
                                                            softcap, dtype):
    """D = 80 and 256 on the path their dtype takes (bf16: mma, the wgmma
    kernels at 256; float32: ffma, 32-row tiles at 256), and bf16 once more
    through ffma: against the explicit formula,
    each element within ``_flash_bwd_limit``; the same bits on a second
    launch."""
    q = _randn((bh, g, tq, d), dtype, cuda, 1)
    k = _randn((bh, tk, d), dtype, cuda, 2)
    v = _randn((bh, tk, d), dtype, cuda, 3)
    do = _randn((bh, g, tq, d), dtype, cuda, 4)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    refs = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    paths = ["mma", "ffma"] if dtype == torch.bfloat16 else ["ffma"]
    assert fa_kernel.choose_path(dtype, d, True) == paths[0]
    for path in paths:
        before = dict(fa_kernel.flash_attention_bwd.paths)
        grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, path=path, **kw)
        assert fa_kernel.flash_attention_bwd.paths[path] == before[path] + 1
        _assert_attention_grads_close(grads, refs, dtype)
        again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, path=path, **kw)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
def test_flash_attention_backward_takes_every_head_dim(cuda, d):
    """No head dim the forward takes is refused by the backward, on either
    path: one launch each (bf16 mma and ffma, float32 ffma) against the
    formula."""
    for dtype, paths in ((torch.bfloat16, ("mma", "ffma")), (torch.float32, ("ffma",))):
        q = _randn((2, 2, 40, d), dtype, cuda, 1)
        k = _randn((2, 50, d), dtype, cuda, 2)
        do = _randn((2, 2, 40, d), dtype, cuda, 3)
        o, lse = fa_kernel.flash_attention(q, k, k, return_lse=True, q_offset=10)
        refs = flash_attention_bwd_ref(q, k, k, o, do, lse, q_offset=10)
        for path in paths:
            grads = fa_kernel.flash_attention_bwd(q, k, k, o, do, lse, q_offset=10, path=path)
            _assert_attention_grads_close(grads, refs, dtype)


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


FLASH_D256_EDGE_CASES = [  # (bh, g, tq, tk, causal, window, softcap): bf16, D = 256 (wgmma)
    (2, 1, 65, 65, False, 0, 0.0),     # not causal, one row past a 64-row tile
    (2, 1, 129, 129, True, 0, 0.0),    # one row past a 128-row forward block
    (3, 2, 1, 65, True, 0, 0.0),       # a single step (one query position, q_offset = 64)
    (2, 3, 130, 200, True, 10, 0.0),   # a window narrower than a tile, q_offset = 70
    (2, 3, 64, 640, True, 0, 0.0),     # q_offset = 576: one row tile sees all key tiles
    (1, 5, 100, 100, True, 0, 15.0),   # G = 5 folds rows across tile edges, softcap
    (1, 12, 50, 90, True, 30, 0.0),    # G = 12 across tile edges, window, q_offset = 40
    (2, 2, 96, 96, True, 0, 50.0),     # softcap
    (2, 4, 70, 150, False, 0, 0.0),    # not causal, fewer rows than keys
]


FLASH_D256_SHORT_CASES = [  # forward only: fewer keys than one 64-key TMA box
    (3, 2, 1, 1, True, 0, 0.0),        # one key: the output is v
    (2, 2, 17, 17, True, 0, 0.0),      # a prompt of 17 tokens
    (2, 3, 5, 40, True, 0, 0.0),       # q_offset = 35
    (1, 4, 20, 50, True, 8, 30.0),     # window, softcap, q_offset = 30
    (2, 2, 10, 33, False, 0, 0.0),     # not causal
]


def _took_twice(fn, before, path="mma"):
    after = fn.paths
    assert {p: after[p] - before[p] for p in after} == {p: 2 * int(p == path) for p in after}


@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap",
                         FLASH_D256_EDGE_CASES + FLASH_D256_SHORT_CASES)
def test_flash_attention_d256_edges_match_plain(cuda, bh, g, tq, tk, causal, window, softcap):
    """Shapes the D = 256 forward's tiling makes special (partial tiles and
    blocks, a warpgroup's band narrower than its block's, tiles left
    unmasked, fewer keys than one TMA box, whose rest fills with zeros)
    against the plain version, each element within ``_flash_limit``, the
    lse too; two launches on mma, the same bits."""
    q = _randn((bh, g, tq, 256), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, 256), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, 256), torch.bfloat16, cuda, 3)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention.paths)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    again = fa_kernel.flash_attention(q, k, v, **kw)
    _took_twice(fa_kernel.flash_attention, before)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= _flash_limit(ref.float(), torch.bfloat16)).all()), diff.max().item()
    torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-4)
    assert torch.equal(out, again)


@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap", FLASH_D256_EDGE_CASES)
def test_flash_attention_backward_d256_edges_match_plain(cuda, bh, g, tq, tk, causal, window,
                                                         softcap):
    """The same shapes through the D = 256 backward kernels (the dQ
    warpgroups' key halves, the dK/dV warpgroups' P^T hand-over, tiles left
    unmasked) against the explicit formula, each element within
    ``_flash_bwd_limit``; two launches on mma, the same bits."""
    q = _randn((bh, g, tq, 256), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, 256), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, 256), torch.bfloat16, cuda, 3)
    do = _randn((bh, g, tq, 256), torch.bfloat16, cuda, 4)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    _took_twice(fa_kernel.flash_attention_bwd, before)
    _assert_attention_grads_close(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw),
                                  torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


FLASH_WG_EDGE_CASES = [  # (bh, g, tq, tk, causal, window, softcap): bf16, D = 80 and 128
    (2, 1, 65, 65, False, 0, 0.0),       # not causal, G = 1, one row past a tile
    (2, 1, 129, 129, True, 0, 0.0),      # one row past a 128-row forward block
    (3, 2, 1, 65, True, 0, 0.0),         # a single query position, q_offset = 64
    (2, 2, 130, 200, True, 10, 0.0),     # a window narrower than a tile, q_offset = 70
    (2, 4, 64, 640, True, 0, 0.0),       # q_offset = 576: one row tile sees every key tile
    (1, 4, 300, 300, True, 0, 15.0),     # softcap, G = 4
    (1, 12, 50, 90, True, 30, 0.0),      # G = 12 across tile edges, window, q_offset = 40
    (2, 4, 200, 333, True, 150, 30.0),   # window, softcap, both ragged, q_offset = 133
    (2, 4, 70, 150, False, 0, 0.0),      # not causal, fewer rows than keys
]
FLASH_WG_SHORT_CASES = [  # fewer keys than one TMA box of the forward
    (3, 2, 1, 1, True, 0, 0.0),          # one key: the output is v
    (2, 2, 17, 17, True, 0, 0.0),        # a prompt of 17 tokens
    (2, 12, 5, 40, True, 0, 0.0),        # G = 12, q_offset = 35
    (1, 4, 20, 50, True, 8, 30.0),       # window, softcap, q_offset = 30
    (2, 1, 10, 33, False, 0, 0.0),       # not causal
]


@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap",
                         FLASH_WG_EDGE_CASES + FLASH_WG_SHORT_CASES)
def test_flash_attention_d80_d128_edges_match_plain(cuda, bh, g, tq, tk, causal, window, softcap,
                                                    d):
    """Shapes the wgmma forward at D = 80 (32-byte boxes) and 128 makes
    special (partial tiles and blocks, a warpgroup's band narrower than its
    block's, tiles left unmasked, fewer keys than one TMA box, whose rest
    fills with zeros) against the plain version, each element within
    ``_flash_limit``, the lse too; two launches on mma, the same bits."""
    q = _randn((bh, g, tq, d), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, d), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, d), torch.bfloat16, cuda, 3)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention.paths)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    again = fa_kernel.flash_attention(q, k, v, **kw)
    _took_twice(fa_kernel.flash_attention, before)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= _flash_limit(ref.float(), torch.bfloat16)).all()), diff.max().item()
    torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-4)
    assert torch.equal(out, again)


MLA_CASES = [  # (bh, g, tq, tk, window): q/k head dim 192, v head dim 128 (MLA)
    (16, 1, 1024, 1024, 0),         # deepseek_v2_lite_16b's prefill, 1 sequence
    (6, 1, 130, 130, 0),            # G = 1, ragged Tq = Tkv
    (4, 1, 77, 133, 0),             # q_offset = 56, both ragged
    (2, 1, 129, 129, 0),            # one row past a 128-row forward block
    (3, 1, 1, 65, 0),               # a single query position, q_offset = 64
    (2, 1, 17, 17, 0),              # fewer keys than one TMA box
    (2, 4, 200, 333, 150),          # G = 4, window, both ragged
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,window", MLA_CASES)
def test_flash_attention_mla_pair_matches_plain(cuda, bh, g, tq, tk, window, dtype):
    """MLA's (192, 128) pair, causal, on the path its dtype takes (bf16:
    ``flash_fwd_wg<192, 128>`` on mma, float32: ffma), against the plain
    version: the output of v's head dim, each element within
    ``_flash_limit``, the lse; two launches, the same bits."""
    q = _randn((bh, g, tq, 192), dtype, cuda, 1)
    k = _randn((bh, tk, 192), dtype, cuda, 2)
    v = _randn((bh, tk, 128), dtype, cuda, 3)
    kw = dict(causal=True, window=window, q_offset=tk - tq)
    ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    path = fa_kernel.choose_path(dtype, 192, True, 128)
    assert path == ("mma" if dtype == torch.bfloat16 else "ffma")
    before = dict(fa_kernel.flash_attention.paths)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    again = fa_kernel.flash_attention(q, k, v, **kw)
    _took_twice(fa_kernel.flash_attention, before, path)
    assert out.shape == (bh, g, tq, 128) and out.dtype == dtype
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= _flash_limit(ref.float(), dtype)).all()), diff.max().item()
    torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-4)
    assert torch.equal(out, again)


def test_flash_attention_bwd_refuses_the_mla_pair_on_the_card(cuda):
    """Named when the card refused the backward at (192, 128); the pair now
    launches there, and this holds it: on the mma path (``flash_bwd_dq_wgmma<192>`` and
    ``flash_bwd_dkv_wgsplit<192>``), never the plain version, gradients of
    q's, k's and v's shapes within ``_flash_bwd_limit``."""
    q = _randn((2, 1, 64, 192), torch.bfloat16, cuda, 1)
    k = _randn((2, 64, 192), torch.bfloat16, cuda, 2)
    v = _randn((2, 64, 128), torch.bfloat16, cuda, 3)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    do = torch.ones_like(out)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, out, do, lse)
    after = fa_kernel.flash_attention_bwd.paths
    assert {p: after[p] - before[p] for p in after} == {"mma": 1, "ffma": 0}
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    _assert_attention_grads_close(grads, flash_attention_bwd_ref(q, k, v, out, do, lse),
                                  torch.bfloat16)


MLA_BWD_CASES = [  # (bh, g, tq, tk, causal, window, softcap) at q/k 192, v 128
    (16, 1, 1024, 1024, True, 0, 0.0),   # deepseek_v2_lite_16b's layer, 2 sequences
] + FLASH_WG_EDGE_CASES + FLASH_WG_SHORT_CASES[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap", MLA_BWD_CASES)
def test_flash_attention_backward_mla_pair_matches_plain(cuda, bh, g, tq, tk, causal, window,
                                                         softcap, dtype):
    """MLA's (192, 128) backward on the path its dtype takes (bf16: the
    wgmma kernels, Q/K rows of three 128-byte atoms and dO/V rows of two, the
    dK/dV role split; float32: ffma) against the explicit formula: dq and
    dk of q's head dim, dv of v's, each element within ``_flash_bwd_limit``
    (2e-2 in bf16, 2e-4 in float32); two launches, the same bits."""
    q = _randn((bh, g, tq, 192), dtype, cuda, 1)
    k = _randn((bh, tk, 192), dtype, cuda, 2)
    v = _randn((bh, tk, 128), dtype, cuda, 3)
    do = _randn((bh, g, tq, 128), dtype, cuda, 4)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    path = fa_kernel.choose_path(dtype, 192, True, 128)
    assert path == ("mma" if dtype == torch.bfloat16 else "ffma")
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    _took_twice(fa_kernel.flash_attention_bwd, before, path)
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]
    _assert_attention_grads_close(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw),
                                  dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,tq,tk,window", [
    (8, 1, 64, 64, 0),      # the reduced deepseek config's layer: 4 heads, G 1
    (3, 2, 77, 133, 20),    # G = 2, window, q_offset = 56, both ragged
    (2, 1, 1, 1, 0),        # one key
])
def test_flash_attention_reduced_mla_pair_on_ffma_matches_plain(cuda, bh, g, tq, tk, window,
                                                                dtype):
    """The reduced deepseek config's pair, q/k head dim 24 (16 + 8) and v
    head dim 16, which only the ffma path takes (bf16 too): forward (output
    within ``_flash_limit``, the lse) and backward (within
    ``_flash_bwd_limit``) against the plain versions, one ffma launch
    each."""
    q = _randn((bh, g, tq, 24), dtype, cuda, 1)
    k = _randn((bh, tk, 24), dtype, cuda, 2)
    v = _randn((bh, tk, 16), dtype, cuda, 3)
    do = _randn((bh, g, tq, 16), dtype, cuda, 4)
    kw = dict(causal=True, window=window, q_offset=tk - tq)
    assert fa_kernel.choose_path(dtype, 24, True, 16) == "ffma"
    before = (dict(fa_kernel.flash_attention.paths), dict(fa_kernel.flash_attention_bwd.paths))
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for fn, b in zip((fa_kernel.flash_attention, fa_kernel.flash_attention_bwd), before):
        assert {p: fn.paths[p] - b[p] for p in b} == {"mma": 0, "ffma": 1}
    ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert o.shape == (bh, g, tq, 16)
    diff = (o.float() - ref.float()).abs()
    assert bool((diff <= _flash_limit(ref.float(), dtype)).all()), diff.max().item()
    torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-4)
    if tk > 1:  # one key: dS = 0 and the limit is 0 (rounding noise)
        _assert_attention_grads_close(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw),
                                      dtype)


def test_flash_attention_bwd_mla_kernels_hold_hgmma_without_spills(cuda):
    """``flash_bwd_dq_wgmma<192>`` and ``flash_bwd_dkv_wgsplit<192>``:
    ptxas reports no spill and no stack frame, and each kernel's SASS holds
    HGMMA."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build

    _build.load("flash_attention_bwd")
    log = _build.build_log("flash_attention_bwd")
    if not log:
        pytest.skip("library built by an earlier process: no ptxas log")
    name, seen = None, set()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "ILi192E" in name and "spill stores" in line:
            assert "0 bytes stack" in line and "0 bytes spill stores" in line, (name, line)
            seen.add(name)
    for kname in ("flash_bwd_dq_wgmmaILi192E", "flash_bwd_dkv_wgsplitILi192E"):
        assert any(kname in n for n in seen), (kname, seen)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target("flash_attention_bwd"))],
                          capture_output=True, text=True, check=True).stdout
    for kname in ("flash_bwd_dq_wgmmaILi192E", "flash_bwd_dkv_wgsplitILi192E"):
        parts = [part for part in sass.split("Function : ")[1:] if kname in part[:200]]
        assert parts and all("HGMMA" in part for part in parts), kname


def test_deepseek_train_step_at_full_width_on_card_matches_cpu(cuda):
    """One float32 train step of full-width deepseek_v2_lite_16b cut to 2
    layers (the dense first layer and one MoE layer of 64 experts), 1 x 256
    tokens, on the card (every MLA backward through flash_attention_bwd at
    (192, 128) on ffma) against the CPU's from the same weights: loss and
    grad norm within 1e-3, each gradient (from AdamW's first moment) within
    1e-3 of its tensor's largest entry."""
    import dataclasses

    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptConfig, init_opt_state

    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"), n_periods=1,
                              param_dtype="float32")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=5, weight_decay=0.0)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=1, seq=256,
                                          mode="cyclic")).batch_at(0)
    step = make_train_step(cfg, opt)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        before = dict(fa_kernel.flash_attention_bwd.paths)
        runs[dev.type] = step(p, init_opt_state(p, opt),
                              {k: torch.as_tensor(v, device=dev) for k, v in tokens.items()})
        after = fa_kernel.flash_attention_bwd.paths
        if dev.type == "cuda":
            assert {q: after[q] - before[q] for q in after} == {"mma": 0, "ffma": 2}
        del p
    (_, sg, mg), (_, sc, mc) = runs["cuda"], runs["cpu"]
    assert abs(mg["loss"] - mc["loss"]) <= 1e-3, (mg, mc)
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-3 * max(1.0, mc["grad_norm"])
    got, want = _flatten(sg["m"]), _flatten(sc["m"])
    for key, w in want.items():
        err = (got[key].cpu() - w).abs().max().item()
        assert err <= 1e-3 * max(w.abs().max().item(), 1e-30), (key, err)


def test_flash_attention_mla_kernel_holds_hgmma_without_spills(cuda):
    """``flash_fwd_wg<192, 128>``, and every other wgmma forward: ptxas
    reports no spill and no stack frame, and its SASS holds HGMMA and TMA
    loads."""
    import shutil
    import subprocess

    from repro_torch.kernels import _build

    _build.load("flash_attention")
    log = _build.build_log("flash_attention")
    if not log:
        pytest.skip("library built by an earlier process: no ptxas log")
    name, seen = None, set()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "flash_fwd_wg" in name and "spill stores" in line:
            assert "0 bytes stack" in line and "0 bytes spill stores" in line, (name, line)
            seen.add(name)
    assert any("flash_fwd_wgILi192ELi128E" in n for n in seen), seen
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    mla = [part for part in sass.split("Function : ")[1:]
           if "flash_fwd_wgILi192ELi128E" in part[:200]]
    assert mla and all("HGMMA" in part and "UTMALDG" in part for part in mla)


def test_mla_layer_at_full_width_on_card_matches_cpu(cuda):
    """One full-width deepseek_v2_lite_16b MLA layer in float32 (d 2048, 16
    heads, latent 512): prefill of 2 x 300 on the card (five tile_matmul
    launches, one flash_attention at (192, 128)) against the CPU's chunked
    twin, output and latent cache at 1e-4; then 3 decode steps over the
    latent cache (three launches each, attention in the latent space)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import blocks as TB
    from repro_torch.models.common import tree_initialize

    lcfg = get_config("deepseek_v2_lite_16b").prefix[0]
    specs = TB.block_specs(2048, lcfg, torch.float32)["attn"]
    plain = tree_initialize(specs, torch.Generator().manual_seed(0), "cpu")
    p = _to(plain, cuda)
    h = _randn((2, 300, 2048), torch.float32, "cpu", 4)
    tm, fa = tm_kernel.tile_matmul, fa_kernel.flash_attention
    before = (tm.launches, fa.launches, dict(fa.paths))
    out, cache = TB.attn_core(p, h.to(cuda), lcfg, want_cache=True)
    assert (tm.launches - before[0], fa.launches - before[1]) == (5, 1)
    assert fa.paths["ffma"] == before[2]["ffma"] + 1
    ref, ref_cache = TB.attn_core(plain, h, lcfg, want_cache=True, q_chunk=128, kv_chunk=128)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)
    big = {k: torch.zeros((2, 320, v.shape[-1])) for k, v in ref_cache.items()}
    for k in big:
        big[k][:, :300] = ref_cache[k]
        torch.testing.assert_close(cache[k].cpu(), ref_cache[k], rtol=1e-4, atol=1e-4)
    big_cuda = _to(big, cuda)
    for step in range(3):
        x = _randn((2, 2048), torch.float32, "cpu", 10 + step)
        launches = tm.launches
        got, big_cuda = TB._attn_decode_core(p, x.to(cuda), big_cuda, 300 + step, lcfg)
        assert tm.launches - launches == 3
        want, big = TB._attn_decode_core(plain, x, big, 300 + step, lcfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in big:
        torch.testing.assert_close(big_cuda[k].cpu(), big[k], rtol=1e-4, atol=1e-4)


# (the one-key case has no gradient to hold: dS = P (dP - Dv) is zero there,
# and so is the limit)
@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap",
                         FLASH_WG_EDGE_CASES + FLASH_WG_SHORT_CASES[1:])
def test_flash_attention_backward_d80_edges_match_plain(cuda, bh, g, tq, tk, causal, window,
                                                        softcap):
    """The same shapes through the D = 80 wgmma backward kernels (32-byte
    boxes, the dK/dV warpgroups' walks summed in order, tiles left
    unmasked) against the explicit formula, each element within
    ``_flash_bwd_limit``; two launches on mma, the same bits."""
    q = _randn((bh, g, tq, 80), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, 80), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, 80), torch.bfloat16, cuda, 3)
    do = _randn((bh, g, tq, 80), torch.bfloat16, cuda, 4)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    _took_twice(fa_kernel.flash_attention_bwd, before)
    _assert_attention_grads_close(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw),
                                  torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("bh,g,tq,tk,causal,window,softcap",
                         FLASH_WG_EDGE_CASES + FLASH_WG_SHORT_CASES[1:])
def test_flash_attention_backward_d128_edges_match_plain(cuda, bh, g, tq, tk, causal, window,
                                                         softcap):
    """The same shapes through the D = 128 wgmma backward kernels
    (``flash_bwd_dq_wgmma<128>`` and ``flash_bwd_dkv_wgmma<128>``: two
    128-byte swizzle atoms a row, one warpgroup a dK/dV block owning both
    accumulators, tiles left unmasked) against the explicit formula, each
    element within ``_flash_bwd_limit``; two launches on mma, the same
    bits."""
    q = _randn((bh, g, tq, 128), torch.bfloat16, cuda, 1)
    k = _randn((bh, tk, 128), torch.bfloat16, cuda, 2)
    v = _randn((bh, tk, 128), torch.bfloat16, cuda, 3)
    do = _randn((bh, g, tq, 128), torch.bfloat16, cuda, 4)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    _took_twice(fa_kernel.flash_attention_bwd, before)
    _assert_attention_grads_close(grads, flash_attention_bwd_ref(q, k, v, o, do, lse, **kw),
                                  torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("bh,tq,tk,softcap", [
    (128, 1024, 1024, 0.0),     # qwen2_moe_a2_7b's layer: 8 x 16 heads, G 1
    (16, 1000, 1000, 30.0),     # a causal ragged tail (1000 = 15 x 64 + 40), a softcap
    (16, 777, 1000, 0.0),       # q_offset 223: the band starts inside a key tile
])
def test_flash_attention_backward_d128_at_qwen2_shape_matches_plain(cuda, bh, tq, tk, softcap):
    """qwen2_moe_a2_7b's training attention, q (128, 1, 1024, 128) causal,
    and ragged variants through the D = 128 wgmma kernels, per element
    within ``_flash_bwd_limit`` of the explicit formula (in slices of 16
    heads), on the mma path, the same bits twice."""
    q = _randn((bh, 1, tq, 128), torch.bfloat16, cuda, 5)
    k = _randn((bh, tk, 128), torch.bfloat16, cuda, 6)
    v = _randn((bh, tk, 128), torch.bfloat16, cuda, 7)
    do = _randn((bh, 1, tq, 128), torch.bfloat16, cuda, 8)
    kw = dict(causal=True, softcap=softcap, q_offset=tk - tq)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    before = dict(fa_kernel.flash_attention_bwd.paths)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    _took_twice(fa_kernel.flash_attention_bwd, before)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for i in range(0, bh, 16):
        sl = slice(i, i + 16)
        _assert_attention_grads_close(
            [t[sl] for t in grads],
            flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], **kw),
            torch.bfloat16)


def test_flash_attention_backward_limit_catches_a_dropped_tile_pair_at_danube_shape(
        cuda, monkeypatch):
    """One batch x kv-head slice of h2o_danube_1_8b's training attention, q
    (1, 4, 8192, 80), window 4096: the D = 80 kernels' gradients are within
    ``_flash_bwd_limit`` of the explicit formula, and the formula with one
    64 x 64 tile pair in the middle of the band masked out (what a kernel
    that skipped it would give) is not."""
    from repro_torch.kernels.flash_attention import ref as ref_mod
    g, t, d, window = 4, 8192, 80, 4096
    q = _randn((1, g, t, d), torch.bfloat16, cuda, 1)
    k = _randn((1, t, d), torch.bfloat16, cuda, 2)
    v = _randn((1, t, d), torch.bfloat16, cuda, 3)
    do = _randn((1, g, t, d), torch.bfloat16, cuda, 4)
    o, lse = fa_kernel.flash_attention(q, k, v, window=window, return_lse=True)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    refs = flash_attention_bwd_ref(q, k, v, o, do, lse, window=window)
    _assert_attention_grads_close(grads, refs, torch.bfloat16)
    # the middle row tile, and the key tile in the middle of what its first query sees
    r0 = (g * t // 2) // 64 * 64
    pos = r0 // g
    c0 = (pos - min(window, pos + 1) // 2) // 64 * 64
    rr = torch.arange(t, device=cuda)[None, :] * g + torch.arange(g, device=cuda)[:, None]
    kv = torch.arange(t, device=cuda)
    drop = (((rr >= r0) & (rr < r0 + 64))[:, :, None]
            & ((kv >= c0) & (kv < c0 + 64))[None, None, :])[None]
    scores = ref_mod._scores

    def dropped(*a, **kw):
        s, cap, mask = scores(*a, **kw)
        return torch.where(drop, ref_mod.NEG_INF, s), cap, mask

    monkeypatch.setattr(ref_mod, "_scores", dropped)
    planted = ref_mod.flash_attention_bwd_ref(q, k, v, o, do, lse, window=window)
    for bad, want in zip(planted, refs):
        diff = (bad.float() - want.float()).abs()
        assert not bool((diff <= _flash_bwd_limit(want.float(), torch.bfloat16)).all())


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
    # float32 through mma; D = 48, or a (D, Dv) pair no kernel takes,
    # through either; the reduced deepseek pair (24, 16) in bf16 through mma
    args = [q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(), o.data_ptr(),
            lse.data_ptr()] + [t.data_ptr() for t in g] + [dvec.data_ptr()]
    lib = fa_kernel._lib_bwd()
    assert lib(*args, 1, 1, 16, 16, 64, 64, 0, 1, 0, 0.0, 0, 0.125, 0, stream) == 1
    for path in (0, 1):
        assert lib(*args, 1, 1, 16, 16, 48, 48, 0, 1, 0, 0.0, 0, 0.125, path, stream) == 1
        assert lib(*args, 1, 1, 16, 16, 192, 192, 0, 1, 0, 0.0, 0, 0.125, path, stream) == 1
        assert lib(*args, 1, 1, 16, 16, 64, 16, 0, 1, 0, 0.0, 0, 0.125, path, stream) == 1
    assert lib(*args, 1, 1, 16, 16, 24, 16, 1, 1, 0, 0.0, 0, 0.125, 0, stream) == 1


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


# ------------------------------------------ the wire, the process fleet, the MoE
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.bool])
def test_a_cuda_tensor_crosses_the_wire_onto_the_readers_device(cuda, dtype):
    """Encoded from the card as host bytes, decoded onto the card (and onto
    the CPU): the same dtype, shape and bits; a non-contiguous and a 0-d
    tensor too."""
    from repro_torch.core.space.wire import decode_msg, encode_segments

    x = (_randn((6, 10), torch.float32, cuda, 70) * 4).to(dtype)
    for t in (x, x[:, ::3], x[2, 3]):
        body = b"".join(bytes(s) for s in encode_segments((1, "ok", {"v": t}))[1:])
        for dev in (cuda, torch.device("cpu")):
            got = decode_msg(body, dev)[2]["v"]
            assert got.device.type == dev.type and got.dtype == t.dtype
            assert got.shape == t.shape and torch.equal(got.cpu(), t.cpu())


def test_cuda_tensors_round_trip_a_remote_space_exactly(cuda):
    """A remote space on a private CPU server: what the card puts comes back
    on the card, bit for bit, through a checked, sharded server stack."""
    from repro_torch.core.space import TupleSpace, make_backend

    ts = TupleSpace(backend=make_backend("remote+checked+sharded:4", device="cuda"))
    try:
        sent = {("w", 0): _randn((64, 48), torch.float32, cuda, 71),
                ("w", 1): _randn((32, 40), torch.bfloat16, cuda, 72)}
        for k, v in sent.items():
            ts.put(k, v)
        for k, v in sent.items():
            got = ts.read(k)[1]
            assert got.is_cuda and got.dtype == v.dtype and torch.equal(got, v)
            assert ts.get(k)[1].is_cuda
    finally:
        ts.backend.close()


def _fleet_run(fleet: str, **kw):
    from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, LayerSpec

    cfg = dict(layers=[LayerSpec(64, 64), LayerSpec(64, 1)], n_handlers=2, epochs=1,
               n_samples=6, task_cap=64.0, pouch_size=50, lr=0.05, time_scale=1e-6,
               initial_timeout=0.2, wall_limit=240.0, seed=0, ts_backend="checked+sharded:4",
               fault_plan=FaultPlan(interval=1e9), fleet=fleet)
    cloud = ACANCloud(CloudConfig(**(cfg | kw)))
    try:
        res = cloud.run()
        assert res.ledger_ok and res.ts_violations == 0 and res.ts_leaks == {}
        return ([l for _, l in res.loss_history],
                [cloud.ts.try_read((n, l))[1] for l in range(2) for n in "wb"], res)
    finally:
        if hasattr(cloud.ts.backend, "close"):
            cloud.ts.backend.close()


def test_the_process_fleet_on_the_card_gives_the_thread_fleets_bits(cuda):
    """Two worker processes on the card over the cloud's embedded server:
    the thread fleet's losses and weights bit for bit, the weights on the
    card; every tile_matmul launch happened in a worker (the result's
    worker counts hold them, the cloud's counters none)."""
    base_losses, base_w, _ = _fleet_run("thread")
    before = tm_kernel.tile_matmul.launches
    losses, w, res = _fleet_run("process")
    assert tm_kernel.tile_matmul.launches == before
    assert losses == base_losses
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(w, base_w))
    counts = res.worker_launches
    assert counts["workers"] >= 1 and counts["tile_matmul"]["launches"] > 0
    paths = counts["tile_matmul"]["paths"]
    assert paths["skinny"] > 0 and paths["wgmma"] == paths["mma"] == 0


def test_a_cuda_cloud_on_a_remote_space_runs_its_products_on_the_card(cuda):
    """A cloud on the card over ``remote+checked+sharded:4`` (a private
    server on the CPU): its client rebuilds what it reads on the card, so
    the handlers' products launch tile_matmul, and the run gives the bits
    of the same cloud on ``checked+sharded:4``, its weights on the card."""
    base_losses, base_w, _ = _fleet_run("thread")
    before = dict(tm_kernel.tile_matmul.paths)
    losses, w, _ = _fleet_run("thread", ts_backend="remote+checked+sharded:4")
    launched = {q: n - before[q] for q, n in tm_kernel.tile_matmul.paths.items()}
    assert launched["skinny"] > 0 and launched["wgmma"] == launched["mma"] == 0, launched
    assert losses == base_losses
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(w, base_w))


def test_a_worker_asked_for_a_missing_card_exits_and_says_why(cuda):
    """``--device cuda:<n>`` past the host's last card: the worker exits
    non-zero before it connects anywhere, naming the device."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    bad = f"cuda:{torch.cuda.device_count()}"
    res = subprocess.run([sys.executable, "-m", "repro_torch.core.workers", "--addr",
                          "127.0.0.1:9", "--device", bad], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode != 0
    assert "cuda" in res.stderr.lower()


def test_a_moe_task_has_the_same_bits_alone_and_in_its_batch(cuda):
    """Round 0 of the MoE program on the card: each route, expert-forward
    and expert-gradient task run alone gives the bits it gave in its
    handler batch, and the ops match the CPU's at 2e-4."""
    from repro_torch.core.executor import ExecContext, TaskExecutor
    from repro_torch.core.program import GLOBAL_OPS
    from repro_torch.core.space import TupleSpace
    from repro_torch.programs.moe import MoERoutingProgram

    spaces = {}
    for dev in ("cpu", "cuda"):
        prog = MoERoutingProgram(steps=2, seed=0, device=dev)
        ts = spaces[dev] = TupleSpace()
        prog.setup(ts)
    prog = MoERoutingProgram(steps=2, seed=0, device="cpu")
    cpu = spaces["cpu"]
    TaskExecutor(cpu).execute_batch(prog.stage_tasks(cpu, 0, "route"))
    prog._combine_route(cpu, 0)

    def parts(stage):
        return [p for t in prog.stage_tasks(cpu, 0, stage) for p in GLOBAL_OPS.partition(t, 256.0)]

    for e in range(prog.E):
        TaskExecutor(cpu).execute_batch(parts(f"expert_{e}"))
    prog._combine_expert(cpu, 0, 0)
    card = spaces["cuda"]
    for k, v in cpu.snapshot().items():
        card.put(k, _to(v, cuda))
    groups = [parts("route")] + [g for e in range(prog.E) for stage in ("expert", "grad")
                                 if (g := parts(f"{stage}_{e}"))]
    for group in groups:
        body = GLOBAL_OPS.resolve(group[0].op).batch_fn
        got = dict(body(ExecContext(card), group))
        want = dict(body(ExecContext(cpu), group))
        for k, v in got.items():
            flat = v if isinstance(v, dict) else {"": v}
            ref = want[k] if isinstance(v, dict) else {"": want[k]}
            for f, x in flat.items():
                assert x.is_cuda
                torch.testing.assert_close(x.cpu(), ref[f], rtol=0, atol=TOL[torch.float32])
        for t in group:
            for k, v in body(ExecContext(card), [t]):
                flat = v if isinstance(v, dict) else {"": v}
                ref = got[k] if isinstance(v, dict) else {"": got[k]}
                assert all(torch.equal(x, ref[f]) for f, x in flat.items()), k


FRONTEND_PRODUCTS = [  # (m, k, n, activation, bias): one layer's products of the two frontends
    (4096, 1536, 6144, "gelu", True),    # musicgen_medium's FFN up, prefill (wgmma)
    (4096, 6144, 1536, "none", True),    # its FFN down
    (8, 1536, 6144, "gelu", True),       # the same in decode (skinny)
    (8, 6144, 1536, "none", True),
    (4096, 8192, 28672, "silu", False),  # internvl2_76b's gate, prefill
    (4096, 28672, 8192, "none", False),  # its down
    (8, 8192, 28672, "silu", False),     # the same in decode
    (8, 28672, 8192, "none", False),
]


@pytest.mark.parametrize("m,k,n,act,bias", FRONTEND_PRODUCTS)
def test_tile_matmul_frontend_products_match_plain(cuda, m, k, n, act, bias):
    """musicgen's bias + GELU epilogue and internvl2's K and N 28672, bf16,
    on the path the served products take (wgmma at M 4096, skinny at M 8),
    against the plain version; a second launch gives the same bits."""
    x = _randn((m, k), torch.bfloat16, cuda, m + k)
    w = _randn((k, n), torch.bfloat16, cuda, n, k ** -0.5)
    b = _randn((n,), torch.bfloat16, cuda, 7) if bias else None
    path = "wgmma" if m > tm_kernel.SKINNY_MAX_M else "skinny"
    before = dict(tm_kernel.tile_matmul.paths)
    out = tm_kernel.tile_matmul(x, w, b, activation=act)
    again = tm_kernel.tile_matmul(x, w, b, activation=act)
    after = tm_kernel.tile_matmul.paths
    assert {p: after[p] - before[p] for p in after} == {p: 2 * int(p == path) for p in after}
    assert torch.equal(out, again)
    ref = tile_matmul_ref(x, w, b, activation=act)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,d", [(48, 1, 64),    # musicgen_medium's MHA: G 1, D 64
                                    (16, 8, 128)])  # internvl2_76b's GQA: G 8, D 128
def test_flash_attention_frontend_shapes_match_plain(cuda, bh, g, d, dtype):
    """The frontends' prefill attention (2 sequences of 512 tokens, causal)
    on the path its dtype takes (bf16: mma, the D 128 one on wgmma;
    float32: ffma), each element within ``_flash_limit``, the lse too; two
    launches give the same bits."""
    q = _randn((bh, g, 512, d), dtype, cuda, 1)
    k = _randn((bh, 512, d), dtype, cuda, 2)
    v = _randn((bh, 512, d), dtype, cuda, 3)
    ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True)
    before = dict(fa_kernel.flash_attention.paths)
    out, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    again = fa_kernel.flash_attention(q, k, v)
    _took_twice(fa_kernel.flash_attention, before,
                "mma" if dtype == torch.bfloat16 else "ffma")
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= _flash_limit(ref.float(), dtype)).all()), diff.max().item()
    torch.testing.assert_close(lse, ref_lse, rtol=2e-4, atol=2e-4)
    assert torch.equal(out, again)


@pytest.mark.parametrize("arch", ["musicgen_medium", "internvl2_76b"])
def test_frontend_decode_step_on_the_card_matches_cpu(cuda, arch):
    """Reduced musicgen (codebooks: a (B, T, 4) prompt, then a (B, 4) token)
    and internvl2 (embeds: a (B, T, d) prompt, then a (B, d) embedding),
    float32: prefill and one decode step on the card against the CPU's,
    logits at 1e-4, every product a tile_matmul launch."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import pick, prompt_inputs, rehome, step_inputs
    from repro_torch.models import model as M
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompt = prompt_inputs(cfg, rng, 3, 20, "cpu")
    cache, logits = M.prefill(params, cfg, prompt)
    cache = rehome(M.init_cache(cfg, 3, 24, "cpu"), cache)
    step = step_inputs(cfg, pick(cfg, logits, True, None), rng, "cpu") | {"cur_len": 20}
    want, _ = M.decode_step(params, cfg, cache, step)
    gparams = _to(params, cuda)
    gcache, glogits = M.prefill(gparams, cfg, _to(prompt, cuda))
    gcache = rehome(M.init_cache(cfg, 3, 24, cuda), gcache)
    torch.testing.assert_close(glogits.cpu(), logits, rtol=1e-4, atol=1e-4)
    before = tm_kernel.tile_matmul.launches
    got, _ = M.decode_step(gparams, cfg, gcache, _to(step, cuda))
    per_layer = sum(t.dim() == 2 for t in gparams["period"][0][0]["attn"].values()) + \
        sum(t.dim() == 2 for t in gparams["period"][0][0]["ffn"].values())
    assert tm_kernel.tile_matmul.launches == before + per_layer * cfg.n_layers
    assert got.shape == (3, cfg.head_width)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["musicgen_medium", "internvl2_76b"])
def test_reduced_frontend_serve_on_cuda_matches_cpu(cuda, arch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    quiet = dict(seed=0, gen=8, log=lambda _: None)
    on_cpu = serve(arch, device="cpu", params=params, **quiet)
    on_gpu = serve(arch, device=cuda, params=_to(params, cuda), **quiet)
    np.testing.assert_array_equal(on_gpu["tokens"], on_cpu["tokens"])


# jamba_1_5_large_398b: 16 experts of d_ff 24576 at d 8192. Each expert
# weight tensor holds 16 x 8192 x 24576 = 3.22 B elements, past 2^31; the
# last expert's starts at element 3.02 B, so its offsets need 64 bits.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(8192, 24576), (24576, 8192)])
def test_tile_matmul_batched_past_2_31_weight_elements_reads_the_last_expert(cuda, k, n, dtype):
    """jamba's gate / up (K 8192, N 24576) and down (K 24576, N 8192)
    weights, 16 rows an expert (a decode step's): the first, the second to
    last and the last expert against their plain products; each expert's
    weights differ, so an offset that wrapped would read another's."""
    e, m = 16, 16
    w = torch.empty((e, k, n), dtype=dtype, device=cuda)
    assert w.numel() > 2 ** 31 and (e - 1) * k * n > 2 ** 31
    w.normal_(0.0, k ** -0.5, generator=torch.Generator(device=cuda).manual_seed(1))
    x = _randn((e, m, k), dtype, cuda, 2)
    fn = tm_kernel.tile_matmul
    before, layouts = dict(fn.paths), dict(fn.layouts)
    out = tm_kernel.tile_matmul(x, w)
    path = "wgmma" if dtype == torch.bfloat16 else "ffma"
    assert {p: fn.paths[p] - before[p] for p in fn.paths} == {
        p: int(p == path) for p in tm_kernel.PATH_CODES}
    assert fn.layouts["batched"] == layouts["batched"] + 1
    for i in (0, e - 2, e - 1):
        torch.testing.assert_close(out[i].float(), tile_matmul_ref(x[i], w[i]).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype], msg=lambda s, i=i: f"{i}: {s}")
    assert not torch.equal(out[e - 1], out[e - 2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_at_jamba_heads_and_groups_matches_plain(cuda, dtype):
    """jamba's Mamba mixer: 256 heads of 64 in 8 groups (32 heads a group),
    N 128, over two chunks and a ragged third."""
    args = _ssd_inputs(1, 300, 256, 64, 8, 128, dtype, cuda, seed=31)
    before = dict(ssd_kernel.ssd_scan.paths)
    y, s = ssd_kernel.ssd_scan(*args)
    path = "mma" if dtype == torch.bfloat16 else "ffma"
    assert {p: ssd_kernel.ssd_scan.paths[p] - before[p] for p in before} == {
        p: int(p == path) for p in ssd_kernel.PATH_CODES}
    yr, sr = ssd_plain(*args)
    ytol = 1e-3 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), rtol=ytol, atol=ytol)
    torch.testing.assert_close(s, sr, rtol=1e-3, atol=1e-3)


def test_reduced_jamba_serve_on_cuda_matches_cpu_and_counts_every_launch(cuda):
    """Reduced jamba (float32; 2 periods of attention + dense, Mamba + MoE,
    Mamba + dense, Mamba + MoE) served on the card: the CPU's tokens, and
    per forward pass 36 tile_matmul launches a period (4 attention, 18
    Mamba, 6 dense FFN, 2 routers, 6 batched expert launches), none on
    wgmma or mma; one flash_attention an attention layer and one ssd_scan a
    Mamba layer, in prefill only, on ffma."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    arch, gen = "jamba_1_5_large_398b", 6
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    quiet = dict(batch=2, prompt_len=32, gen=gen, cache_len=38, seed=0, log=lambda _: None)
    on_cpu = serve(arch, device="cpu", params=params, **quiet)
    gparams = _to(params, cuda)
    counters = (tm_kernel.tile_matmul, fa_kernel.flash_attention, ssd_kernel.ssd_scan)
    before = [dict(fn.paths) for fn in counters]
    batched = tm_kernel.tile_matmul.layouts["batched"]
    on_gpu = serve(arch, device=cuda, params=gparams, **quiet)
    np.testing.assert_array_equal(on_gpu["tokens"], on_cpu["tokens"])
    tm, fa, ss = ({p: fn.paths[p] - b[p] for p in b} for fn, b in zip(counters, before))
    assert sum(tm.values()) == 36 * cfg.n_periods * (1 + gen), tm
    assert tm["wgmma"] == tm["mma"] == 0, tm
    assert tm_kernel.tile_matmul.layouts["batched"] - batched == 6 * cfg.n_periods * (1 + gen)
    assert fa == {"mma": 0, "ffma": cfg.n_periods}
    assert ss == {"mma": 0, "ffma": 3 * cfg.n_periods}
