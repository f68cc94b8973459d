"""Hopper tile_matmul: ``x (M, K) @ w (K, N)`` with a float32 accumulator
and a fused ``+ b`` / activation / cast epilogue, in CUDA C++
(``csrc/tile_matmul.cu``), bound through ``ctypes``.

Replaces the Pallas TPU kernel ``repro/kernels/tile_matmul/kernel.py``
:: ``tile_matmul`` (body ``_kernel``). The TPU kernel walks a sequential
``(M/bm, N/bn, K/bk)`` grid and carries the accumulator in VMEM across K
steps; here each block owns its outputs and walks its K range in one fixed
order (no atomics: deterministic), with tiles, BK and the K order set by
(N, K) only (batch-invariant within a path). No shape is refused for
divisibility.

``choose_path`` picks one of four kernels, and the C entry point takes it
as an int (it returns an error for a path the shape cannot take; it never
switches):

- ``wgmma``: bf16 at M > 16 (prefill), bound by operations. A TMA +
  ``wgmma`` pipeline: a producer warp keeps a four-stage ring of 128 x BN
  x 64 tiles in flight, two consumer warpgroups multiply out of it, ``w``
  is read in its (K, N) layout through the ``wgmma`` transpose bit, and
  TMA zero-fills the edges. TMA needs 16-byte row strides and pointers,
  so K and N multiples of 8 and x, w 16-byte aligned: every serving
  projection.
- ``mma``: the bf16 shapes TMA cannot address (the GPU tests'
  ``(257, 40, 20)``), ``mma.sync`` from one masked shared tile.
- ``skinny``: M <= 16 (decode), bound by bytes. 16-byte weight loads, a
  warp up to 512 contiguous bytes of a row, the next batch of rows in
  flight while the current one is multiplied, x staged in shared memory;
  K split over a cluster of up to 8 blocks whose partials are summed in
  rank order through distributed shared memory; one wave of blocks. bf16
  and float32 alike; needs 16-byte weight rows and pointers.
- ``ffma``: float32 at M > 16, true float32 FFMA for the 2e-4 parity
  runs (never TF32).

Training's gradient products read an operand transposed where it lies
(``trans_x`` / ``trans_w``, at most one): ``dx = dz @ w^T`` reads w as
wgmma's K-major B, ``dw = x^T @ dz`` reads x as its MN-major A, and the
``ffma`` kernel takes both. ``mma`` and ``skinny`` take only the plain
layout; no training shape reaches them.

Given a leading expert axis, ``x (E, M, K) @ w (E, K, N)`` (no bias),
``tile_matmul`` multiplies every expert in one launch of the ``wgmma``
(bf16) or ``ffma`` (float32) kernel with the expert on the grid's z axis: a
MoE layer's expert products, which the reference writes as einsums outside
its Pallas kernel. Their gradients take the two transposed layouts batched,
each operand read where it lies: ``dx = dz @ w^T`` (w stored (E, K, N) read
as (E, N, K)'s transpose) and ``dw = x^T @ dz`` (x stored (E, M, K)). These
launches count under the layouts ``batched``, ``batched x@w^T`` and
``batched x^T@w``.

``tile_matmul.launches`` counts launches; ``tile_matmul.paths`` counts
them per path, ``tile_matmul.layouts`` per layout and
``tile_matmul.outputs`` per operand and output type (``"bfloat16->float32"``
is the float32 ``z`` that a bf16 product's backward launches for its fused
activation; no forward of a bf16 model writes float32).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _count

ACT_CODES = {"none": 0, "tanh": 1, "relu": 2, "silu": 3, "gelu": 4}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"wgmma": 0, "mma": 1, "skinny": 2, "ffma": 3}
# x @ w, x @ w^T (w stored (N, K)), x^T @ w (x stored (K, M)): enum Layout.
LAYOUT_CODES = {"x@w": 0, "x@w^T": 1, "x^T@w": 2}
SKINNY_MAX_M = 16


def layout_of(trans_x: bool, trans_w: bool) -> str:
    if trans_x and trans_w:
        raise ValueError("tile_matmul transposes at most one operand")
    return "x^T@w" if trans_x else "x@w^T" if trans_w else "x@w"


def choose_path(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool,
                layout: str = "x@w", batched: bool = False) -> str:
    """The kernel for an ``(m, k) @ (k, n)`` product of ``dtype`` with its
    operands as ``layout`` says, or for one such product an expert where
    ``batched`` (wgmma or ffma only); ``aligned``: x and w start on 16-byte
    boundaries. Mirrors ``path_fits`` in ``csrc/tile_matmul.cu``."""
    row_bytes = n * (2 if dtype == torch.bfloat16 else 4)
    plain = layout == "x@w"
    if m <= SKINNY_MAX_M and row_bytes % 16 == 0 and aligned and plain and not batched:
        return "skinny"
    if dtype == torch.float32:
        return "ffma"
    # TMA's 16-byte row strides: the stored rows are K long, x^T's M long.
    row = m if layout == "x^T@w" else k
    if k > 0 and row % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    if batched or not plain:
        raise ValueError(f"bf16 {'batched ' if batched else ''}{layout} of (M, N, K) = "
                         f"({m}, {n}, {k}) needs the wgmma path: N and the stored row "
                         "length (M for x^T, else K) multiples of 8, 16-byte aligned "
                         "operands")
    return "mma"


@functools.cache
def _lib():
    fn = _build.load("tile_matmul").tile_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                *, activation: str = "none", out_dtype=None, trans_x: bool = False,
                trans_w: bool = False) -> torch.Tensor:
    """``act(x' @ w' + b)`` with ``x' = x.T`` if ``trans_x`` (x stored
    (K, M)) and ``w' = w.T`` if ``trans_w`` (w stored (N, K)); with a
    leading expert axis, ``act(x[e] @ w[e])`` for every e of ``x (E, M, K)``
    and ``w (E, K, N)`` in one launch. Launches the CUDA kernel on CUDA
    tensors; raises on anything else. Batched, ``trans_x`` / ``trans_w``
    read each expert's operand transposed as in the 2-D product."""
    if not (x.is_cuda and w.is_cuda and (b is None or b.is_cuda)):
        raise ValueError("tile_matmul kernel needs CUDA tensors")
    layout = layout_of(trans_x, trans_w)
    batched = x.dim() == 3
    if (x.dim(), w.dim()) not in ((2, 2), (3, 3)) or batched and (
            len(x) != len(w) or b is not None):
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)} ({layout}"
                         f"{', with a bias' if b is not None else ''})")
    M, K = x.shape[-2:][::-1] if trans_x else x.shape[-2:]
    Kw, N = w.shape[-2:][::-1] if trans_w else w.shape[-2:]
    if K != Kw:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)} ({layout})")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: need both float32 "
                         "or both bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tile_matmul kernel needs contiguous x and w")
    if b is not None and (b.shape != (N,) or b.dtype != x.dtype
                          or not b.is_contiguous()):
        raise ValueError(f"bias must be contiguous ({N},) {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    out = x.new_empty((*x.shape[:-2], M, N), dtype=out_dtype)
    if out.numel() == 0:
        return out
    xp, wp = x.data_ptr(), w.data_ptr()
    path = choose_path(M, N, K, x.dtype, xp % 16 == 0 and wp % 16 == 0, layout, batched)
    err = _lib()(xp, wp, None if b is None else b.data_ptr(), out.data_ptr(),
                 M, N, K, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
                 ACT_CODES[activation], PATH_CODES[path], LAYOUT_CODES[layout],
                 len(x) if batched else 1,
                 # the current stream's handle, without building a Stream
                 # object: a decode step makes hundreds of these calls
                 torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"tile_matmul launch failed ({path} path, {layout}"
                           f"{', batched' if batched else ''}): CUDA error {err}")
    _count.launch(tile_matmul, paths=path, layouts=BATCHED[layout] if batched else layout,
                  outputs=OUTPUTS[x.dtype, out_dtype])
    return out


# The counter key of a batched launch in each layout.
BATCHED = {"x@w": "batched", "x@w^T": "batched x@w^T", "x^T@w": "batched x^T@w"}
tile_matmul.launches = 0
tile_matmul.paths = dict.fromkeys(PATH_CODES, 0)
tile_matmul.layouts = dict.fromkeys((*LAYOUT_CODES, *BATCHED.values()), 0)
# The counter key of each operand and output type.
OUTPUTS = {(a, b): f"{str(a)[6:]}->{str(b)[6:]}" for a in DTYPE_CODES for b in DTYPE_CODES}
tile_matmul.outputs = dict.fromkeys(OUTPUTS.values(), 0)
