"""Hopper tile_matmul: ``x (M, K) @ w (K, N)`` with a float32 accumulator
and a fused ``+ b`` / activation / cast epilogue, in CUDA C++
(``csrc/tile_matmul.cu``), bound through ``ctypes``.

Replaces the Pallas TPU kernel ``repro/kernels/tile_matmul/kernel.py``
:: ``tile_matmul`` (body ``_kernel``). The TPU kernel walks a sequential
``(M/bm, N/bn, K/bk)`` grid and carries the accumulator in VMEM across K
steps; here each block owns one output tile and loops over K itself, so
blocks are independent and the sum over K has one fixed order (no split-K,
no atomics: deterministic and batch-invariant). Ragged M/N/K edges are
masked in the kernel, so no shape is refused for divisibility.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACT_CODES = {"none": 0, "tanh": 1, "relu": 2, "silu": 3, "gelu": 4}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("tile_matmul")
    fn = lib.tile_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tile_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                *, activation: str = "none", out_dtype=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything else."""
    if not (x.is_cuda and w.is_cuda and (b is None or b.is_cuda)):
        raise ValueError("tile_matmul kernel needs CUDA tensors")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: need both float32 "
                         "or both bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tile_matmul kernel needs contiguous x and w")
    M, K = x.shape
    N = w.shape[1]
    if b is not None and (b.shape != (N,) or b.dtype != x.dtype
                          or not b.is_contiguous()):
        raise ValueError(f"bias must be contiguous ({N},) {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    err = _lib()(x.data_ptr(), w.data_ptr(),
                 None if b is None else b.data_ptr(), out.data_ptr(),
                 M, N, K, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
                 ACT_CODES[activation],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"tile_matmul launch failed: CUDA error {err}")
    tile_matmul.launches += 1
    return out


tile_matmul.launches = 0
