"""Hopper flash_attention: causal GQA FlashAttention-2 forward in CUDA C++
(``csrc/flash_attention.cu``), bound through ``ctypes``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
:: ``flash_attention`` (body ``_kernel``). The TPU kernel's sequential KV
grid axis becomes a loop inside each block, which owns one
(batch·kv-head, 64-row tile) with the G query heads of a KV head folded into
its rows, so every K/V tile is read once for all G heads. KV tiles outside
the causal/window band are skipped; ragged Tq/Tkv tails are masked. The
source's header says what bounds it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (BH, G, Tq, D); k, v: (BH, Tkv, D) → (BH, G, Tq, D), on CUDA.
    Raises on anything the kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    BH, G, Tq, D = q.shape
    Tkv = k.shape[1]
    if k.shape[0] != BH or k.shape[2] != D or D not in HEAD_DIMS:
        raise ValueError(f"need k (BH, Tkv, D) with D in {HEAD_DIMS}; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                         "float32, bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, G, Tq, Tkv, D, DTYPE_CODES[q.dtype], int(causal),
                 int(window), float(softcap), int(q_offset), 1.0 / D ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
