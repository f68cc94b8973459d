"""Hopper flash_attention: causal GQA FlashAttention-2 forward in CUDA C++
(``csrc/flash_attention.cu``), bound through ``ctypes``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
:: ``flash_attention`` (body ``_kernel``). The TPU kernel's sequential KV
grid axis becomes a loop inside each block, which owns one
(batch·kv-head, 64-row tile) with the G query heads of a KV head folded into
its rows, so every K/V tile is read once for all G heads. KV tiles outside
the causal/window band are skipped; ragged Tq/Tkv tails are masked.

``choose_path`` picks one of two kernels, and the C entry point takes it
as an int (it returns an error for a path the inputs cannot take; it never
switches):

- ``mma``: bf16 with 16-byte aligned q, k, v and output (every serving
  prefill). Both products on bf16 tensor cores (``mma.sync.m16n8k16``),
  Q and P in registers, K/V tiles in a two-stage ``cp.async`` ring.
- ``ffma``: float32, for the 2e-4 parity runs, and bf16 the ``mma`` path
  cannot take. True float32 FFMA.

``flash_attention.launches`` counts launches; ``flash_attention.paths``
counts them per path. The source's header says what bounds each on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"mma": 0, "ffma": 1}
HEAD_DIMS = (16, 32, 64, 128)


def choose_path(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The kernel for attention of head dim ``d`` in ``dtype``; ``aligned``:
    q, k, v and the output start on 16-byte boundaries. Mirrors
    ``path_fits`` in ``csrc/flash_attention.cu``."""
    if d not in HEAD_DIMS or dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention takes D in {HEAD_DIMS} in float32 or "
                         f"bfloat16; got D {d}, {dtype}")
    return "mma" if dtype == torch.bfloat16 and aligned else "ffma"


@functools.cache
def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, path: str | None = None) -> torch.Tensor:
    """q: (BH, G, Tq, D); k, v: (BH, Tkv, D) → (BH, G, Tq, D), on CUDA.
    ``path`` overrides ``choose_path`` (the C side refuses a path the
    inputs cannot take). Raises on anything the kernel does not take."""
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    path = path or choose_path(q.dtype, D, all(p % 16 == 0 for p in ptrs))
    err = _lib()(*ptrs, BH, G, Tq, Tkv, D, DTYPE_CODES[q.dtype], int(causal),
                 int(window), float(softcap), int(q_offset), 1.0 / D ** 0.5,
                 PATH_CODES[path],
                 # the current stream's handle, without building a Stream object
                 torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err:
        raise RuntimeError(f"flash_attention launch failed ({path} path): "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.paths[path] += 1
    return out


flash_attention.launches = 0
flash_attention.paths = dict.fromkeys(PATH_CODES, 0)
