"""Hopper ssd_scan: the Mamba-2 SSD chunked scan in CUDA C++
(``csrc/ssd_scan.cu``), bound through ``ctypes``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/kernel.py`` ::
``ssd_scan`` (body ``_kernel``). The TPU kernel's sequential chunk axis,
with the state in VMEM scratch, becomes a loop over chunks inside one block
per (batch, head), the float32 state kept in shared memory throughout. The
kernel takes the model's ``(Bt, T, H, P)`` layout and grouped B/C directly
(head ``h`` reads group ``h // (H / G)``), so neither the reference
wrapper's transposes nor its ``jnp.repeat`` of B/C are materialised, and it
masks a ragged last chunk itself, so any T is taken. The source's header
says what bounds it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = _build.load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, d: torch.Tensor):
    """x: (Bt, T, H, P); dt: (Bt, T, H) float32; a, d: (H,) float32;
    b, c: (Bt, T, G, N) in x's dtype. Returns (y (Bt, T, H, P) in x's dtype,
    final_state (Bt, H, N, P) float32), on CUDA. Raises on anything the
    kernel does not take."""
    if not all(t.is_cuda for t in (x, dt, a, b, c, d)):
        raise ValueError("ssd_scan kernel needs CUDA tensors")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    Bt, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (b.shape[:2] != (Bt, T) or dt.shape != (Bt, T, H) or a.shape != (H,)
            or d.shape != (H,) or H % G):
        raise ValueError(f"need dt (Bt, T, H), a, d (H,), b, c (Bt, T, G, N) with "
                         f"G dividing H; got x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, d {tuple(d.shape)}, b {tuple(b.shape)}")
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"dtypes x {x.dtype}, b {b.dtype}, c {c.dtype}: need all "
                         "float32 or all bfloat16")
    if not (dt.dtype == a.dtype == d.dtype == torch.float32):
        raise ValueError("dt, a and d must be float32")
    if not all(t.is_contiguous() for t in (x, dt, a, b, c, d)):
        raise ValueError("ssd_scan kernel needs contiguous inputs")
    y = torch.empty_like(x)
    state = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state.zero_()
    err = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 d.data_ptr(), y.data_ptr(), state.data_ptr(), Bt, T, H, G, N, P,
                 DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
