"""Hopper ssd_scan: the Mamba-2 SSD chunked scan in CUDA C++
(``csrc/ssd_scan.cu``), bound through ``ctypes``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/kernel.py`` ::
``ssd_scan`` (body ``_kernel``). The TPU kernel's sequential chunk axis,
with the state in VMEM scratch, becomes a loop over chunks inside one block
per (batch, head), the float32 state kept in shared memory throughout. The
kernel takes the model's ``(Bt, T, H, P)`` layout and grouped B/C directly
(head ``h`` reads group ``h // (H / G)``), so neither the reference
wrapper's transposes nor its ``jnp.repeat`` of B/C are materialised, and it
masks a ragged last chunk itself, so any T is taken.

``choose_path`` picks one of two kernels, and the C entry point takes it
as an int (it returns an error for a path the inputs cannot take; it never
switches):

- ``mma``: bf16 with N 64 or 128, P a multiple of 32 and 16-byte aligned
  x, y, B, C (every serving prefill scan). The chunk's products on bf16
  tensor cores (``mma.sync.m16n8k16``), the float32 operands M, S and
  B∘w as bf16 hi + lo pairs, the next chunk loading by ``cp.async``; a
  block a (batch, head, 32 columns of P).
- ``ffma``: float32, for the 1e-3 parity runs, and bf16 shapes the ``mma``
  path cannot take. True float32 FFMA, a block a (batch, head).

``ssd_scan.launches`` counts launches; ``ssd_scan.paths`` counts them per
path. The source's header says what bounds each on the card.

:func:`ssd_scan_bwd` launches the scan's gradient (``csrc/ssd_scan_bwd.cu``:
the chunks walked backward in time by one block a (batch, head), from the
chunk entry states the forward wrote (``chunk_states``), then a second
kernel that sums B's and C's gradients over the heads of a group in a fixed
order; no atomics), with two paths: ``mma`` (bf16, N 64 or 128, P 32 or
64; :func:`choose_bwd_path`) and ``ffma``. ``ssd_scan_bwd.launches`` and
``.paths`` count its calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _count

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"mma": 0, "ffma": 1}
MMA_STATE_DIMS = (64, 128)
MMA_P_SLICE = 32
MMA_BWD_HEAD_DIMS = (32, 64)   # P the backward's mma kernel is built for
CHUNK = 64   # steps in a chunk, both kernels


def choose_path(dtype: torch.dtype, n: int, p: int, aligned: bool) -> str:
    """The kernel for a scan with state dim ``n`` and head dim ``p`` in
    ``dtype``; ``aligned``: x, y, B and C start on 16-byte boundaries.
    Mirrors ``path_fits`` in ``csrc/ssd_scan.cu``."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan takes float32 or bfloat16, not {dtype}")
    if (dtype == torch.bfloat16 and n in MMA_STATE_DIMS and p % MMA_P_SLICE == 0
            and aligned):
        return "mma"
    return "ffma"


def choose_bwd_path(dtype: torch.dtype, n: int, p: int, aligned: bool) -> str:
    """The backward kernel for state dim ``n`` and head dim ``p`` in
    ``dtype``; ``aligned``: x, dy, dx, B and C start on 16-byte boundaries.
    The forward's rule with P in ``MMA_BWD_HEAD_DIMS`` (the mma kernel keeps
    G's rows of P in registers). Mirrors ``path_fits`` in
    ``csrc/ssd_scan_bwd.cu``."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan_bwd takes float32 or bfloat16, not {dtype}")
    if (dtype == torch.bfloat16 and n in MMA_STATE_DIMS and p in MMA_BWD_HEAD_DIMS
            and aligned):
        return "mma"
    return "ffma"


@functools.cache
def _lib():
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_bwd():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, a, b, c, d) -> None:
    """Raises on inputs neither kernel takes: CUDA, shapes, dtypes,
    contiguity."""
    if not all(t.is_cuda for t in (x, dt, a, b, c, d)):
        raise ValueError("ssd_scan kernel needs CUDA tensors")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    Bt, T, H, P = x.shape
    G = b.shape[2]
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


def chunk_states_shape(x: torch.Tensor, b: torch.Tensor) -> tuple[int, ...]:
    """(Bt, H, ceil(T / 64) + 1, N, P): the state entering each chunk, then
    the final state."""
    Bt, T, H, P = x.shape
    return (Bt, H, -(-T // CHUNK) + 1, b.shape[3], P)


def _check_states(states, x, b) -> None:
    if (not states.is_cuda or states.dtype != torch.float32
            or states.shape != chunk_states_shape(x, b) or not states.is_contiguous()):
        raise ValueError(f"chunk states must be contiguous CUDA float32 "
                         f"{chunk_states_shape(x, b)}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, d: torch.Tensor, *, path: str | None = None,
             chunk_states: torch.Tensor | None = None):
    """x: (Bt, T, H, P); dt: (Bt, T, H) float32; a, d: (H,) float32;
    b, c: (Bt, T, G, N) in x's dtype. Returns (y (Bt, T, H, P) in x's dtype,
    final_state (Bt, H, N, P) float32), on CUDA. ``path`` overrides
    ``choose_path`` (the C side refuses a path the inputs cannot take).
    ``chunk_states`` (float32, :func:`chunk_states_shape`), when given, gets
    the state entering each chunk and the final state, as
    :func:`ssd_scan_bwd` reads them. Raises on anything the kernel does not
    take."""
    _check(x, dt, a, b, c, d)
    if chunk_states is not None:
        _check_states(chunk_states, x, b)
    Bt, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        if chunk_states is not None:
            chunk_states.zero_()
        return y, state.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, b, c))
    path = path or choose_path(x.dtype, N, P, aligned)
    err = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 d.data_ptr(), y.data_ptr(), state.data_ptr(),
                 None if chunk_states is None else chunk_states.data_ptr(), Bt, T, H, G, N, P,
                 DTYPE_CODES[x.dtype], PATH_CODES[path],
                 # the current stream's handle, without building a Stream object
                 torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"ssd_scan launch failed ({path} path): CUDA error {err}")
    _count.launch(ssd_scan, paths=path)
    return y, state


ssd_scan.launches = 0
ssd_scan.paths = dict.fromkeys(PATH_CODES, 0)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
                 dstate: torch.Tensor | None, states: torch.Tensor, *,
                 path: str | None = None):
    """Gradients (dx, ddt, da, db, dc, dd) of :func:`ssd_scan` at its inputs
    for the output gradient ``dy`` (x's shape and dtype) and the final-state
    gradient ``dstate`` ((Bt, H, N, P) float32, or None for zero), in the
    inputs' shapes and dtypes, on CUDA. ``states``: the chunk states the
    forward wrote (``ssd_scan(..., chunk_states=states)``), which the kernel
    reads. ``path`` overrides :func:`choose_bwd_path`. Raises on anything
    the kernels do not take."""
    _check(x, dt, a, b, c, d)
    Bt, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if not all(t.is_cuda for t in (dy, dstate) if t is not None):
        raise ValueError("ssd_scan_bwd needs CUDA tensors")
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"need a contiguous dy of x's shape {tuple(x.shape)} and "
                         f"dtype {x.dtype}; got {tuple(dy.shape)} {dy.dtype}")
    if dstate is not None and (dstate.shape != (Bt, H, N, P) or dstate.dtype != torch.float32
                               or not dstate.is_contiguous()):
        raise ValueError(f"need a contiguous float32 dstate ({Bt}, {H}, {N}, {P}); got "
                         f"{tuple(dstate.shape)} {dstate.dtype}")
    _check_states(states, x, b)
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    ddt = torch.empty_like(dt)
    if x.numel() == 0 or b.numel() == 0:
        zeros = torch.zeros_like(a)
        return dx.zero_(), ddt.zero_(), zeros, db.zero_(), dc.zero_(), zeros.clone()
    f32 = dict(dtype=torch.float32, device=x.device)
    da_part, dd_part = torch.empty((Bt, H), **f32), torch.empty((Bt, H), **f32)
    dbp, dcp = torch.empty((Bt, T, H, N), **f32), torch.empty((Bt, T, H, N), **f32)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx, b, c))
    path = path or choose_bwd_path(x.dtype, N, P, aligned)
    ptrs = (x, dt, a, b, c, d, dy, dstate, dx, ddt, da_part, dd_part, dbp, dcp, states, db, dc)
    err = _lib_bwd()(*(None if t is None else t.data_ptr() for t in ptrs),
                     Bt, T, H, G, N, P, DTYPE_CODES[x.dtype], PATH_CODES[path],
                     torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed ({path} path): CUDA error {err}")
    _count.launch(ssd_scan_bwd, paths=path)
    return dx, ddt, da_part.sum(0), db, dc, dd_part.sum(0)


ssd_scan_bwd.launches = 0
ssd_scan_bwd.paths = dict.fromkeys(PATH_CODES, 0)
