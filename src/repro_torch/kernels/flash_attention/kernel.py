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
  prefill). At D = 16, 32 and 64 both products on bf16 tensor cores
  (``mma.sync.m16n8k16``), Q and P in registers, K/V tiles in a two-stage
  ``cp.async`` ring; at D = 80, 128 and 256, and at MLA's (192, 128) pair
  (q and k of head dim 192, v and the output of 128), both on ``wgmma``,
  K/V tiles by TMA into a ring that a producer warpgroup keeps full for consumer
  warpgroups of 64 rows each (:func:`fwd_walks` mirrors their walk; at D 80
  the tiles are 32-byte boxes, as a 160-byte row is no whole number of
  128-byte swizzle rows, and each consumer runs a tile's softmax under the
  last tile's P V).
- ``ffma``: float32, for the 2e-4 parity runs, and bf16 the ``mma`` path
  cannot take (the reduced deepseek config's (24, 16), ``FFMA_PAIRS``). True
  float32 FFMA.

``flash_attention.launches`` counts launches; ``flash_attention.paths``
counts them per path. The source's header says what bounds each on the card.

:func:`flash_attention` also returns each row's log-sum-exp when asked
(``return_lse``), which :func:`flash_attention_bwd` takes with the output to
launch the backward (``csrc/flash_attention_bwd.cu``: a dQ kernel, then a
dK/dV kernel, no atomics), with the forward's two paths: ``mma`` (bf16 on
tensor cores: ``wgmma`` at D = 64, 80, 128, 256 and MLA's (192, 128),
``mma.sync`` at 16 and 32; :func:`bwd_walks` mirrors their walks) and
``ffma`` (float32), at every head dim and pair the forward takes.
``flash_attention_bwd.launches`` and ``.paths`` count its calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _count

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"mma": 0, "ffma": 1}
# Head dims the kernels take with q, k and v of one head dim (80:
# h2o_danube_1_8b, 256: gemma3_12b); the backward takes every one of them.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS
# (head dim of q and k, head dim of v and the output) pairs both directions
# also take: MLA's (deepseek_v2_lite_16b, qk_nope 128 + qk_rope 64, v 128),
# and its reduced config's (16 + 8, 16), which only the ffma path takes
# (``FFMA_PAIRS``).
HEAD_DIM_PAIRS = ((192, 128), (24, 16))
FFMA_PAIRS = ((24, 16),)


def _dims_ok(d: int, dv: int) -> bool:
    return (d == dv and d in HEAD_DIMS) or (d, dv) in HEAD_DIM_PAIRS


def choose_path(dtype: torch.dtype, d: int, aligned: bool, dv: int | None = None) -> str:
    """The kernel for attention of head dim ``d`` (q and k) and ``dv`` (v
    and the output; ``d`` when not given) in ``dtype``, forward and
    backward; ``aligned``: every tensor starts on a 16-byte boundary.
    Mirrors ``path_fits`` in ``csrc/flash_attention.cu`` and
    ``csrc/flash_attention_bwd.cu``."""
    dv = d if dv is None else dv
    if not _dims_ok(d, dv) or dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention takes D in {HEAD_DIMS} or (D, Dv) in "
                         f"{HEAD_DIM_PAIRS} in float32 or bfloat16; got ({d}, {dv}), {dtype}")
    mma = dtype == torch.bfloat16 and aligned and (d, dv) not in FFMA_PAIRS
    return "mma" if mma else "ffma"


_MASK = (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float)


@functools.cache
def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + list(_MASK)
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_bwd():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + list(_MASK)
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


BWD_TILE = 64        # folded rows or keys of a tile in the backward kernels
# BwdWg<D>::DKV_WGS in csrc/flash_attention_bwd.cu: the warpgroups of a wgmma
# dK/dV block at D = 64, 80 and 128 (the other kernels' walks are those of
# 1: the role split at D 256 and MLA's (192, 128) takes every tile in both
# warpgroups)
DKV_WARPGROUPS = {64: 3, 80: 2, 128: 1, (192, 128): 1}
FWD_TILE = 64        # folded rows of a consumer warpgroup of the wgmma forward
# The wgmma forward kernels' blocks by head dim (or (DK, DV) pair): (consumer
# warpgroups, keys of a K/V tile); flash_fwd_wg256, and FwdWg<DK, DV> in
# csrc/flash_attention.cu.
FWD_WG = {80: (3, 64), 128: (2, 64), 256: (2, 64), (192, 128): (2, 64)}
FWD_ROWS = FWD_WG[256][0] * FWD_TILE  # folded rows a block of the D = 256 forward owns


def fwd_walks(G: int, Tq: int, Tkv: int, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, d: int = 256):
    """The key tiles the wgmma forward kernel at head dim ``d`` (a key of
    ``FWD_WG``) computes, as ``flash_fwd_wg256`` and ``flash_fwd_wg<DK, DV>`` in
    ``csrc/flash_attention.cu`` find them: the producer loads every tile of
    a block's band (its rows' keys), and each consumer warpgroup computes
    the run of them its own 64 rows can see and only releases the rest.
    Folded row ``rr = t * G + g`` sits at query position ``q_offset + rr //
    G``.

    Returns ``{r0: [walk of warpgroup 0, walk of warpgroup 1, ...]}`` by
    block, each walk the first key of each tile that warpgroup computes."""
    nc, T = FWD_WG[d]
    R, W, B = G * Tq, FWD_TILE, nc * FWD_TILE
    out = {}
    for r0 in range(0, R, B):
        qmin, qmax = q_offset + r0 // G, q_offset + (min(R, r0 + B) - 1) // G
        kv_end = min(Tkv, qmax + 1) if causal else Tkv
        kv_begin = max(0, qmin - window + 1) // T * T if window > 0 else 0
        ntile = -(-(kv_end - kv_begin) // T) if kv_end > kv_begin else 0
        walks = []
        for rw in range(r0, r0 + B, W):
            qmin_w, qmax_w = q_offset + rw // G, q_offset + (min(R, rw + W) - 1) // G
            end_w = 0 if rw >= R else min(Tkv, qmax_w + 1) if causal else Tkv
            begin_w = max(0, qmin_w - window + 1) if window > 0 else 0
            hi = max(0, min(ntile, -(-(end_w - kv_begin) // T)))
            lo = min(hi, (begin_w - kv_begin) // T)
            walks.append([kv_begin + T * i for i in range(lo, hi)])
        out[r0] = walks
    return out


def fwd_tile_visible(G: int, Tq: int, Tkv: int, rw: int, kv0: int, *, causal: bool = True,
                     window: int = 0, q_offset: int = 0, d: int = 256) -> bool:
    """Whether the wgmma forward's warpgroup of rows ``rw .. rw + 63`` at
    head dim ``d`` computes the key tile at ``kv0`` without its mask (every
    (row, key) pair of its rows below ``G * Tq`` visible), as the kernel
    decides."""
    R, W, T = G * Tq, FWD_TILE, FWD_WG[d][1]
    qmin_w, qmax_w = q_offset + rw // G, q_offset + (min(R, rw + W) - 1) // G
    masked = (kv0 + T > Tkv or (causal and kv0 + T - 1 > qmin_w)
              or (window > 0 and kv0 <= qmax_w - window))
    return not masked


def bwd_tile(d: int, path: str, dv: int | None = None) -> int:
    """Folded rows or keys of a tile of the backward's ``path`` at head dim
    ``d`` (q, k) and ``dv`` (v, the output; ``d`` when not given):
    ``BWD_TILE``, but 32 on the ffma path at D = 256, where four float32
    tiles of 64 rows would not fit a block's shared memory (``ffma_tile`` in
    ``csrc/flash_attention_bwd.cu``: D + Dv above 384)."""
    dv = d if dv is None else dv
    return 32 if path == "ffma" and d + dv > 384 else BWD_TILE


def bwd_walks(G: int, Tq: int, Tkv: int, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, tile: int = BWD_TILE, warpgroups: int = DKV_WARPGROUPS[64]):
    """The tiles the backward kernels walk, as ``csrc/flash_attention_bwd.cu``
    computes them (all of its kernels share the band arithmetic), at tiles
    of ``tile`` (:func:`bwd_tile`). Folded row ``rr = t * G + g`` sits at
    query position ``q_offset + rr // G``.

    Returns ``(dq, dkv)``: ``dq[r0]``, the first key of each key tile the dQ
    kernel's block of rows ``r0 .. r0 + tile - 1`` walks; ``dkv[kv0][w]``,
    the first row of each row tile that warpgroup ``w`` of the dK/dV block
    of keys ``kv0 .. kv0 + tile - 1`` walks (every ``warpgroups``-th tile of
    the band, from tile ``w``: ``DKV_WARPGROUPS``; at D = 128 one
    warpgroup walks the band whole). The dK/dV kernels other than the D =
    64, 80 and 128 wgmma ones walk the union of these walks in one pass: the
    D = 256 and (192, 128) kernels' two warpgroups each take every tile, one
    for dV, one for dK."""
    R, T = G * Tq, tile
    dq = {}
    for r0 in range(0, R, T):
        qmin, qmax = q_offset + r0 // G, q_offset + (min(R, r0 + T) - 1) // G
        kv_end = min(Tkv, qmax + 1) if causal else Tkv
        kv_begin = max(0, qmin - window + 1) // T * T if window > 0 else 0
        dq[r0] = list(range(kv_begin, kv_end, T))
    dkv = {}
    for kv0 in range(0, Tkv, T):
        kv1 = min(Tkv, kv0 + T)
        rr_lo = max(0, (kv0 - q_offset) * G) if causal else 0
        rr_hi = min(R, max(0, kv1 - 1 + window - q_offset) * G) if window > 0 else R
        r_first = rr_lo // T * T
        ntile = (rr_hi - r_first + T - 1) // T if rr_hi > r_first else 0
        dkv[kv0] = [[r_first + T * i for i in range(w, ntile, warpgroups)]
                    for w in range(warpgroups)]
    return dq, dkv


def bwd_tile_visible(G: int, Tq: int, Tkv: int, r0: int, kv0: int, *, causal: bool = True,
                     window: int = 0, q_offset: int = 0) -> bool:
    """Whether every (row, key) pair of the 64 x 64 tile pair at folded row
    ``r0`` and key ``kv0`` is visible, so that the wgmma kernels (D = 64, 80,
    128 and 256) skip its mask (``tile_visible`` in
    ``csrc/flash_attention_bwd.cu``; the other kernels mask every score)."""
    T = BWD_TILE
    ok = r0 + T <= G * Tq and kv0 + T <= Tkv
    if causal:
        ok = ok and q_offset + r0 // G >= kv0 + T - 1
    if window > 0:
        ok = ok and q_offset + (r0 + T - 1) // G - kv0 < window
    return ok


def _check(q, k, v) -> None:
    """Raises on inputs no kernel takes: shapes, head dims (one of
    ``HEAD_DIMS``, or a pair of ``HEAD_DIM_PAIRS``), CUDA, dtype,
    contiguity."""
    if q.dim() != 4 or k.dim() != 3 or v.shape[:2] != k.shape[:2] or v.dim() != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    BH, D = q.shape[0], q.shape[3]
    if k.shape[0] != BH or k.shape[2] != D or not _dims_ok(D, v.shape[2]):
        raise ValueError(f"need k (BH, Tkv, D), v (BH, Tkv, Dv) with D in {HEAD_DIMS} "
                         f"(and Dv = D) or (D, Dv) in {HEAD_DIM_PAIRS}; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                         "float32, bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, path: str | None = None,
                    return_lse: bool = False):
    """q: (BH, G, Tq, D); k: (BH, Tkv, D); v: (BH, Tkv, Dv) → (BH, G, Tq,
    Dv), on CUDA, with scale 1/sqrt(D); with ``return_lse`` also each row's
    float32 log-sum-exp (BH, G, Tq). ``path`` overrides ``choose_path`` (the
    C side refuses a path the inputs cannot take). Raises on anything the
    kernel does not take."""
    _check(q, k, v)
    BH, G, Tq, D = q.shape
    Tkv, Dv = k.shape[1], v.shape[2]
    out = q.new_empty((BH, G, Tq, Dv))
    lse = (torch.empty((BH, G, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    path = path or choose_path(q.dtype, D, all(p % 16 == 0 for p in ptrs), Dv)
    err = _lib()(*ptrs, None if lse is None else lse.data_ptr(), BH, G, Tq, Tkv, D, Dv,
                 DTYPE_CODES[q.dtype], int(causal), int(window), float(softcap),
                 int(q_offset), 1.0 / D ** 0.5, PATH_CODES[path],
                 # the current stream's handle, without building a Stream object
                 torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err:
        raise RuntimeError(f"flash_attention launch failed ({path} path): "
                           f"CUDA error {err}")
    _count.launch(flash_attention, paths=path)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.paths = dict.fromkeys(PATH_CODES, 0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0, path: str | None = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at (q, k, v), whose
    output was ``o`` and row log-sum-exp ``lse``, for the output gradient
    ``do`` (o and do (BH, G, Tq, Dv), v's head dim); same shapes and layout
    as q, k, v. On CUDA; raises on anything the kernels do not take.
    ``path`` as :func:`flash_attention`'s, picked by the same rule: ``mma``
    for aligned bf16 (but at ``FFMA_PAIRS``), else ``ffma``."""
    _check(q, k, v)
    BH, G, Tq, D = q.shape
    Tkv, Dv = k.shape[1], v.shape[2]
    if o.shape != (BH, G, Tq, Dv) or do.shape != o.shape or lse.shape != (BH, G, Tq):
        raise ValueError(f"need o and do of shape {(BH, G, Tq, Dv)} and lse "
                         f"({BH}, {G}, {Tq}); got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"need o, do in {q.dtype} and lse in float32")
    if not (o.is_contiguous() and do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd needs contiguous o, do, lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dvec = torch.empty((BH, G, Tq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr())
    path = path or choose_path(q.dtype, D, all(p % 16 == 0 for p in ptrs), Dv)
    err = _lib_bwd()(*ptrs, BH, G, Tq, Tkv, D, Dv, DTYPE_CODES[q.dtype], int(causal),
                     int(window), float(softcap), int(q_offset), 1.0 / D ** 0.5,
                     PATH_CODES[path], torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed ({path} path): "
                           f"CUDA error {err}")
    _count.launch(flash_attention_bwd, paths=path)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.paths = dict.fromkeys(PATH_CODES, 0)
