"""Public wrapper: (Bt, T, H, P)-layout SSD with grouped B/C (port of
``repro/kernels/ssd_scan/ops.py::ssd``), differentiable.

A CPU tensor takes the plain PyTorch version; any other tensor goes to the
CUDA kernel, which launches or raises. The kernel reads grouped B/C by index
and masks a ragged last chunk, so nothing is repeated or padded here, and
its chunk length is its own: the wrapper takes no ``chunk``.

Where a gradient is wanted the scan runs inside :class:`_SSD`: its forward
also writes the state entering each chunk, and its backward is the
``ssd_scan_bwd`` launch that reads them (the plain adjoint for CPU
tensors). At mamba2_2_7b's training shape, writing them cost the forward
0.029 ms where rebuilding them cost the first backward 0.43 ms (an
NVIDIA H100 80GB HBM3 at 700 W; PERF.md). The
reference differentiates its plain ``ssd_chunked`` with XLA; its Pallas
kernel has no backward. Under ``remat="dots"`` a layer's recompute gets y,
the final state and the chunk entry states back from the layer's tape
(:mod:`repro_torch.kernels._keep`) instead of launching.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _keep
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref


def _fold(x, dt, A, B, C, D):
    """The model's layout → the plain version's: B/C repeated to heads,
    (batch, head) folded."""
    Bt, T, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    rep = H // G
    bf = B.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(Bt * H, T, N)
    cf = C.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(Bt * H, T, N)
    return (x.permute(0, 2, 1, 3).reshape(Bt * H, T, P),
            dt.permute(0, 2, 1).reshape(Bt * H, T), A.repeat(Bt), bf, cf, D.repeat(Bt))


def ssd_plain(x, dt, A, B, C, D):
    """The plain version in the wrapper's layout: B/C repeated to heads,
    (batch, head) folded, then the per-timestep recurrence."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    y, s = ssd_scan_ref(*_fold(x, dt, A, B, C, D))
    return y.reshape(Bt, H, T, P).permute(0, 2, 1, 3), s.reshape(Bt, H, N, P)


def ssd_plain_bwd(x, dt, A, B, C, D, dy, dstate=None):
    """Gradients of :func:`ssd_plain` for ``dy`` (Bt, T, H, P) and the
    final-state gradient ``dstate`` (Bt, H, N, P) or None: (dx, ddt, dA,
    dB, dC, dD) in the inputs' layouts, dB/dC summed over the heads of a
    group and dA/dD over the batch."""
    Bt, T, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    dyf = dy.permute(0, 2, 1, 3).reshape(Bt * H, T, P)
    ds = None if dstate is None else dstate.reshape(Bt * H, N, P)
    dx, ddt, da, db, dc, dd = ssd_scan_bwd_ref(*_fold(x, dt, A, B, C, D), dyf, ds)

    def group(g):   # (Bt H, T, N) per head → (Bt, T, G, N) summed over its heads
        g = g.float().reshape(Bt, G, H // G, T, N).sum(2)
        return g.permute(0, 2, 1, 3).to(B.dtype)

    return (dx.reshape(Bt, H, T, P).permute(0, 2, 1, 3), ddt.reshape(Bt, H, T).permute(0, 2, 1),
            da.reshape(Bt, H).sum(0), group(db), group(dc), dd.reshape(Bt, H).sum(0))


def _scan_with_states(x, dt, A, B, C, D):
    """One launch that also writes the state entering each chunk: (y,
    final state, chunk states)."""
    states = torch.empty(kernel.chunk_states_shape(x, B), dtype=torch.float32,
                         device=x.device)
    return *kernel.ssd_scan(x, dt, A, B, C, D, chunk_states=states), states


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, dt, A, B, C, D)
            return _keep.kept(ssd_plain, x, dt, A, B, C, D)
        y, state, states = _keep.kept(_scan_with_states, x, dt, A, B, C, D)
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        if dy is None and dstate is None:
            return (None,) * 6
        x, dt, A, B, C, D, *states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        if x.device.type == "cpu":
            return ssd_plain_bwd(x, dt, A, B, C, D, dy, dstate)
        return kernel.ssd_scan_bwd(x, dt, A, B, C, D, dy, dstate, states[0])


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor):
    """x: (Bt, T, H, P); dt: (Bt, T, H); A, D: (H,); B, C: (Bt, T, G, N).

    Returns (y (Bt, T, H, P), final_state (Bt, H, N, P))."""
    args = (x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
            B.contiguous(), C.contiguous(), D.float().contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SSD.apply(*args)
    return _keep.kept(ssd_plain if x.device.type == "cpu" else kernel.ssd_scan, *args)
