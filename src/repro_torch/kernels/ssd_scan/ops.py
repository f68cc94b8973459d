"""Public wrapper: (Bt, T, H, P)-layout SSD with grouped B/C (port of
``repro/kernels/ssd_scan/ops.py::ssd``).

A CPU tensor takes the plain PyTorch version; any other tensor goes to the
CUDA kernel, which launches or raises. The kernel reads grouped B/C by index
and masks a ragged last chunk, so nothing is repeated or padded here, and
its chunk length is its own: the wrapper takes no ``chunk``.

The kernel has no backward yet: on the card, a gradient through the scan
raises rather than silently stopping at it (Mamba-2 training, ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_plain(x, dt, A, B, C, D):
    """The plain version in the wrapper's layout: B/C repeated to heads,
    (batch, head) folded, then the per-timestep recurrence."""
    Bt, T, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    rep = H // G
    bf = B.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(Bt * H, T, N)
    cf = C.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(Bt * H, T, N)
    y, s = ssd_scan_ref(x.permute(0, 2, 1, 3).reshape(Bt * H, T, P),
                        dt.permute(0, 2, 1).reshape(Bt * H, T), A.repeat(Bt), bf, cf,
                        D.repeat(Bt))
    return y.reshape(Bt, H, T, P).permute(0, 2, 1, 3), s.reshape(Bt, H, N, P)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor):
    """x: (Bt, T, H, P); dt: (Bt, T, H); A, D: (H,); B, C: (Bt, T, G, N).

    Returns (y (Bt, T, H, P), final_state (Bt, H, N, P))."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet: Mamba-2 training on the card "
            "is the next slice (ROADMAP.md)")
    return kernel.ssd_scan(x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
                           B.contiguous(), C.contiguous(), D.float().contiguous())
