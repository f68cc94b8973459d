"""Plain PyTorch version of ssd_scan (transcription of
``repro/kernels/ssd_scan/ref.py``): the per-timestep SSM recurrence,
sequential over T in float32. On purpose a different algorithm from the
chunked kernel, so comparing the two checks the chunked arithmetic."""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, a, b, c, d):
    """x: (BH, T, P); dt: (BH, T); a, d: (BH,); b, c: (BH, T, N).

    h_t = exp(dt_t a) h_{t-1} + dt_t b_t ⊗ x_t;  y_t = c_t @ h_t + d x_t
    Returns (y (BH, T, P) in x's dtype, final_state (BH, N, P) float32)."""
    BH, T, P = x.shape
    N = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    a, d = a.float(), d.float()
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * a)
        h = decay[:, None, None] * h \
            + (dtf[:, t, None] * bf[:, t])[..., None] * xf[:, t, None, :]
        ys.append(torch.einsum("bnp,bn->bp", h, cf[:, t]) + d[:, None] * xf[:, t])
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h
