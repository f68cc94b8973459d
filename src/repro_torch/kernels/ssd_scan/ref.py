"""Plain PyTorch version of ssd_scan (transcription of
``repro/kernels/ssd_scan/ref.py``): the per-timestep SSM recurrence,
sequential over T in float32. On purpose a different algorithm from the
chunked kernel, so comparing the two checks the chunked arithmetic.

:func:`ssd_scan_bwd_ref` is its adjoint, run backward in time over the
same recurrence: the plain version of the ``ssd_scan_bwd`` kernel."""

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


def ssd_scan_bwd_ref(x, dt, a, b, c, d, dy, dstate=None):
    """Gradients of :func:`ssd_scan_ref` for the output gradient ``dy``
    (BH, T, P) and the final-state gradient ``dstate`` (BH, N, P) or None.

    With α_t = exp(dt_t a) and g_t the gradient of h_t,
    g_{T-1} = c ȳᵀ + S̄ and g_t = c_t ȳ_tᵀ + α_{t+1} g_{t+1}; then
    x̄_t = dt_t g_tᵀ b_t + d ȳ_t, b̄_t = dt_t g_t x_t, c̄_t = h_t ȳ_t,
    d̄t_t = b_tᵀ g_t x_t + a α_t ⟨g_t, h_{t-1}⟩, ā = Σ_t dt_t α_t ⟨g_t, h_{t-1}⟩
    and d̄ = Σ_t ȳ_t · x_t. Every h_t is kept in float32 (never rebuilt by
    dividing by α). Returns (dx, ddt, da, db, dc, dd) per (batch, head):
    dx in x's dtype, the rest float32 (db and dc are still to be summed over
    the heads of a group, so they are rounded only after that sum)."""
    BH, T, P = x.shape
    N = b.shape[-1]
    xf, dtf, bf, cf, dyf = x.float(), dt.float(), b.float(), c.float(), dy.float()
    a, d = a.float(), d.float()
    alpha = torch.exp(dtf * a[:, None])                                    # (BH, T)
    hs = torch.empty((BH, T + 1, N, P), dtype=torch.float32, device=x.device)
    hs[:, 0] = 0.0                                                         # h_{-1}
    for t in range(T):
        hs[:, t + 1] = alpha[:, t, None, None] * hs[:, t] \
            + (dtf[:, t, None] * bf[:, t])[..., None] * xf[:, t, None, :]
    g = (torch.zeros((BH, N, P), dtype=torch.float32, device=x.device) if dstate is None
         else dstate.float().clone())
    dx, db, dc = torch.zeros_like(xf), torch.zeros_like(bf), torch.zeros_like(cf)
    ddt = torch.zeros_like(dtf)
    da = torch.zeros_like(a)
    for t in reversed(range(T)):
        if t + 1 < T:
            g = alpha[:, t + 1, None, None] * g
        g = g + cf[:, t, :, None] * dyf[:, t, None, :]
        gx = torch.einsum("bnp,bp->bn", g, xf[:, t])                      # g_t x_t
        dx[:, t] = dtf[:, t, None] * torch.einsum("bnp,bn->bp", g, bf[:, t]) \
            + d[:, None] * dyf[:, t]
        db[:, t] = dtf[:, t, None] * gx
        dc[:, t] = torch.einsum("bnp,bp->bn", hs[:, t + 1], dyf[:, t])
        decay_term = alpha[:, t] * torch.einsum("bnp,bnp->b", g, hs[:, t])
        ddt[:, t] = torch.einsum("bn,bn->b", bf[:, t], gx) + a * decay_term
        da = da + dtf[:, t] * decay_term
    dd = torch.einsum("btp,btp->b", dyf, xf)
    return dx.to(x.dtype), ddt, da, db, dc, dd
