"""Mamba-2 SSD mixer (port of ``repro/models/mamba2.py``): the chunked scan
formulation [arXiv:2405.21060] and the O(1)-state decode step.

``ssd_chunked`` is the plain chunked twin of the ``ssd_scan`` kernel: the
model runs it on CPU tensors, and ``kernels/ssd_scan/ops.ssd`` on the card
(``blocks.mamba_train``). Projections stay unfused (separate z/x/B/C/dt
matrices), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


@dataclass(frozen=True)
class MambaCfg:
    d_inner: int
    d_state: int = 128
    d_conv: int = 4
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba_specs(d_model: int, cfg: MambaCfg, dtype) -> dict:
    """A_log, D, dt_bias and norm_gate stay float32 in a bfloat16 model."""
    gn = cfg.n_groups * cfg.d_state
    return {
        "w_z": ParamSpec((d_model, cfg.d_inner), ("embed", "mlp"), dtype),
        "w_x": ParamSpec((d_model, cfg.d_inner), ("embed", "mlp"), dtype),
        "w_B": ParamSpec((d_model, gn), ("embed", None), dtype),
        "w_C": ParamSpec((d_model, gn), ("embed", None), dtype),
        "w_dt": ParamSpec((d_model, cfg.n_heads), ("embed", "heads"), dtype),
        "conv_x": ParamSpec((cfg.d_conv, cfg.d_inner), (None, "mlp"), dtype,
                            init="small"),
        "conv_B": ParamSpec((cfg.d_conv, gn), (None, None), dtype, init="small"),
        "conv_C": ParamSpec((cfg.d_conv, gn), (None, None), dtype, init="small"),
        "A_log": ParamSpec((cfg.n_heads,), ("heads",), torch.float32, init="zeros"),
        "D": ParamSpec((cfg.n_heads,), ("heads",), torch.float32, init="ones"),
        "dt_bias": ParamSpec((cfg.n_heads,), ("heads",), torch.float32,
                             init="zeros"),
        "norm_gate": ParamSpec((cfg.d_inner,), ("mlp",), torch.float32,
                               init="ones"),
        "w_out": ParamSpec((cfg.d_inner, d_model), ("mlp", "embed"), dtype),
    }


def _causal_conv(x, kernel):
    """x: (B, T, C); kernel: (K, C) depthwise causal conv. A
    cross-correlation, as the reference's ``conv_general_dilated``:
    out[t] = sum_k x[t - K + 1 + k] kernel[k]. Returns a contiguous
    (B, T, C) tensor, so what is computed from it reaches the scan without
    a further copy."""
    K, Ch = kernel.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))               # (B, C, T + K - 1)
    out = F.conv1d(xp, kernel.T[:, None, :], groups=Ch)     # (B, C, T)
    return out.transpose(1, 2).contiguous()


def _segsum(dA):
    """dA: (..., Q) → (..., Q, Q) lower-tri cumulative sums
    L[i, j] = Σ_{j < s ≤ i} dA_s  (i ≥ j), -inf above diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]               # (..., i, j)
    i = torch.arange(Q, device=dA.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD forward.

    x: (Bt, T, H, P); dt: (Bt, T, H) (post-softplus, ≥0)
    A: (H,) (negative); B, C: (Bt, T, G, N); D: (H,)
    returns y: (Bt, T, H, P), final_state: (Bt, H, P, N)
    """
    Bt, T, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    rep = H // G
    Q = min(chunk, T)
    # Pad ragged tails with dt=0 steps (decay 1, zero input weight): they
    # leave the state untouched; padded outputs are sliced off.
    T_real = T
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        T += pad
    nc = T // Q

    xc = x.reshape(Bt, nc, Q, H, P)
    dtc = dt.reshape(Bt, nc, Q, H)
    Bc = B.reshape(Bt, nc, Q, G, N).float()
    Cc = C.reshape(Bt, nc, Q, G, N).float()
    dA = dtc * A[None, None, None, :]                       # (Bt,nc,Q,H) ≤0

    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for ic in range(nc):
        xq, dtq, dAq = xc[:, ic], dtc[:, ic], dA[:, ic]
        Bq, Cq = Bc[:, ic], Cc[:, ic]
        L = torch.exp(_segsum(dAq.transpose(1, 2)))         # (Bt,H,Q,Q)
        scores = torch.einsum("bqgn,bkgn->bgqk", Cq, Bq)
        scores = scores.repeat_interleave(rep, dim=1)       # (Bt,H,Q,Q)
        M = scores * L * dtq.transpose(1, 2)[:, :, None, :]
        y_diag = torch.einsum("bhqk,bkhp->bqhp", M.to(x.dtype).float(),
                              xq.float())
        # inter-chunk: contribution of the carried state
        cum = torch.cumsum(dAq, dim=1)                      # (Bt,Q,H)
        decay_in = torch.exp(cum)
        Cq_h = Cq.repeat_interleave(rep, dim=2)             # (Bt,Q,H,N)
        y_off = torch.einsum("bqhn,bhpn,bqh->bqhp", Cq_h, state, decay_in)
        # state update: S' = exp(total) S + Σ_q exp(total - cum_q) B_q dt_q x_q
        total = cum[:, -1]                                  # (Bt,H)
        w = torch.exp(total[:, None] - cum) * dtq           # (Bt,Q,H)
        Bq_h = Bq.repeat_interleave(rep, dim=2)
        s_new = torch.einsum("bqhn,bqhp,bqh->bhpn", Bq_h, xq.float(), w)
        state = torch.exp(total)[..., None, None] * state + s_new
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bt, T, H, P)
    y = (y + x * D[None, None, :, None]).to(x.dtype)
    return y[:, :T_real], state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D):
    """Single-token SSD update.

    state: (Bt, H, P, N); x_t: (Bt, H, P); dt_t: (Bt, H);
    B_t, C_t: (Bt, G, N) → y_t: (Bt, H, P), new state.
    """
    H = x_t.shape[1]
    G = B_t.shape[1]
    rep = H // G
    Bh = B_t.repeat_interleave(rep, dim=1).float()          # (Bt,H,N)
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt_t * A[None, :])                       # (Bt,H)
    upd = torch.einsum("bhn,bhp,bh->bhpn", Bh, x_t.float(), dt_t)
    state = dA[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return (y + x_t * D[None, :, None]).to(x_t.dtype), state
