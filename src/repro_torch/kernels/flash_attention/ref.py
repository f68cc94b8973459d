"""Plain PyTorch version of flash_attention (transcription of
``repro/kernels/flash_attention/ref.py``): materialised-score attention
with causal / window / softcap masking, and its gradient by the explicit
formula (:func:`flash_attention_bwd_ref`), both in the kernels' folded
GQA layout."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, *, causal, window, softcap, q_offset):
    """Masked, softcapped float32 scores (BH, G, Tq, Tkv), the pre-cap
    scores' softcap factor ``1 - (s / c)^2`` (or None), and the mask."""
    _, _, Tq, D = q.shape
    Tkv = k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) / (D ** 0.5)
    cap_grad = None
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
        cap_grad = 1 - (s / softcap) ** 2
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    kv_pos = torch.arange(Tkv, device=q.device)[None, :]
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    return torch.where(mask[None, None], s, NEG_INF), cap_grad, mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0,
                        return_lse: bool = False):
    """q: (BH, G, Tq, D); k: (BH, Tkv, D); v: (BH, Tkv, Dv). Returns (BH, G,
    Tq, Dv) in q's dtype; with ``return_lse`` also each row's float32
    log-sum-exp (BH, G, Tq)."""
    s, _, _ = _scores(q, k, causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p / l
    out = torch.einsum("bgqk,bkd->bgqd", p.to(v.dtype).float(), v.float())
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_ref` by the explicit formula,
    in float32, each returned in its input's dtype:
    P = exp(s - lse), dP = dO V^T, Dv = rowsum(dO o O),
    dS = P (dP - Dv) (x the softcap factor), dQ = dS K / sqrt(D),
    dK = sum over G of dS^T Q / sqrt(D), dV = sum over G of P^T dO."""
    D = q.shape[-1]
    s, cap_grad, mask = _scores(q, k, causal=causal, window=window,
                                softcap=softcap, q_offset=q_offset)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dp = torch.einsum("bgqd,bkd->bgqk", do32, v.float())
    dvec = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = torch.where(mask[None, None], p * (dp - dvec), 0.0)
    if cap_grad is not None:
        ds = ds * cap_grad
    ds = ds / (D ** 0.5)
    dq = torch.einsum("bgqk,bkd->bgqd", ds, k.float())
    dk = torch.einsum("bgqk,bgqd->bkd", ds, q.float())
    dv = torch.einsum("bgqk,bgqd->bkd", p, do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
