"""Plain PyTorch version of flash_attention (transcription of
``repro/kernels/flash_attention/ref.py``): materialised-score attention
with causal / window / softcap masking."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """q: (BH, G, Tq, D); k, v: (BH, Tkv, D). Returns q's shape and dtype."""
    _, _, Tq, D = q.shape
    Tkv = k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) / (D ** 0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    kv_pos = torch.arange(Tkv, device=q.device)[None, :]
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgqk,bkd->bgqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
