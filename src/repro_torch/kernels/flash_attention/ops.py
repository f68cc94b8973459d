"""Public wrapper: (B, T, H, D)-layout GQA flash attention (port of
``repro/kernels/flash_attention/ops.py::attention``), differentiable.

A CPU tensor takes the plain PyTorch version; any other tensor goes to the
CUDA kernel, which launches or raises. The kernel masks ragged tails, so no
block sizes are picked here.

Where a gradient is wanted the attention runs inside :class:`_Attention`:
its forward also keeps the row log-sum-exp, and its backward is the
``flash_attention_bwd`` launch (the plain formula for CPU tensors). Under
``remat="dots"`` a layer's recompute gets O and the lse back from the
layer's tape (:mod:`repro_torch.kernels._keep`) instead of launching.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _keep
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)


def _forward(q, k, v, **kw):
    """The plain version for a CPU tensor, a kernel launch for any other;
    the kept output where a ``"dots"`` layer is recomputed."""
    fn = flash_attention_ref if q.device.type == "cpu" else kernel.flash_attention
    return _keep.kept(fn, q, k, v, **kw)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask: dict):
        out, lse = _forward(q, k, v, return_lse=True, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = (flash_attention_bwd_ref if q.device.type == "cpu"
              else kernel.flash_attention_bwd)
        dq, dk, dv = fn(q, k, v, out, dout.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k: (B, Tkv, Hkv, D); v: (B, Tkv, Hkv, Dv) →
    (B, Tq, Hq, Dv)."""
    B, Tq, Hq, D = q.shape
    Tkv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qf = q.permute(0, 2, 1, 3).reshape(B * Hkv, G, Tq, D).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * Hkv, Tkv, D).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * Hkv, Tkv, Dv).contiguous()
    mask = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qf, kf, vf)):
        out = _Attention.apply(qf, kf, vf, mask)
    else:
        out = _forward(qf, kf, vf, **mask)
    return out.reshape(B, Hq, Tq, Dv).permute(0, 2, 1, 3)
