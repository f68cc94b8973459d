"""Public wrapper: (B, T, H, D)-layout GQA flash attention (port of
``repro/kernels/flash_attention/ops.py::attention``).

A CPU tensor takes the plain PyTorch version; any other tensor goes to the
CUDA kernel, which launches or raises. The kernel masks ragged tails, so no
block sizes are picked here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k, v: (B, Tkv, Hkv, D) → (B, Tq, Hq, D)."""
    B, Tq, Hq, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.permute(0, 2, 1, 3).reshape(B * Hkv, G, Tq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * Hkv, Tkv, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * Hkv, Tkv, D)
    fn = flash_attention_ref if q.device.type == "cpu" else kernel.flash_attention
    out = fn(qf.contiguous(), kf.contiguous(), vf.contiguous(), causal=causal,
             window=window, softcap=softcap, q_offset=q_offset)
    return out.reshape(B, Hq, Tq, D).permute(0, 2, 1, 3)
