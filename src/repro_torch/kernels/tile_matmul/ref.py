"""Plain PyTorch version of tile_matmul (transcription of
``repro/kernels/tile_matmul/ref.py``): float32 product, bias, activation,
cast. ``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults to."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {
    "none": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def tile_matmul_ref(x, w, b=None, *, activation: str = "none",
                    out_dtype=None):
    out = torch.matmul(x.float(), w.float())
    if b is not None:
        out = out + b.float()
    out = ACTS[activation](out)
    return out.to(out_dtype or x.dtype)
