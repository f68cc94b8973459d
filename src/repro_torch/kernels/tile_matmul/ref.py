"""Plain PyTorch version of tile_matmul (transcription of
``repro/kernels/tile_matmul/ref.py``): float32 product, bias, activation,
cast. ``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults to.

``trans_x`` / ``trans_w`` read an operand transposed, as the kernel's
gradient layouts do; :func:`tile_matmul_batched_ref` is the batched
product's, one :func:`tile_matmul_ref` an expert; ``ACT_GRADS`` holds each
activation's derivative for the backward of
:func:`repro_torch.kernels.tile_matmul.ops.matmul`."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ACTS = {
    "none": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}

_GELU_C = math.sqrt(2.0 / math.pi)


def _gelu_grad(z):
    t = torch.tanh(_GELU_C * (z + 0.044715 * z ** 3))
    return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * _GELU_C * (1 + 3 * 0.044715 * z * z)


def _silu_grad(z):
    s = torch.sigmoid(z)
    return s * (1 + z * (1 - s))


# d act(z) / dz, elementwise, in float32 (relu's is taken as 0 at 0).
ACT_GRADS = {
    "tanh": lambda z: 1 - torch.tanh(z) ** 2,
    "relu": lambda z: (z > 0).to(z.dtype),
    "silu": _silu_grad,
    "gelu": _gelu_grad,
}


def tile_matmul_ref(x, w, b=None, *, activation: str = "none",
                    out_dtype=None, trans_x: bool = False, trans_w: bool = False):
    xs = x.T if trans_x else x
    ws = w.T if trans_w else w
    out = torch.matmul(xs.float(), ws.float())
    if b is not None:
        out = out + b.float()
    out = ACTS[activation](out)
    return out.to(out_dtype or x.dtype)


def tile_matmul_batched_ref(x, w, *, activation: str = "none", out_dtype=None,
                            trans_x: bool = False, trans_w: bool = False):
    """``x (E, M, K) @ w (E, K, N)``, each operand read transposed where
    ``trans_x`` / ``trans_w`` say: :func:`tile_matmul_ref` of each expert."""
    return torch.stack([tile_matmul_ref(xe, we, activation=activation, out_dtype=out_dtype,
                                        trans_x=trans_x, trans_w=trans_w)
                        for xe, we in zip(x, w)])
