"""Public wrapper for tile_matmul (port of
``repro/kernels/tile_matmul/ops.py::matmul``).

A CPU tensor takes the plain PyTorch version; any other tensor goes to the
CUDA kernel, which launches or raises. There is no fallback: the kernel
masks ragged edges itself, so no shape needs the plain version on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.tile_matmul import kernel
from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref


def matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, activation: str = "none", out_dtype=None) -> torch.Tensor:
    """``x (..., K) @ w (K, N) [+ b (N,)]`` with fused activation epilogue.
    Leading axes of ``x`` are folded into M."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        out = tile_matmul_ref(x2, w, b, activation=activation,
                              out_dtype=out_dtype)
    else:
        out = kernel.tile_matmul(x2.contiguous(), w.contiguous(), b,
                                 activation=activation, out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[1])
