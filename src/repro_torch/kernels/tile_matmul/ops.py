"""Public wrapper for tile_matmul (port of
``repro/kernels/tile_matmul/ops.py::matmul``), differentiable.

A CPU tensor takes the plain PyTorch version; any other tensor goes to the
CUDA kernel, which launches or raises. There is no fallback: the kernel
masks ragged edges itself, so no shape needs the plain version on the card.

Where a gradient is wanted the product runs inside :class:`_Matmul`, whose
backward is made of launches too: ``dz`` (``dy``, or ``dy * act'(z)`` with
``z`` recomputed by one launch in float32), then ``dx = dz @ w^T`` and
``dw = x^T @ dz`` with the transposed operand read where it lies, and
``db = dz.sum(0)``. The reference differentiates its plain ``jnp`` product
with XLA; its Pallas kernel has no backward. :func:`batched_product`, the
MoE layer's expert products, differentiates the same way through
:class:`_Batched`, its gradient products batched launches too.

Under ``remat="dots"`` a layer's recompute gets each forward product's
output back from the layer's tape (:mod:`repro_torch.kernels._keep`)
instead of launching it again.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _keep
from repro_torch.kernels.tile_matmul import kernel
from repro_torch.kernels.tile_matmul.ref import (ACT_GRADS, tile_matmul_batched_ref,
                                                  tile_matmul_ref)


def product(x, w, b=None, **kw) -> torch.Tensor:
    """One product on ``x``'s device: the plain version for a CPU tensor,
    a kernel launch for any other."""
    if x.device.type == "cpu":
        return tile_matmul_ref(x, w, b, **kw)
    return kernel.tile_matmul(x, w, b, **kw)


def _batched(x, w, **kw) -> torch.Tensor:
    """One batched product on ``x``'s device: the plain version for a CPU
    tensor, one batched kernel launch for any other."""
    if x.device.type == "cpu":
        return tile_matmul_batched_ref(x, w, **kw)
    return kernel.tile_matmul(x, w, **kw)


def _dz(dy, z_fn, activation, dtype):
    """The cotangent of the product before its activation, rounded to the
    operands' type for the gradient products: ``dy``, or ``dy act'(z)``
    with ``z`` recomputed in float32 by ``z_fn``."""
    dz32 = dy.float()
    if activation != "none":
        dz32 = dz32 * ACT_GRADS[activation](z_fn())
    return dz32, dz32.to(dtype).contiguous()


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, activation, out_dtype):
        ctx.save_for_backward(x, w, b)
        ctx.activation = activation
        return _keep.kept(product, x, w, b, activation=activation, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dz32, dz = _dz(dy, lambda: product(x, w, b, out_dtype=torch.float32),
                       ctx.activation, x.dtype)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = product(dz, w, trans_w=True) if need_x else None
        dw = product(x, dz, trans_x=True) if need_w else None
        db = dz32.sum(0).to(b.dtype) if need_b else None
        return dx, dw, db, None, None


class _Batched(torch.autograd.Function):
    """``act(x[e] @ w[e])`` for every expert, its backward three batched
    launches as :class:`_Matmul`'s: ``z`` in float32 for the activation,
    ``dx = dz @ w^T`` and ``dw = x^T @ dz`` with the transposed operand
    read where it lies."""

    @staticmethod
    def forward(ctx, x, w, activation, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.activation = activation
        return _keep.kept(_batched, x, w, activation=activation, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        _, dz = _dz(dy, lambda: _batched(x, w, out_dtype=torch.float32), ctx.activation,
                    x.dtype)
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = _batched(dz, w, trans_w=True) if need_x else None
        dw = _batched(x, dz, trans_x=True) if need_w else None
        return dx, dw, None, None


def batched_product(x, w, *, activation: str = "none", out_dtype=None) -> torch.Tensor:
    """``act(x (E, M, K) @ w (E, K, N))`` on ``x``'s device: the plain
    version for a CPU tensor, one batched kernel launch for any other.
    Where a gradient is wanted it runs inside :class:`_Batched` on either
    device, so the CPU walks the backward's products as the card launches
    them."""
    if x.device.type != "cpu":
        x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Batched.apply(x, w, activation, out_dtype)
    return _keep.kept(_batched, x, w, activation=activation, out_dtype=out_dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, activation: str = "none", out_dtype=None) -> torch.Tensor:
    """``x (..., K) @ w (K, N) [+ b (N,)]`` with fused activation epilogue.
    Leading axes of ``x`` are folded into M."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type != "cpu":
        x2, w = x2.contiguous(), w.contiguous()
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x2, w, b))
    if grad:
        out = _Matmul.apply(x2, w, b, activation, out_dtype)
    else:
        out = _keep.kept(product, x2, w, b, activation=activation, out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[1])
