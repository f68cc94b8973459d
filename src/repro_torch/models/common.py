"""Shared model plumbing (port of ``repro/models/common.py``): parameter
specs, RMS norm, rotary embeddings, logit soft-capping.

A :class:`ParamSpec` declares shape, dtype, initializer and logical axes
once; :func:`tree_initialize` turns a nested dict/tuple of specs into
tensors with an explicit ``torch.Generator``. Logical axes are kept so the
spec tree compares one to one with the reference; one device shards
nothing.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: Any = torch.float32
    init: str = "normal"      # normal | zeros | ones | small
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_specs(fn, tree):
    """Apply ``fn`` to every :class:`ParamSpec` leaf of a dict/tuple tree."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return tuple(tree_map_specs(fn, v) for v in tree)


def tree_spec_leaves(tree) -> list[ParamSpec]:
    out: list[ParamSpec] = []
    tree_map_specs(out.append, tree)
    return out


def tree_initialize(tree, generator: torch.Generator, device,
                    dtype_override=None):
    """Random init of a spec tree: normal(0, scale) in float32, then cast.
    Draws come from ``generator`` in leaf order (dict insertion order)."""

    def init(s: ParamSpec):
        dt = dtype_override or s.dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        sc = s.scale if s.init == "normal" else 0.006
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * sc).to(dt)

    return tree_map_specs(init, tree)


def stack_specs(spec_tree, n: int):
    """Stacked variant of a spec tree: leading "stack" axis of size ``n``."""
    return tree_map_specs(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=("stack",) + s.axes),
        spec_tree)


def norm_spec(dim: int, dtype=torch.float32) -> ParamSpec:
    return ParamSpec((dim,), (None,), dtype, init="ones")


def _rms_norm_impl(x, scale, eps):
    x32 = x.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * scale.float()).to(x.dtype), r


class _RmsNorm(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_rms_norm_bwd``): float32 math, the
    activation gradient returned in ``x.dtype`` and the scale's in float32."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, r = _rms_norm_impl(x, scale, eps)
        ctx.save_for_backward(x, scale, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, r = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        gs = g32 * scale.float()
        dot = (gs * x32).sum(dim=-1, keepdim=True)
        dx = (gs - x32 * (r * r) * dot / x.shape[-1]) * r
        dscale = (g32 * x32 * r).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """The reference ``rms_norm``: float32 math, result in ``x.dtype``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RmsNorm.apply(x, scale, eps)
    return _rms_norm_impl(x, scale, eps)[0]


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.cache
def _rope_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, copied there once: a host
    copy a call would wait for the device in every layer."""
    return torch.from_numpy(rope_frequencies(d, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (..., T, H, D) with positions (..., T). Rotates pairs (i, i+D/2);
    angles in float32."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs         # (..., T, D/2)
    cos = torch.cos(angles)[..., :, None, :]                 # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def soft_cap(x: torch.Tensor, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x
