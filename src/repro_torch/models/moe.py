"""Mixture-of-Experts with capacity-based top-k routing (port of
``repro/models/moe.py``).

The reference's semantics, kept exactly:

- a float32 router, ``softmax(x.float() @ w_router)``, one tile_matmul
  launch whatever the model's dtype;
- the top k of each token by a stable descending sort, so that among equal
  probabilities the lower expert index wins, as ``jax.lax.top_k`` picks;
  ``norm_topk`` divides by ``max(sum, 1e-9)``;
- the Switch load-balance loss ``aux_weight · E · Σ mean(probs) · counts /
  (T·k)``;
- tokens in groups of ``min(group, T)`` (``T % group`` must be 0), a
  capacity ``max(ceil(cf · group / E), 1)`` a slot, or the whole group when
  ``group <= 4E`` (the decode rule: never drop); for each of the k slots a
  token's place in its expert's queue is its running count in token order
  within its group, and a token at ``cap`` or beyond is dropped (the
  residual carries it);
- each slot's output ``combine.astype(x.dtype) * h`` rounded to the working
  type, the slots summed in slot order in it, the shared SwiGLU branch added
  last.

Where the reference multiplies one-hot dispatch and combine tensors into
einsums, this port gathers and scatters rows: every output row is the one
product the einsum's single nonzero term gives, so the bits are the same.
Under autograd every gradient row has one owner (the dispatch's copy is
differentiated as a gather, the combine's gather by :class:`_Gather` as a
copy, a token's k slots summed by an expand's reduction), so two backward
passes give the same bits and nothing adds by index.
The k slots' dispatched rows of one expert are stacked into one ``(E, k·G·C,
d)`` buffer (row ``(j·G + g)·C + c``), so each expert product is one batched
``tile_matmul`` launch that reads every expert's weights once a layer. No
host synchronisation: dropped entries are written to a spare row past the
buffer and read back with weight 0.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels.tile_matmul.ops import batched_product, matmul
from repro_torch.models.common import ParamSpec


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden
    n_shared: int = 0
    d_ff_shared: int = 0        # fused width of the shared-expert branch
    capacity_factor: float = 1.25
    group: int = 2048           # tokens per dispatch group
    norm_topk: bool = True      # renormalise selected gate probs (DeepSeek)
    aux_weight: float = 0.01    # load-balance loss weight


def moe_specs(d_model: int, cfg: MoECfg, dtype) -> dict:
    specs = {
        "w_router": ParamSpec((d_model, cfg.n_experts), ("embed", None),
                              torch.float32),
        "w_gate": ParamSpec((cfg.n_experts, d_model, cfg.d_ff),
                            ("experts", "embed", "mlp"), dtype),
        "w_up": ParamSpec((cfg.n_experts, d_model, cfg.d_ff),
                          ("experts", "embed", "mlp"), dtype),
        "w_down": ParamSpec((cfg.n_experts, cfg.d_ff, d_model),
                            ("experts", "mlp", "embed"), dtype),
    }
    if cfg.n_shared > 0:
        specs |= {
            "ws_gate": ParamSpec((d_model, cfg.d_ff_shared), ("embed", "mlp"), dtype),
            "ws_up": ParamSpec((d_model, cfg.d_ff_shared), ("embed", "mlp"), dtype),
            "ws_down": ParamSpec((cfg.d_ff_shared, d_model), ("mlp", "embed"), dtype),
        }
    return specs


_recorder = threading.local()


@contextlib.contextmanager
def recording_routes():
    """Collect the routing of every :func:`moe_ffn` call that this thread
    makes inside the block, in call order: a list of ``(probs (T, E)
    float32, top-k ids (T, k))``, one entry a layer and a forward pass.
    Other threads' calls are not collected."""
    saved = getattr(_recorder, "routes", None)
    _recorder.routes = []
    try:
        yield _recorder.routes
    finally:
        _recorder.routes = saved


def capacity(cfg: MoECfg, tokens: int) -> tuple[int, int]:
    """(group, capacity a slot) for ``tokens`` tokens, as the reference sets
    them; raises where the tokens do not split into whole groups."""
    group = min(cfg.group, tokens)
    if tokens % group:
        raise ValueError(f"{tokens} tokens do not split into groups of {group}")
    cap = max(int(math.ceil(cfg.capacity_factor * group / cfg.n_experts)), 1)
    if group <= 4 * cfg.n_experts:
        cap = group
    return group, cap


def _expert_ffn(h, p):
    """h: (E, R, d) -> (E, R, d); the three expert products, one batched
    tile_matmul launch each, the SiLU fused into the gate's."""
    gate = batched_product(h, p["w_gate"], activation="silu")
    return batched_product(gate * batched_product(h, p["w_up"]), p["w_down"])


class _Gather(torch.autograd.Function):
    """``y[idx]`` where no two entries of ``idx`` below ``len(y)`` repeat,
    and ``len(y)`` (a dropped pair) reads row 0. The backward copies each
    gradient row to the one row of y it came from (the dropped pairs' to a
    spare row, then cut off): every row of dy has one owner, so nothing
    accumulates and the bits do not depend on the order of the writes,
    where autograd's own gather backward adds into a row by index."""

    @staticmethod
    def forward(ctx, y, idx):
        ctx.save_for_backward(idx)
        ctx.rows = len(y)
        return y[torch.where(idx < len(y), idx, 0)]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        dy = g.new_zeros((ctx.rows + 1, g.shape[1])).index_copy_(0, idx, g)
        return dy[:ctx.rows], None


def moe_ffn(x, p, cfg: MoECfg):
    """x: (T, d) — flattened tokens. Returns (out (T, d), aux_loss scalar)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    group, cap = capacity(cfg, T)
    G = T // group
    dev = x.device

    probs = torch.softmax(matmul(x.float(), p["w_router"]), dim=-1)   # (T, E)
    top_i = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    top_p = torch.gather(probs, 1, top_i)
    if cfg.norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    routes = getattr(_recorder, "routes", None)
    if routes is not None:
        routes.append((probs.detach(), top_i))

    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, top_i.reshape(-1), torch.full((T * k,), 1.0 / (T * k), device=dev))
    aux = cfg.aux_weight * E * torch.sum(me * ce)

    # Each (token, slot)'s place in its expert's queue within its group: a
    # running count over an int32 one-hot (F.one_hot's is int64, twice the
    # bytes for the cumsum to walk).
    ig = top_i.reshape(G, group, k)
    onehot = (ig[..., None] == torch.arange(E, device=dev)).to(torch.int32)
    pos = onehot.cumsum(dim=1, dtype=torch.int32).gather(-1, ig[..., None])[..., 0] - 1
    keep = pos < cap
    R = k * G * cap                                       # rows an expert
    row = ((torch.arange(k, device=dev) * G)[None, None, :]
           + torch.arange(G, device=dev)[:, None, None]) * cap + pos
    dest = torch.where(keep, ig * R + row, E * R).reshape(T * k)
    # token t's k copies, rows t k .. t k + k - 1: an expand, whose gradient
    # sums the k slots' rows in slot order
    rows = x[:, None].expand(T, k, d).reshape(T * k, d)
    buf = x.new_zeros((E * R + 1, d)).index_copy(0, dest, rows)
    y = _expert_ffn(buf[:E * R].view(E, R, d), p).reshape(E * R, d)

    w = torch.where(keep.reshape(T, k), top_p, 0.0).to(x.dtype)
    got = _Gather.apply(y, dest).view(T, k, d)
    out = w[:, 0, None] * got[:, 0]
    for j in range(1, k):
        out = out + w[:, j, None] * got[:, j]

    if cfg.n_shared > 0:
        gate = matmul(x, p["ws_gate"], activation="silu")
        out = out + matmul(gate * matmul(x, p["ws_up"]), p["ws_down"])
    return out, aux
