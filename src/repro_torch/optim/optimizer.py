"""AdamW with selectable moment precision, global-norm clipping and a
warmup + cosine schedule (port of ``repro/optim/optimizer.py``).

Moment precision ladder, as the reference's: ``float32`` (8 B a parameter
for m and v), ``bfloat16`` (4 B), ``int8`` (about 2.03 B: blockwise
quantized along the last axis, one float32 absmax scale per block of
``QBLOCK``, round half to even as ``jnp.round``).

Everything works on tensors under ``torch.no_grad()`` and out of place:
:func:`adamw_update` returns new parameter and state trees and leaves its
inputs as they were, as the reference's pure update does, so a step the
watchdog re-issues starts again from the same state. The one exception is
asked for by a caller whose gradients are its own temporaries
(``donate_grads``): the new parameters are then written into the gradients'
memory. Trees are the port's
parameter trees (dicts, tuples and lists of tensors); an int8 moment is a
``{"q", "s"}`` dict where the parameter has a tensor.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass

import torch
import torch.nn.functional as F

QBLOCK = 2048


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # float32 | bfloat16 | int8

    @property
    def mdtype(self):
        return torch.bfloat16 if self.moment_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree``, with the matching nodes of
    ``rest`` (which may hold an int8 moment dict where ``tree`` has a
    tensor); the result has ``tree``'s structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return type(tree)(tree_map(fn, v, *r) for v, *r in zip(tree, *rest))


def tree_leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def stacked_ranks(tree, extra: int = 0):
    """Each leaf's rank in the reference's layout, where a period's
    per-layer tensors are stacked on a leading ``n_periods`` axis (a list
    in the port's trees adds one axis)."""
    if isinstance(tree, torch.Tensor):
        return tree.dim() + extra
    if isinstance(tree, dict):
        return {k: stacked_ranks(v, extra) for k, v in tree.items()}
    inner = extra + isinstance(tree, list)
    return type(tree)(stacked_ranks(v, inner) for v in tree)


# ---------------------------------------------------------------------------
# Blockwise int8 moment (de)quantization
# ---------------------------------------------------------------------------

def _nblocks(n: int) -> int:
    return (n + QBLOCK - 1) // QBLOCK


def scale_shape(shape) -> tuple:
    """Scales block along the last axis only, so the int8 payload keeps the
    parameter's shape."""
    if not shape:
        return (1,)
    return tuple(shape[:-1]) + (_nblocks(shape[-1]),)


def quantize_blockwise(x32: torch.Tensor) -> dict:
    """x32: any-shape float32 → {"q": int8[x.shape], "s": f32[scale_shape]}."""
    shape = tuple(x32.shape)
    if not shape:
        x32 = x32.reshape(1)
        shape = (1,)
    last = shape[-1]
    nb = _nblocks(last)
    pad = nb * QBLOCK - last
    xp = F.pad(x32, (0, pad)) if pad else x32
    blocks = xp.reshape(*shape[:-1], nb, QBLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-20)[..., None])
    q = q.clamp(-127, 127).to(torch.int8)
    q = q.reshape(*shape[:-1], nb * QBLOCK)[..., :last]
    return {"q": q, "s": scale}


def dequantize_blockwise(state: dict, shape) -> torch.Tensor:
    q, scale = state["q"], state["s"]
    if not shape:
        return (q.float() * scale[..., 0]).reshape(())
    last = shape[-1]
    nb = scale.shape[-1]
    pad = nb * QBLOCK - last
    qp = F.pad(q.float(), (0, pad)) if pad else q.float()
    blocks = qp.reshape(*shape[:-1], nb, QBLOCK)
    out = (blocks * scale[..., None]).reshape(*shape[:-1], nb * QBLOCK)
    return out[..., :last]


# ---------------------------------------------------------------------------
# Schedule, state, update
# ---------------------------------------------------------------------------

def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Warmup then cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _zero_moment(p: torch.Tensor, cfg: OptConfig):
    if cfg.moment_dtype == "int8":
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(scale_shape(tuple(p.shape)), dtype=torch.float32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=cfg.mdtype, device=p.device)


def init_opt_state(params, cfg: OptConfig) -> dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(lambda p: _zero_moment(p, cfg), params),
            "v": tree_map(lambda p: _zero_moment(p, cfg), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _chunks(leaves, limit: int = 1 << 26):
    """Index lists over ``leaves`` of at most ``limit`` elements each (a
    larger leaf alone): the float32 temporaries of a chunk stay bounded."""
    chunk, size = [], 0
    for i, t in enumerate(leaves):
        if chunk and size + t.numel() > limit:
            yield chunk
            chunk, size = [], 0
        chunk.append(i)
        size += t.numel()
    if chunk:
        yield chunk


# Elements a float32 norm sums at once on the CPU: PyTorch's CPU reduction
# drifts with length (about 3.5e-4 relative at 1e7 elements, 0.9% at 1e8;
# probe_train_parity.py --cpu-norm), where runs of 2^16 stay near 2e-7. On
# the card it is a tree, and a leaf is one run.
NORM_RUN = 1 << 16


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, as a float32 scalar: float32
    norms of each leaf (of runs of ``NORM_RUN`` elements on the CPU), their
    squares summed in float64."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    sq = []
    for idx in _chunks(leaves):
        terms = [leaves[i].float() for i in idx]
        if terms[0].device.type == "cpu":
            terms = [run for t in terms for run in t.reshape(-1).split(NORM_RUN)]
        norms = torch._foreach_norm(terms)
        sq.append(torch.stack(norms).double().square().sum())
    return torch.sqrt(torch.stack(sq).sum()).float()


def _donatable(ps, gs) -> list[bool]:
    """Which gradients can take their parameter's new value in place: a
    dense tensor of the parameter's shape and dtype that fills its memory,
    which no other gradient shares (autograd may hand one tensor to two
    inputs of a sum)."""
    owners = Counter(g.untyped_storage().data_ptr() for g in gs)
    return [g.dtype == p.dtype and g.shape == p.shape and g.is_contiguous()
            and g.untyped_storage().nbytes() == g.numel() * g.element_size()
            and owners[g.untyped_storage().data_ptr()] == 1 for p, g in zip(ps, gs)]


def _adam_float(ps, gs, ms, vs, decay, cfg: OptConfig, scale, lr, bc1, bc2, into):
    """The reference's per-leaf AdamW arithmetic on lists of leaves (float32
    or bfloat16 moments), op for op in float32 through ``torch._foreach``
    kernels, a bounded chunk of leaves at a time: a few launches a chunk
    where one a leaf and an op would cost the host thousands. Returns the
    new params, m and v as lists; a new parameter is written into its
    gradient where ``into`` says so (after the chunk has read that
    gradient), and no other input is written."""
    b1, b2, wd = cfg.b1, cfg.b2, cfg.weight_decay
    new_p, new_m, new_v = [None] * len(ps), [None] * len(ps), [None] * len(ps)
    for idx in _chunks(ps):
        p32 = [ps[i].float() for i in idx]
        g = torch._foreach_mul([gs[i].float() for i in idx], scale)
        m = torch._foreach_mul([ms[i].float() for i in idx], b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul([vs[i].float() for i in idx], b2)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_add_(v, sq)
        del g, sq
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, den)
        del den
        dec = [j for j, i in enumerate(idx) if decay[i]]
        if wd > 0 and dec:
            torch._foreach_add_([upd[j] for j in dec],
                                torch._foreach_mul([p32[j] for j in dec], wd))
        torch._foreach_mul_(upd, lr)
        newp = torch._foreach_sub(p32, upd)
        for j, i in enumerate(idx):
            new_p[i] = gs[i].copy_(newp[j]) if into[i] else newp[j].to(ps[i].dtype)
            new_m[i], new_v[i] = m[j].to(cfg.mdtype), v[j].to(cfg.mdtype)
    return new_p, new_m, new_v


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig, *, donate_grads: bool = False):
    """Returns (new_params, new_state, metrics); nothing is updated in place
    unless ``donate_grads``: then ``grads`` are the caller's to lose, and
    each new parameter is written into its gradient's memory where
    :func:`_donatable` allows it, so that the update holds one
    parameter-sized tree fewer at its peak (params, gradients, moments and
    new moments: 20 bytes a parameter in bf16 with float32 moments, not 22).
    The train step donates; the default keeps the reference's pure update,
    which the tests hold the port to leaf for leaf. Weight decay applies to
    tensors of rank 2 and more in the reference's stacked layout
    (:func:`stacked_ranks`), as the reference applies it: a period's norm
    scales decay, ``final_ln`` does not."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, device=stepf.device), stepf)
    # Leaves in the params' order, whatever the key order of the other trees.
    decay = [r >= 2 for r in tree_leaves_of(stacked_ranks(params), params)]
    ps, gs = tree_leaves(params), tree_leaves_of(grads, params)
    ms, vs = tree_leaves_of(state["m"], params), tree_leaves_of(state["v"], params)
    into = _donatable(ps, gs) if donate_grads else [False] * len(ps)
    if cfg.moment_dtype == "int8":
        out = [_adam_int8(*leaf, cfg, scale, lr, bc1, bc2)
               for leaf in zip(ps, gs, ms, vs, decay, into)]
        new_p, new_m, new_v = (list(x) for x in zip(*out)) if out else ([], [], [])
    else:
        new_p, new_m, new_v = _adam_float(ps, gs, ms, vs, decay, cfg, scale, lr, bc1, bc2,
                                          into)
    return (_unflatten(params, new_p),
            {"m": _unflatten(params, new_m), "v": _unflatten(params, new_v), "step": step},
            {"lr": lr, "grad_norm": gnorm})


def _adam_int8(p, g, m, v, decay: bool, into: bool, cfg: OptConfig, scale, lr, bc1, bc2):
    """One leaf with blockwise int8 moments: dequantize, the float32 update,
    quantize; the new parameter written into ``g`` when ``into``."""
    grad = g
    g = g.float() * scale
    shape = tuple(p.shape)
    m32 = cfg.b1 * dequantize_blockwise(m, shape) + (1 - cfg.b1) * g
    v32 = cfg.b2 * dequantize_blockwise(v, shape) + (1 - cfg.b2) * torch.square(g)
    update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    if cfg.weight_decay > 0 and decay:
        update = update + cfg.weight_decay * p.float()
    new_p = p.float() - lr * update
    new_p = grad.copy_(new_p) if into else new_p.to(p.dtype)
    return new_p, quantize_blockwise(m32), quantize_blockwise(v32)


def tree_leaves_of(tree, like) -> list:
    """The leaves of ``tree`` at the tensor leaves of ``like`` (which fixes
    the structure), whatever they are: ints, int8 moment dicts."""
    out: list = []
    tree_map(lambda _, x: out.append(x), like, tree)
    return out


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
