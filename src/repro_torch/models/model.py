"""Unified causal LM (port of ``repro/models/model.py``): ``prefix`` layers
then ``period`` layers repeated ``n_periods`` times, as eager loops.

Parameters are nested dicts keyed like the reference tree (``embed/tok``,
``final_ln``, ``period/<j>/attn/wq``, …). Where the reference stacks a
period's parameters on a leading ``n_periods`` axis and scans, this package
keeps one dict per layer: ``params["period"][j][i]`` is period position
``j`` of repetition ``i``. Caches follow the same layout.

Entry points: :func:`train_loss` (mean next-token NLL through the chunked
cross-entropy, each layer checkpointed as ``remat`` says), :func:`prefill`
(build KV/SSM caches, return last-token logits) and :func:`decode_step` (one
token in, logits out, cache updated in place).

Frontends, as the reference's: ``tokens`` (an LM's table), ``embeds`` (a
VLM's precomputed patch embeddings, no input table) and ``codebooks``
(MusicGen: the sum of the codebooks' rows of one (K·V, d) table in,
K per-codebook heads of one (d, K·V) matrix out).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import _keep
from repro_torch.models.blocks import (LayerCfg, attn_cache_from_prefill,
                                       block_decode, block_specs, block_train,
                                       cache_specs)
from repro_torch.models.common import (ParamSpec, norm_spec, rms_norm,
                                       stack_specs, tree_initialize,
                                       tree_map_specs, tree_spec_leaves)
from repro_torch.models.losses import chunked_softmax_xent, multi_head_xent

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    prefix: tuple[LayerCfg, ...]
    period: tuple[LayerCfg, ...]
    n_periods: int
    frontend: str = "tokens"          # tokens | embeds | codebooks
    n_codebooks: int = 4
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma: h *= sqrt(d)
    param_dtype: str = "bfloat16"
    remat: str = "nothing"            # nothing | dots | none
    q_chunk: int = 512
    kv_chunk: int = 512
    loss_chunk: int = 32768
    rules_name: str = "tp"            # tp | fsdp  (sharding profile)
    long_context_ok: bool = False     # eligible for long_500k
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + self.n_periods * len(self.period)

    @property
    def dtype(self):
        return DTYPES[self.param_dtype]

    @property
    def head_width(self) -> int:
        return (self.vocab * self.n_codebooks
                if self.frontend == "codebooks" else self.vocab)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> dict:
    """Spec tree of the reference, period specs stacked on ``n_periods``:
    the ``codebooks`` frontend's table holds the K codebooks' rows one after
    another, (K·V, d); the ``embeds`` frontend has no input table (``embed``
    is an empty dict); only ``tokens`` may tie the head to its table."""
    dt = cfg.dtype
    if cfg.frontend == "tokens":
        embed = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), dt)}
    elif cfg.frontend == "codebooks":
        embed = {"tok": ParamSpec((cfg.n_codebooks * cfg.vocab, cfg.d_model),
                                  (None, "embed"), dt)}
    else:
        embed = {}
    specs: dict = {"embed": embed}
    specs["prefix"] = tuple(block_specs(cfg.d_model, l, dt) for l in cfg.prefix)
    specs["period"] = tuple(stack_specs(block_specs(cfg.d_model, l, dt),
                                        cfg.n_periods) for l in cfg.period)
    specs["final_ln"] = norm_spec(cfg.d_model)
    if not (cfg.tie_embeddings and cfg.frontend == "tokens"):
        axes = ("embed", None) if cfg.frontend == "codebooks" else ("embed", "vocab")
        specs["head"] = ParamSpec((cfg.d_model, cfg.head_width), axes, dt)
    return specs


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_periods(params: dict, n_periods: int) -> dict:
    """Stacked period leaves (leading ``n_periods`` axis) → one dict per
    layer: ``params["period"][j][i]``."""
    return params | {"period": tuple(
        [_unstack(stacked, i) for i in range(n_periods)]
        for stacked in params["period"])}


def at_depth_of(cfg: ModelConfig, params: dict) -> ModelConfig:
    """``cfg`` at the depth of ``params``: the period cut to the layers
    ``params["period"]`` holds (its first ones) and repeated as often as
    they are stacked, for weights cut in depth to fit one card."""
    period = params["period"]
    if len(period) > len(cfg.period):
        raise ValueError(f"params hold {len(period)} period layers; {cfg.name} has "
                         f"{len(cfg.period)}")
    return dataclasses.replace(cfg, period=cfg.period[:len(period)], n_periods=len(period[0]))


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                dtype_override=None) -> dict:
    stacked = tree_initialize(param_specs(cfg), generator, device,
                              dtype_override)
    return unstack_periods(stacked, cfg.n_periods)


def _head_matrix(params, _cfg: ModelConfig):
    if "head" in params:
        return params["head"]
    return params["embed"]["tok"].T


def _embed(params, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    """The first hidden state from the frontend's ``inputs``: token ids
    (B, T) or (B,); codebook ids (B, T, K) or (B, K), whose K rows
    ``tok + k·V`` are summed; or embeddings (B, T, d) or (B, d), cast to the
    model's dtype."""
    if cfg.frontend == "embeds":
        h = inputs.to(cfg.dtype)
    elif cfg.frontend == "codebooks":
        offs = torch.arange(cfg.n_codebooks, device=inputs.device) * cfg.vocab
        h = params["embed"]["tok"][inputs + offs].sum(dim=-2)
    else:
        h = params["embed"]["tok"][inputs]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def _layers(params, cfg: ModelConfig, caches=None):
    """(lcfg, layer params, layer cache | None) in execution order."""
    for lcfg, p, c in zip(cfg.prefix, params["prefix"],
                          caches["prefix"] if caches else [None] * len(cfg.prefix)):
        yield lcfg, p, c
    for i in range(cfg.n_periods):
        for j, lcfg in enumerate(cfg.period):
            yield (lcfg, params["period"][j][i],
                   caches["period"][j][i] if caches else None)


def _remat(fn, cfg: ModelConfig):
    """The reference's ``_remat`` a layer at a time: ``"nothing"`` keeps only
    the layer's input and recomputes the rest in the backward pass,
    ``"none"`` keeps every activation, and ``"dots"`` keeps the layer's
    input and every kernel forward's output (its products, the attention's
    O and lse, the scan's outputs; the reference's ``checkpoint_dots``)
    and recomputes the rest from them: the layer runs under a
    :class:`~repro_torch.kernels._keep.Tape`, whose docstring says why
    this way and not a selective checkpoint policy."""
    if cfg.remat == "none":
        return fn

    def layer(*args):
        if cfg.remat != "dots":
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        tape = _keep.Tape()

        def run(*a):
            with _keep.playing(tape):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    return layer


def _backbone(params, cfg: ModelConfig, h, want_cache: bool = False):
    """Returns (h, aux, caches|None); caches laid out like the params. Without
    caches (training) each layer runs under ``_remat``."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    flat = []

    def layer(p, h, lcfg):
        h, a, _ = block_train(p, h, lcfg, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        return h, a

    run = _remat(layer, cfg) if not want_cache and torch.is_grad_enabled() else layer
    for lcfg, p, _ in _layers(params, cfg):
        if want_cache:
            h, a, c = block_train(p, h, lcfg, want_cache=True,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
            flat.append(c)
        else:
            h, a = run(p, h, lcfg)
        aux = aux + a
    h = rms_norm(h, params["final_ln"])
    caches = _regroup(cfg, flat) if want_cache else None
    return h, aux, caches


def _regroup(cfg: ModelConfig, flat: list) -> dict:
    """Per-layer list in execution order → {"prefix", "period"[j][i]}."""
    n_pre, width = len(cfg.prefix), len(cfg.period)
    period = tuple([flat[n_pre + i * width + j] for i in range(cfg.n_periods)]
                   for j in range(width))
    return {"prefix": tuple(flat[:n_pre]), "period": period}


def _prompt(cfg: ModelConfig, batch) -> torch.Tensor:
    """The frontend's input of a prefill or training batch."""
    return batch["embeds"] if cfg.frontend == "embeds" else batch["tokens"]


def train_loss(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (B, T) (codebooks: (B, T, K)) or "embeds": (B, T, d),
    "labels": (B, T) (codebooks: (B, T, K))[, "loss_mask": (B, T)]}; the
    codebooks' mean NLL over the K heads takes no mask, as the reference's.
    Returns (loss, {"nll", "aux"}) as float32 scalars."""
    h, aux, _ = _backbone(params, cfg, _embed(params, cfg, _prompt(cfg, batch)))
    B, T, d = h.shape
    flat, head = h.reshape(B * T, d), _head_matrix(params, cfg)
    if cfg.frontend == "codebooks":
        nll, _ = multi_head_xent(flat, head, batch["labels"].reshape(B * T, cfg.n_codebooks),
                                 cfg.n_codebooks, chunk=cfg.loss_chunk)
        return nll + aux, {"nll": nll, "aux": aux}
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.reshape(B * T).float()
    nll, _ = chunked_softmax_xent(flat, head, batch["labels"].reshape(B * T),
                                  chunk=cfg.loss_chunk, mask=mask)
    return nll + aux, {"nll": nll, "aux": aux}


def prefill(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (B, T) (codebooks: (B, T, K))} or {"embeds": (B, T,
    d)}. Returns (cache, last_logits (B, head_width)) with float32 logits."""
    h, _, caches = _backbone(params, cfg, _embed(params, cfg, _prompt(cfg, batch)),
                             want_cache=True)

    def ring(c, lcfg: LayerCfg):
        return attn_cache_from_prefill(c, lcfg) if lcfg.mixer == "attn" else c

    caches = {
        "prefix": tuple(ring(c, l) for l, c in zip(cfg.prefix, caches["prefix"])),
        "period": tuple([ring(c, l) for c in per]
                        for l, per in zip(cfg.period, caches["period"])),
    }
    logits = torch.matmul(h[:, -1], _head_matrix(params, cfg)).float()
    return caches, logits


def decode_step(params, cfg: ModelConfig, cache, batch):
    """batch: {"token": (B,) (codebooks: (B, K))} or {"embed": (B, d)}, and
    "cur_len": int. Returns (logits (B, head_width), cache); the cache
    tensors are updated in place."""
    cur = int(batch["cur_len"])
    h = _embed(params, cfg, batch["embed"] if cfg.frontend == "embeds" else batch["token"])
    for lcfg, p, c in _layers(params, cfg, cache):
        h, _ = block_decode(p, h, c, cur, lcfg)
    h = rms_norm(h, params["final_ln"])
    logits = torch.matmul(h, _head_matrix(params, cfg)).float()
    return logits, cache


# ---------------------------------------------------------------------------
# Caches and counts
# ---------------------------------------------------------------------------

def cache_spec_tree(cfg: ModelConfig, batch: int, cache_len: int):
    dt = cfg.dtype
    pfx = tuple(cache_specs(l, batch, cache_len, dt) for l in cfg.prefix)
    per = tuple(stack_specs(cache_specs(l, batch, cache_len, dt), cfg.n_periods)
                for l in cfg.period)
    return {"prefix": pfx, "period": per}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
               dtype=None) -> dict:
    """Zero caches laid out like the params (``cache["period"][j][i]``)."""
    zeros = tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=dtype or s.dtype, device=device),
        cache_spec_tree(cfg, batch, cache_len))
    return unstack_periods(zeros, cfg.n_periods)


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for s in tree_spec_leaves(param_specs(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: routed experts scaled by top_k/E), as
    the reference's ``active_param_count``: the final norm, and the input
    table and head as the frontend has them."""

    def layer_active(lcfg: LayerCfg) -> int:
        full = sum(math.prod(s.shape)
                   for s in tree_spec_leaves(block_specs(cfg.d_model, lcfg, cfg.dtype)))
        if lcfg.ffn_kind == "moe":
            m = lcfg.moe
            full -= (m.n_experts - m.top_k) * 3 * cfg.d_model * m.d_ff
        return full

    total = sum(layer_active(l) for l in cfg.prefix)
    total += cfg.n_periods * sum(layer_active(l) for l in cfg.period)
    total += cfg.d_model                               # final norm
    if cfg.frontend == "tokens":
        total += cfg.vocab * cfg.d_model
        if not cfg.tie_embeddings:
            total += cfg.d_model * cfg.head_width
    else:
        total += cfg.d_model * cfg.head_width
        if cfg.frontend == "codebooks":
            total += cfg.n_codebooks * cfg.vocab * cfg.d_model
    return total
