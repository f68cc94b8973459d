"""Transformer blocks (port of ``repro/models/blocks.py``, the attention +
dense-FFN half): param specs, cache specs, and the train/prefill and decode
paths with KV-cache handling.

Every projection runs through ``tile_matmul`` and prefill attention through
``flash_attention`` (on CUDA tensors). The MLA, Mamba and MoE branches are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels.tile_matmul.ops import matmul
from repro_torch.models.attention import AttnCfg, decode_attention, gqa_attention
from repro_torch.models.common import ParamSpec, apply_rope, norm_spec, rms_norm
from repro_torch.models.mlp import DenseFfnCfg, dense_ffn, dense_ffn_specs

_MLA = "MLA attention is not ported yet (ROADMAP.md, 'Rest of the zoo')"
_MAMBA = "Mamba-2 blocks are not ported yet (ROADMAP.md, 'Mamba-2 serving')"
_MOE = "MoE FFN is not ported yet (ROADMAP.md, 'Rest of the zoo')"


@dataclass(frozen=True)
class LayerCfg:
    mixer: str                       # "attn" | "mamba"
    attn: AttnCfg | None = None
    mamba: Any = None                # MambaCfg once Mamba-2 is ported
    ffn_kind: str = "none"           # "dense" | "moe" | "none"
    dense: DenseFfnCfg | None = None
    moe: Any = None                  # MoECfg once MoE is ported
    post_norm: bool = False          # gemma3 sandwich norms
    parallel: bool = False           # command-r parallel attn+ffn residual


# ---------------------------------------------------------------------------
# Param and cache specs
# ---------------------------------------------------------------------------

def _attn_specs(d: int, a: AttnCfg, dtype) -> dict:
    if a.is_mla:
        raise NotImplementedError(_MLA)
    s: dict = {
        "ln": norm_spec(d),
        "wq": ParamSpec((d, a.n_heads * a.head_dim), ("embed", "heads"), dtype),
        "wk": ParamSpec((d, a.n_kv_heads * a.head_dim), ("embed", "kv_heads"),
                        dtype),
        "wv": ParamSpec((d, a.n_kv_heads * a.head_dim), ("embed", "kv_heads"),
                        dtype),
        "wo": ParamSpec((a.n_heads * a.head_dim, d), ("heads", "embed"), dtype),
    }
    if a.bias:
        s |= {
            "bq": ParamSpec((a.n_heads * a.head_dim,), ("heads",), dtype,
                            init="zeros"),
            "bk": ParamSpec((a.n_kv_heads * a.head_dim,), ("kv_heads",), dtype,
                            init="zeros"),
            "bv": ParamSpec((a.n_kv_heads * a.head_dim,), ("kv_heads",), dtype,
                            init="zeros"),
        }
    if a.qk_norm:
        s |= {"q_norm": norm_spec(a.head_dim), "k_norm": norm_spec(a.head_dim)}
    return s


def block_specs(d: int, lcfg: LayerCfg, dtype) -> dict:
    if lcfg.mixer != "attn":
        raise NotImplementedError(_MAMBA)
    s: dict = {"attn": _attn_specs(d, lcfg.attn, dtype)}
    if lcfg.post_norm:
        s["attn"]["post_ln"] = norm_spec(d)
    if lcfg.ffn_kind == "moe":
        raise NotImplementedError(_MOE)
    if lcfg.ffn_kind == "dense":
        s["ffn"] = {"ln": norm_spec(d)} | dense_ffn_specs(d, lcfg.dense, dtype)
        if lcfg.post_norm:
            s["ffn"]["post_ln"] = norm_spec(d)
    return s


def cache_specs(lcfg: LayerCfg, batch: int, cache_len: int, dtype) -> dict:
    if lcfg.mixer != "attn":
        raise NotImplementedError(_MAMBA)
    a = lcfg.attn
    if a.is_mla:
        raise NotImplementedError(_MLA)
    S = min(cache_len, a.window) if a.window > 0 else cache_len
    kv = ParamSpec((batch, S, a.n_kv_heads, a.head_dim),
                   ("batch", "kv_seq", "kv_heads", None), dtype, init="zeros")
    return {"k": kv, "v": kv}


# ---------------------------------------------------------------------------
# Attention paths
# ---------------------------------------------------------------------------

def _qkv(h, p, a: AttnCfg, positions):
    B, T, _ = h.shape
    q = matmul(h, p["wq"], p.get("bq")).reshape(B, T, a.n_heads, a.head_dim)
    k = matmul(h, p["wk"], p.get("bk")).reshape(B, T, a.n_kv_heads, a.head_dim)
    v = matmul(h, p["wv"], p.get("bv")).reshape(B, T, a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def attn_core(p, h, lcfg: LayerCfg, pos0: int = 0, want_cache: bool = False,
              q_chunk: int = 512, kv_chunk: int = 512):
    """Attention on already-normed input ``h``; returns (out, cache)."""
    a = lcfg.attn
    if a.is_mla:
        raise NotImplementedError(_MLA)
    B, T, _ = h.shape
    positions = pos0 + torch.arange(T, device=h.device)[None, :]
    q, k, v = _qkv(h, p, a, positions)
    out = gqa_attention(q, k, v, a, q_offset=pos0, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
    out = matmul(out.reshape(B, T, -1), p["wo"])
    cache = {"k": k, "v": v} if want_cache else None
    if lcfg.post_norm:
        out = rms_norm(out, p["post_ln"])
    return out, cache


def attn_train(p, x, lcfg: LayerCfg, pos0: int = 0, want_cache: bool = False,
               q_chunk: int = 512, kv_chunk: int = 512):
    out, cache = attn_core(p, rms_norm(x, p["ln"]), lcfg, pos0, want_cache,
                           q_chunk, kv_chunk)
    return x + out, cache


def _ring_store(full, window: int):
    """Reorder the last ``window`` entries so the entry at absolute position
    p sits at slot p % window (decode-compatible ring layout)."""
    T = full.shape[1]
    W = min(window, T)
    tail = full[:, T - W:]
    pos = (T - W + torch.arange(W, device=full.device)) % W
    out = torch.zeros_like(tail)
    out[:, pos] = tail
    return out


def attn_cache_from_prefill(cache_full: dict, lcfg: LayerCfg) -> dict:
    a = lcfg.attn
    if a.window <= 0:
        return cache_full
    return {k: _ring_store(v, a.window) for k, v in cache_full.items()}


def _attn_decode_core(p, h, cache, cur_len: int, lcfg: LayerCfg):
    """h: (B, d) already normed. Returns (out (B, d), cache). The cache is
    updated in place: the decode loop owns it, as the reference donates it."""
    a = lcfg.attn
    if a.is_mla:
        raise NotImplementedError(_MLA)
    B = h.shape[0]
    positions = torch.full((B, 1), cur_len, dtype=torch.int64, device=h.device)
    q, k, v = _qkv(h[:, None], p, a, positions)
    S = cache["k"].shape[1]
    idx = cur_len % S
    cache["k"][:, idx] = k[:, 0]
    cache["v"][:, idx] = v[:, 0]
    valid = min(cur_len + 1, S)
    out = decode_attention(q[:, 0], cache["k"], cache["v"], valid, a)
    out = matmul(out.reshape(B, -1), p["wo"])
    if lcfg.post_norm:
        out = rms_norm(out, p["post_ln"])
    return out, cache


def attn_decode(p, x, cache, cur_len: int, lcfg: LayerCfg):
    """x: (B, d); cur_len — tokens already in the cache."""
    out, cache = _attn_decode_core(p, rms_norm(x, p["ln"]), cache, cur_len,
                                   lcfg)
    return x + out, cache


# ---------------------------------------------------------------------------
# FFN + full block
# ---------------------------------------------------------------------------

def ffn_core(p, h, lcfg: LayerCfg):
    """FFN on already-normed input; returns (out, aux)."""
    if lcfg.ffn_kind != "dense":
        raise NotImplementedError(_MOE)
    out = dense_ffn(h, p, lcfg.dense)
    if lcfg.post_norm:
        out = rms_norm(out, p["post_ln"])
    return out, 0.0


def ffn_apply(p, x, lcfg: LayerCfg):
    """Pre-norm residual FFN. Returns (x', aux_loss)."""
    if lcfg.ffn_kind == "none":
        return x, 0.0
    out, aux = ffn_core(p, rms_norm(x, p["ln"]), lcfg)
    return x + out, aux


def block_train(p, x, lcfg: LayerCfg, pos0: int = 0, want_cache: bool = False,
                q_chunk: int = 512, kv_chunk: int = 512):
    """Full block for train/prefill. Returns (x, aux, cache|None)."""
    if lcfg.mixer != "attn":
        raise NotImplementedError(_MAMBA)
    if lcfg.parallel and lcfg.ffn_kind != "none":
        # Command-R parallel residual: shared input norm, summed branches.
        h = rms_norm(x, p["attn"]["ln"])
        a_out, cache = attn_core(p["attn"], h, lcfg, pos0, want_cache,
                                 q_chunk, kv_chunk)
        f_out, aux = ffn_core(p["ffn"], h, lcfg)
        return x + a_out + f_out, aux, cache
    x, cache = attn_train(p["attn"], x, lcfg, pos0, want_cache, q_chunk,
                          kv_chunk)
    x, aux = ffn_apply(p.get("ffn"), x, lcfg)
    return x, aux, cache


def block_decode(p, x, cache, cur_len: int, lcfg: LayerCfg):
    if lcfg.mixer != "attn":
        raise NotImplementedError(_MAMBA)
    if lcfg.parallel and lcfg.ffn_kind != "none":
        h = rms_norm(x, p["attn"]["ln"])
        a_out, cache = _attn_decode_core(p["attn"], h, cache, cur_len, lcfg)
        f_out, _ = ffn_core(p["ffn"], h[:, None], lcfg)
        return x + a_out + f_out[:, 0], cache
    x, cache = attn_decode(p["attn"], x, cache, cur_len, lcfg)
    x2, _ = ffn_apply(p.get("ffn"), x[:, None], lcfg)
    return x2[:, 0], cache
