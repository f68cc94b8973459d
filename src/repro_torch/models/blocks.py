"""Transformer/SSM blocks (port of ``repro/models/blocks.py``, the attention,
Mamba-2, dense-FFN and MoE branches): param specs, cache specs, and the
train/prefill and decode paths with KV/SSM cache handling.

Every projection runs through ``tile_matmul`` (a MoE layer's expert
products through its batched launch; MLA's up-projections of the latent
``c`` with ``w_uk`` / ``w_uv`` read as (R, H D) matrices), prefill attention
through ``flash_attention`` (MLA's at q/k head dim qk_nope + qk_rope, v head
dim v_head_dim) and the prefill SSD scan through ``ssd_scan`` (on CUDA
tensors). MLA's decode attends in the latent space
(:func:`~repro_torch.models.attention.mla_decode_attention`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.tile_matmul.ops import matmul
from repro_torch.models.attention import (AttnCfg, decode_attention, gqa_attention,
                                          mla_decode_attention)
from repro_torch.models.common import ParamSpec, apply_rope, norm_spec, rms_norm
from repro_torch.models.mamba2 import (MambaCfg, _causal_conv, mamba_specs,
                                       ssd_chunked, ssd_decode_step)
from repro_torch.models.mlp import DenseFfnCfg, dense_ffn, dense_ffn_specs
from repro_torch.models.moe import MoECfg, moe_ffn, moe_specs


@dataclass(frozen=True)
class LayerCfg:
    mixer: str                       # "attn" | "mamba"
    attn: AttnCfg | None = None
    mamba: MambaCfg | None = None
    ffn_kind: str = "none"           # "dense" | "moe" | "none"
    dense: DenseFfnCfg | None = None
    moe: MoECfg | None = None
    post_norm: bool = False          # gemma3 sandwich norms
    parallel: bool = False           # command-r parallel attn+ffn residual


# ---------------------------------------------------------------------------
# Param and cache specs
# ---------------------------------------------------------------------------

def _mla_specs(d: int, a: AttnCfg, dtype) -> dict:
    qd = a.qk_nope_dim + a.qk_rope_dim
    return {
        "ln": norm_spec(d),
        "wq": ParamSpec((d, a.n_heads * qd), ("embed", "heads"), dtype),
        "w_dkv": ParamSpec((d, a.kv_lora_rank + a.qk_rope_dim), ("embed", None), dtype),
        "ln_ckv": norm_spec(a.kv_lora_rank),
        "w_uk": ParamSpec((a.kv_lora_rank, a.n_heads, a.qk_nope_dim),
                          (None, "heads", None), dtype),
        "w_uv": ParamSpec((a.kv_lora_rank, a.n_heads, a.v_head_dim),
                          (None, "heads", None), dtype),
        "wo": ParamSpec((a.n_heads * a.v_head_dim, d), ("heads", "embed"), dtype),
    }


def _attn_specs(d: int, a: AttnCfg, dtype) -> dict:
    if a.is_mla:
        return _mla_specs(d, a, dtype)
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
    s: dict = {}
    if lcfg.mixer == "attn":
        s["attn"] = _attn_specs(d, lcfg.attn, dtype)
        if lcfg.post_norm:
            s["attn"]["post_ln"] = norm_spec(d)
    else:
        s["mamba"] = {"ln": norm_spec(d)} | mamba_specs(d, lcfg.mamba, dtype)
    if lcfg.ffn_kind == "dense":
        s["ffn"] = {"ln": norm_spec(d)} | dense_ffn_specs(d, lcfg.dense, dtype)
    elif lcfg.ffn_kind == "moe":
        s["ffn"] = {"ln": norm_spec(d)} | moe_specs(d, lcfg.moe, dtype)
    if lcfg.ffn_kind != "none" and lcfg.post_norm:
        s["ffn"]["post_ln"] = norm_spec(d)
    return s


def cache_specs(lcfg: LayerCfg, batch: int, cache_len: int, dtype) -> dict:
    if lcfg.mixer == "attn":
        a = lcfg.attn
        S = min(cache_len, a.window) if a.window > 0 else cache_len
        if a.is_mla:
            return {
                "c": ParamSpec((batch, S, a.kv_lora_rank), ("batch", "kv_seq", None),
                               dtype, init="zeros"),
                "kr": ParamSpec((batch, S, a.qk_rope_dim), ("batch", "kv_seq", None),
                                dtype, init="zeros"),
            }
        kv = ParamSpec((batch, S, a.n_kv_heads, a.head_dim),
                       ("batch", "kv_seq", "kv_heads", None), dtype, init="zeros")
        return {"k": kv, "v": kv}
    m = lcfg.mamba
    gn = m.n_groups * m.d_state
    K = m.d_conv - 1
    return {
        "state": ParamSpec((batch, m.n_heads, m.head_dim, m.d_state),
                           ("batch", "heads", None, None), torch.float32,
                           init="zeros"),
        "cx": ParamSpec((batch, K, m.d_inner), ("batch", None, "mlp"), dtype,
                        init="zeros"),
        "cB": ParamSpec((batch, K, gn), ("batch", None, None), dtype,
                        init="zeros"),
        "cC": ParamSpec((batch, K, gn), ("batch", None, None), dtype,
                        init="zeros"),
    }


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


def _mla_qkv(h, p, a: AttnCfg, positions):
    """MLA's query halves and latent: q_nope (B, T, H, Dn), q_rope (B, T, H,
    Dr) rotated, c = rms_norm of the first R columns of h w_dkv (B, T, R),
    and the shared rope key kr (B, T, Dr) from its last Dr, rotated."""
    B, T, _ = h.shape
    q = matmul(h, p["wq"]).reshape(B, T, a.n_heads, a.qk_nope_dim + a.qk_rope_dim)
    q_nope, q_rope = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, a.rope_theta)
    dkv = matmul(h, p["w_dkv"])
    c = rms_norm(dkv[..., :a.kv_lora_rank], p["ln_ckv"])
    kr = apply_rope(dkv[..., None, a.kv_lora_rank:], positions, a.rope_theta)
    return q_nope, q_rope, c, kr[..., 0, :]


def _mla_attention(p, h, a: AttnCfg, positions, pos0: int, q_chunk: int, kv_chunk: int):
    """MLA prefill: k = [c w_uk, kr on every head], v = c w_uv (``w_uk`` and
    ``w_uv`` read as (R, H D) matrices), attention at q/k head dim Dn + Dr and
    v head dim Dv. Returns (out (B, T, H, Dv), c, kr)."""
    B, T, _ = h.shape
    H, R = a.n_heads, a.kv_lora_rank
    q_nope, q_rope, c, kr = _mla_qkv(h, p, a, positions)
    k_nope = matmul(c, p["w_uk"].reshape(R, H * a.qk_nope_dim)).reshape(B, T, H, -1)
    v = matmul(c, p["w_uv"].reshape(R, H * a.v_head_dim)).reshape(B, T, H, -1)
    k = torch.cat([k_nope, kr[:, :, None].expand(B, T, H, a.qk_rope_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    out = gqa_attention(q, k, v, a, q_offset=pos0, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out, c, kr


def attn_core(p, h, lcfg: LayerCfg, pos0: int = 0, want_cache: bool = False,
              q_chunk: int = 512, kv_chunk: int = 512):
    """Attention on already-normed input ``h``; returns (out, cache)."""
    a = lcfg.attn
    B, T, _ = h.shape
    positions = pos0 + torch.arange(T, device=h.device)[None, :]
    if a.is_mla:
        out, c, kr = _mla_attention(p, h, a, positions, pos0, q_chunk, kv_chunk)
        cache = {"c": c, "kr": kr} if want_cache else None
    else:
        q, k, v = _qkv(h, p, a, positions)
        out = gqa_attention(q, k, v, a, q_offset=pos0, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
        cache = {"k": k, "v": v} if want_cache else None
    out = matmul(out.reshape(B, T, -1), p["wo"])
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
    B = h.shape[0]
    positions = torch.full((B, 1), cur_len, dtype=torch.int64, device=h.device)
    if a.is_mla:
        q_nope, q_rope, c, kr = _mla_qkv(h[:, None], p, a, positions)
        S = cache["c"].shape[1]
        idx = cur_len % S
        cache["c"][:, idx] = c[:, 0]
        cache["kr"][:, idx] = kr[:, 0]
        out = mla_decode_attention(q_nope[:, 0], q_rope[:, 0], cache["c"], cache["kr"],
                                   p["w_uk"], p["w_uv"], min(cur_len + 1, S), a)
    else:
        q, k, v = _qkv(h[:, None], p, a, positions)
        S = cache["k"].shape[1]
        idx = cur_len % S
        cache["k"][:, idx] = k[:, 0]
        cache["v"][:, idx] = v[:, 0]
        out = decode_attention(q[:, 0], cache["k"], cache["v"], min(cur_len + 1, S), a)
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
# Mamba paths
# ---------------------------------------------------------------------------

def _mamba_proj(h, p):
    return (matmul(h, p["w_z"]), matmul(h, p["w_x"]), matmul(h, p["w_B"]),
            matmul(h, p["w_C"]), matmul(h, p["w_dt"]))


def _ssd(x4, dt, A, B5, C5, D, chunk: int):
    """The SSD scan: ``ssd_chunked`` on the CPU, the ``ssd_scan`` kernel on
    the card. The kernel's final state is (B, H, N, P) and the cache's
    (B, H, P, N), as ``ssd_chunked`` returns it, so it is transposed here."""
    if x4.device.type == "cpu":
        return ssd_chunked(x4, dt, A, B5, C5, D, chunk)
    y, state = ssd_ops.ssd(x4, dt, A, B5, C5, D)
    return y, state.transpose(-1, -2)


def mamba_train(p, x, lcfg: LayerCfg, want_cache: bool = False):
    m = lcfg.mamba
    B, T, _ = x.shape
    h = rms_norm(x, p["ln"])
    z, xin, B_, C_, dt_raw = _mamba_proj(h, p)
    xin_pre, B_pre, C_pre = xin, B_, C_
    xin = F.silu(_causal_conv(xin, p["conv_x"]))
    B_ = F.silu(_causal_conv(B_, p["conv_B"]))
    C_ = F.silu(_causal_conv(C_, p["conv_C"]))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    x4 = xin.reshape(B, T, m.n_heads, m.head_dim)
    B5 = B_.reshape(B, T, m.n_groups, m.d_state)
    C5 = C_.reshape(B, T, m.n_groups, m.d_state)
    y, state = _ssd(x4, dt, A, B5, C5, p["D"], m.chunk)
    y = y.reshape(B, T, m.d_inner)
    y = rms_norm(y * F.silu(z), p["norm_gate"])
    out = matmul(y, p["w_out"])
    cache = None
    if want_cache:
        # Copies, not views: a view of the last K steps would keep the whole
        # (B, T, d_inner) projection of every layer alive with the cache.
        K = m.d_conv - 1
        cache = {"state": state,
                 "cx": xin_pre[:, T - K:].clone(), "cB": B_pre[:, T - K:].clone(),
                 "cC": C_pre[:, T - K:].clone()}
    return x + out, cache


def _conv_step(buf, new, kernel):
    """buf: (B, K-1, C) past pre-conv inputs; new: (B, C). Returns conv
    output (B, C) and updated buf."""
    window = torch.cat([buf, new[:, None]], dim=1)            # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window, kernel)
    return out, window[:, 1:]


def mamba_decode(p, x, cache, lcfg: LayerCfg):
    """x: (B, d). The cache dict's entries are replaced in place: the decode
    loop owns the cache, as the reference donates it."""
    m = lcfg.mamba
    B, _ = x.shape
    h = rms_norm(x, p["ln"])
    z, xin, B_, C_, dt_raw = _mamba_proj(h, p)
    cx_out, ncx = _conv_step(cache["cx"], xin, p["conv_x"])
    cB_out, ncB = _conv_step(cache["cB"], B_, p["conv_B"])
    cC_out, ncC = _conv_step(cache["cC"], C_, p["conv_C"])
    xin = F.silu(cx_out)
    B_ = F.silu(cB_out)
    C_ = F.silu(cC_out)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(
        cache["state"], xin.reshape(B, m.n_heads, m.head_dim), dt, A,
        B_.reshape(B, m.n_groups, m.d_state),
        C_.reshape(B, m.n_groups, m.d_state), p["D"])
    y = y.reshape(B, m.d_inner)
    y = rms_norm(y * F.silu(z), p["norm_gate"])
    out = matmul(y, p["w_out"])
    cache.update(state=state, cx=ncx, cB=ncB, cC=ncC)
    return x + out, cache


# ---------------------------------------------------------------------------
# FFN + full block
# ---------------------------------------------------------------------------

def ffn_core(p, h, lcfg: LayerCfg):
    """FFN on already-normed input; returns (out, aux)."""
    if lcfg.ffn_kind == "dense":
        out, aux = dense_ffn(h, p, lcfg.dense), 0.0
    else:
        B, T, d = h.shape
        out, aux = moe_ffn(h.reshape(B * T, d), p, lcfg.moe)
        out = out.reshape(B, T, d)
    if lcfg.post_norm:
        out = rms_norm(out, p["post_ln"])
    return out, aux


def ffn_apply(p, x, lcfg: LayerCfg):
    """Pre-norm residual FFN. Returns (x', aux_loss)."""
    if lcfg.ffn_kind == "none":
        return x, 0.0
    out, aux = ffn_core(p, rms_norm(x, p["ln"]), lcfg)
    return x + out, aux


def block_train(p, x, lcfg: LayerCfg, pos0: int = 0, want_cache: bool = False,
                q_chunk: int = 512, kv_chunk: int = 512):
    """Full block for train/prefill. Returns (x, aux, cache|None)."""
    if lcfg.parallel and lcfg.mixer == "attn" and lcfg.ffn_kind != "none":
        # Command-R parallel residual: shared input norm, summed branches.
        h = rms_norm(x, p["attn"]["ln"])
        a_out, cache = attn_core(p["attn"], h, lcfg, pos0, want_cache,
                                 q_chunk, kv_chunk)
        f_out, aux = ffn_core(p["ffn"], h, lcfg)
        return x + a_out + f_out, aux, cache
    if lcfg.mixer == "attn":
        x, cache = attn_train(p["attn"], x, lcfg, pos0, want_cache, q_chunk,
                              kv_chunk)
    else:
        x, cache = mamba_train(p["mamba"], x, lcfg, want_cache)
    x, aux = ffn_apply(p.get("ffn"), x, lcfg)
    return x, aux, cache


def block_decode(p, x, cache, cur_len: int, lcfg: LayerCfg):
    if lcfg.parallel and lcfg.mixer == "attn" and lcfg.ffn_kind != "none":
        h = rms_norm(x, p["attn"]["ln"])
        a_out, cache = _attn_decode_core(p["attn"], h, cache, cur_len, lcfg)
        f_out, _ = ffn_core(p["ffn"], h[:, None], lcfg)
        return x + a_out + f_out[:, 0], cache
    if lcfg.mixer == "attn":
        x, cache = attn_decode(p["attn"], x, cache, cur_len, lcfg)
    else:
        x, cache = mamba_decode(p["mamba"], x, cache, lcfg)
    x2, _ = ffn_apply(p.get("ffn"), x[:, None], lcfg)
    return x2[:, 0], cache
