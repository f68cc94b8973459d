"""Attention math (port of ``repro/models/attention.py``): chunked online-
softmax attention for train/prefill and dense decode attention over a
(possibly ring-buffered) KV cache.

On a CUDA tensor :func:`gqa_attention` runs the hand-written
``flash_attention`` kernel in the grouped layout (each K/V tile serves the G
query heads of its KV head, no KV repeat). On a CPU tensor it runs
:func:`chunked_attention`, the plain twin of the same algorithm. Decode
attention, and MLA's absorbed decode over the latent cache
(:func:`mla_decode_attention`), stay plain PyTorch in float32, as the
reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import soft_cap

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0            # 0 = full attention; >0 = sliding window
    rope_theta: float = 1e4
    qk_norm: bool = False
    softcap: float = 0.0
    bias: bool = False         # qkv projection bias (qwen-style)
    # MLA (DeepSeek-V2); when kv_lora_rank > 0 the MLA path is used.
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 512):
    """Online-softmax attention in flat-head layout.

    q: (B, Tq, H, Dk); k: (B, Tkv, H, Dk); v: (B, Tkv, H, Dv) →
    (B, Tq, H, Dv). GQA callers repeat KV heads to H first. Ragged tails are
    padded to the chunk grid; padded keys are masked, padded queries
    dropped. ``q_offset`` is the absolute position of q[0] relative to k[0].
    """
    B, Tq, H, Dk = q.shape
    Tkv = k.shape[1]
    Dv = v.shape[-1]
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tkv)
    Tq_real, Tkv_real = Tq, Tkv
    pad_q = (-Tq) % q_chunk
    pad_kv = (-Tkv) % kv_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        Tq += pad_q
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        Tkv += pad_kv
    scale = 1.0 / (Dk ** 0.5)
    dev = q.device

    outs = []
    for q0 in range(0, Tq, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk]                        # (B, Cq, H, Dk)
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, Dv), dtype=torch.float32, device=dev)
        for k0 in range(0, Tkv, kv_chunk):
            k_blk = k[:, k0:k0 + kv_chunk]
            v_blk = v[:, k0:k0 + kv_chunk]
            kv_pos = k0 + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(),
                             k_blk.float()) * scale
            if softcap > 0:
                s = soft_cap(s, softcap)
            mask = (kv_pos[None, :] < Tkv_real)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            mask = mask.expand(q_chunk, kv_chunk)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(),
                              v_blk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))    # (B, Cq, H, Dv)
    return torch.cat(outs, dim=1)[:, :Tq_real]


def gqa_attention(q, k, v, cfg: AttnCfg, *, q_offset: int = 0,
                  q_chunk: int = 512, kv_chunk: int = 512):
    """q: (B, T, Hq, Dk) → (B, T, Hq, Dv); k/v: (B, T, Hkv, D*)."""
    B, T, Hq, _ = q.shape
    if q.device.type != "cpu":
        return flash_ops.attention(q, k, v, causal=True, window=cfg.window,
                                   softcap=cfg.softcap, q_offset=q_offset)
    G = Hq // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    out = chunked_attention(q, k, v, causal=True, window=cfg.window,
                            softcap=cfg.softcap, q_offset=q_offset,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.reshape(B, T, Hq, -1)


def decode_attention(q, k_cache, v_cache, valid_len: int, cfg: AttnCfg):
    """q: (B, Hq, Dk); caches: (B, S, Hkv, D*); ``valid_len`` — number of
    valid cache slots (ring caches pass the full capacity)."""
    B, S, Hkv, Dk = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Dk)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) / (Dk ** 0.5)
    if cfg.softcap > 0:
        s = soft_cap(s, cfg.softcap)
    valid = torch.arange(S, device=q.device) < valid_len
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, -1).to(q.dtype)


def mla_decode_attention(q_nope, q_rope, c_cache, krope_cache, w_uk, w_uv,
                         valid_len: int, cfg: AttnCfg):
    """Absorbed MLA decode (DeepSeek-V2's low-rank KV joint compression):
    attention runs in the latent space, over a cache of R + Dr values a
    token instead of 2 H D.

    q_nope: (B, H, Dn); q_rope: (B, H, Dr); c_cache: (B, S, R);
    krope_cache: (B, S, Dr); w_uk: (R, H, Dn); w_uv: (R, H, Dv) →
    (B, H, Dv) in q's dtype; scale 1/sqrt(Dn + Dr)."""
    S = c_cache.shape[1]
    scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    c = c_cache.float()
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk.float())    # (B, H, R)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), krope_cache.float())) * scale
    valid = torch.arange(S, device=c.device) < valid_len
    s = torch.where(valid[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhs,bsr->bhr", p.to(c_cache.dtype).float(), c)
    return torch.einsum("bhr,rhv->bhv", out_lat, w_uv.float()).to(q_nope.dtype)
