"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) head_dim=256
d_ff=15360 vocab=262144; 5:1 local(SWA-1024):global interleave, 128k
context; qk-norm; pre+post (sandwich) norms; embeddings scaled by √d.
[hf:google/gemma-3-12b-pt; unverified]

Port of ``repro/configs/gemma3_12b.py``; the field values are the same.
Period of 6 (5 local + 1 global) × 8. Local layers rope θ=10k; global
θ=1M. head_dim 256 runs through ``flash_attention``'s D = 256
instantiations.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig

_FFN = DenseFfnCfg(d_ff=15360, kind="swiglu")
_LOCAL = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=16, n_kv_heads=8, head_dim=256, window=1024,
                 rope_theta=1e4, qk_norm=True),
    ffn_kind="dense", dense=_FFN, post_norm=True,
)
_GLOBAL = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=16, n_kv_heads=8, head_dim=256, window=0,
                 rope_theta=1e6, qk_norm=True),
    ffn_kind="dense", dense=_FFN, post_norm=True,
)

CONFIG = ModelConfig(
    name="gemma3_12b",
    d_model=3840,
    vocab=262144,
    prefix=(),
    period=(_LOCAL,) * 5 + (_GLOBAL,),
    n_periods=8,
    tie_embeddings=True,
    embed_scale=True,
    rules_name="fsdp",
    long_context_ok=True,
    notes="5:1 local:global; sandwich norms; qk-norm; 262k vocab sharded CE",
)


def reduced() -> ModelConfig:
    loc = replace(_LOCAL,
                  attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16,
                               window=16, qk_norm=True),
                  dense=DenseFfnCfg(d_ff=96, kind="swiglu"))
    glo = replace(_GLOBAL,
                  attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16,
                               qk_norm=True),
                  dense=DenseFfnCfg(d_ff=96, kind="swiglu"))
    return replace(CONFIG, d_model=64, vocab=512,
                   period=(loc,) * 2 + (glo,), n_periods=2,
                   param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
