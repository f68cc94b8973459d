"""internvl2-76b [vlm] — InternViT-6B + Hermes-Llama3-70B backbone.
Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[arXiv:2404.16821; unverified]

Port of ``repro/configs/internvl2_76b.py``; the field values are the same.
The vision frontend is a stub, as in the reference: the inputs are
precomputed patch embeddings (B, S, d_model), one (B, d_model) embedding a
decode step, and the model has no input table (``embed`` is an empty
dict). 69.5 B parameters (139 GB in bf16): one card serves it cut in
depth, as ``serve(..., params=...)`` runs at the depth of the params given.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig

_LAYER = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128, rope_theta=5e5),
    ffn_kind="dense",
    dense=DenseFfnCfg(d_ff=28672, kind="swiglu"),
)

CONFIG = ModelConfig(
    name="internvl2_76b",
    d_model=8192,
    vocab=128256,
    prefix=(),
    period=(_LAYER,),
    n_periods=80,
    frontend="embeds",
    tie_embeddings=False,
    rules_name="fsdp",
    long_context_ok=False,
    notes="VLM backbone; patch-embedding frontend stubbed per assignment",
)


def reduced() -> ModelConfig:
    layer = replace(_LAYER,
                    attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16),
                    dense=DenseFfnCfg(d_ff=128, kind="swiglu"))
    return replace(CONFIG, d_model=64, vocab=512, period=(layer,),
                   n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
