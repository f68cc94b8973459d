"""smollm-360m [dense] — llama-arch small. 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152. [hf:HuggingFaceTB/SmolLM-360M; hf]

Port of ``repro/configs/smollm_360m.py``; the field values are the same.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig

_LAYER = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=15, n_kv_heads=5, head_dim=64, rope_theta=1e4),
    ffn_kind="dense",
    dense=DenseFfnCfg(d_ff=2560, kind="swiglu"),
)

CONFIG = ModelConfig(
    name="smollm_360m",
    d_model=960,
    vocab=49152,
    prefix=(),
    period=(_LAYER,),
    n_periods=32,
    tie_embeddings=True,
    rules_name="dp_attn",
    long_context_ok=False,
    notes="llama-family small; DP-dominant sharding (15 heads)",
)


def reduced() -> ModelConfig:
    layer = replace(_LAYER,
                    attn=AttnCfg(n_heads=3, n_kv_heads=1, head_dim=16),
                    dense=DenseFfnCfg(d_ff=96, kind="swiglu"))
    return replace(CONFIG, d_model=48, vocab=256, period=(layer,),
                   n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
