"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window
attention. 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
[arXiv:2401.16818; hf]

Port of ``repro/configs/h2o_danube_1_8b.py``; the field values are the
same. SWA (window 4096) bounds the decode cache to a ring of the window;
head_dim 80 runs through ``flash_attention``'s D = 80 instantiations.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig

_LAYER = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=32, n_kv_heads=8, head_dim=80, window=4096,
                 rope_theta=1e4),
    ffn_kind="dense",
    dense=DenseFfnCfg(d_ff=6912, kind="swiglu"),
)

CONFIG = ModelConfig(
    name="h2o_danube_1_8b",
    d_model=2560,
    vocab=32000,
    prefix=(),
    period=(_LAYER,),
    n_periods=24,
    tie_embeddings=False,
    rules_name="tp",
    long_context_ok=True,
    notes="mistral-style SWA-4096; ring-buffer decode cache",
)


def reduced() -> ModelConfig:
    layer = replace(_LAYER,
                    attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16,
                                 window=32),
                    dense=DenseFfnCfg(d_ff=96, kind="swiglu"))
    return replace(CONFIG, d_model=64, vocab=256, period=(layer,),
                   n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
