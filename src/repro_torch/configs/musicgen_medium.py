"""musicgen-medium [audio] — decoder-only over EnCodec tokens. 48L
d_model=1536 24H MHA (kv=24) d_ff=6144 (GELU), vocab=2048 per codebook,
4 codebooks. [arXiv:2306.05284; hf]

Port of ``repro/configs/musicgen_medium.py``; the field values are the
same. The EnCodec frontend is a stub, as in the reference: the inputs are
the 4 codebook streams, the embedding the sum of their rows of one
(4 x 2048, d) table, the output 4 per-codebook heads of one untied
(d, 4 x 2048) matrix (``multi_head_xent`` in training). 1.38 B parameters
(2.8 GB in bf16): served whole on one card. Its FFN is the first served
GELU with biases, fused into ``tile_matmul``'s epilogue.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig

_LAYER = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=24, n_kv_heads=24, head_dim=64, rope_theta=1e4),
    ffn_kind="dense",
    dense=DenseFfnCfg(d_ff=6144, kind="gelu"),
)

CONFIG = ModelConfig(
    name="musicgen_medium",
    d_model=1536,
    vocab=2048,
    prefix=(),
    period=(_LAYER,),
    n_periods=48,
    frontend="codebooks",
    n_codebooks=4,
    tie_embeddings=False,
    rules_name="dp_attn",
    long_context_ok=False,
    notes="EnCodec-token decoder; 4 codebooks summed in, 4 heads out",
)


def reduced() -> ModelConfig:
    layer = replace(_LAYER,
                    attn=AttnCfg(n_heads=4, n_kv_heads=4, head_dim=16),
                    dense=DenseFfnCfg(d_ff=96, kind="gelu"))
    return replace(CONFIG, d_model=64, vocab=64, period=(layer,),
                   n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
