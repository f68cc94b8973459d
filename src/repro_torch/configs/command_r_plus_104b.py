"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no biases, parallel attn+ffn residual blocks,
tied embeddings. [hf:CohereForAI/c4ai-command-r-plus; unverified]

Port of ``repro/configs/command_r_plus_104b.py``; the field values are the
same. A parallel block shares one input norm between its two branches;
its ``ffn/ln`` is kept in the tree and unused, as in the reference.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig

_LAYER = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=96, n_kv_heads=8, head_dim=128, rope_theta=75e4),
    ffn_kind="dense",
    dense=DenseFfnCfg(d_ff=33792, kind="swiglu"),
    parallel=True,
)

CONFIG = ModelConfig(
    name="command_r_plus_104b",
    d_model=12288,
    vocab=256000,
    prefix=(),
    period=(_LAYER,),
    n_periods=64,
    tie_embeddings=True,
    rules_name="fsdp",
    long_context_ok=False,
    notes="parallel-residual blocks (Cohere); GQA kv=8 replicated across TP",
)


def reduced() -> ModelConfig:
    layer = replace(_LAYER,
                    attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16),
                    dense=DenseFfnCfg(d_ff=128, kind="swiglu"))
    return replace(CONFIG, d_model=64, vocab=512, period=(layer,),
                   n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
