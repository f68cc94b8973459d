"""qwen2-moe-a2.7b [moe] — Qwen1.5-MoE-A2.7B. 24L d_model=2048 16H MHA
(kv=16) with qkv bias, d_ff(expert)=1408, 60 routed experts top-4 +
4 shared (fused shared width 5632), vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Port of ``repro/configs/qwen2_moe_a2_7b.py``; the field values are the
same. 14.3 B parameters (28.6 GB in bf16), 2.7 B active a token: it is
served whole on one card. Head dim 128 runs through ``flash_attention``'s
D = 128 kernels, the expert products through ``tile_matmul``'s batched
launch.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoECfg

_LAYER = LayerCfg(
    mixer="attn",
    attn=AttnCfg(n_heads=16, n_kv_heads=16, head_dim=128, rope_theta=1e6,
                 bias=True),
    ffn_kind="moe",
    moe=MoECfg(n_experts=60, top_k=4, d_ff=1408, n_shared=4,
               d_ff_shared=5632, capacity_factor=1.25, group=2048,
               norm_topk=False),
)

CONFIG = ModelConfig(
    name="qwen2_moe_a2_7b",
    d_model=2048,
    vocab=151936,
    prefix=(),
    period=(_LAYER,),
    n_periods=24,
    tie_embeddings=False,
    rules_name="fsdp",
    long_context_ok=False,
    notes="4 shared + 60 routed top-4; MHA with qkv bias; 14.3B total/2.7B active",
)


def reduced() -> ModelConfig:
    layer = replace(
        _LAYER,
        attn=AttnCfg(n_heads=4, n_kv_heads=4, head_dim=16, bias=True),
        moe=MoECfg(n_experts=8, top_k=2, d_ff=64, n_shared=2,
                   d_ff_shared=128, group=16, norm_topk=False))
    return replace(CONFIG, d_model=64, vocab=512, period=(layer,),
                   n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
