"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE. 27L d_model=2048,
16 heads MLA (kv_lora=512, qk_nope=128, qk_rope=64, v=128), first layer
dense (d_ff=10944), then 26 MoE layers: 64 routed experts (d_ff=1408)
top-6 + 2 shared experts. [arXiv:2405.04434; hf]

Port of ``repro/configs/deepseek_v2_lite_16b.py``; the field values are the
same. 15.7 B parameters (31.4 GB in bf16), 2.66 B active a token: it is
served whole on one card. The first config of the port with a ``prefix``
layer (the dense one). Prefill attention runs through ``flash_attention``'s
(192, 128) pair (q and k of head dim qk_nope + qk_rope, v of v_head_dim);
decode attends in the latent space over the (512 + 64)-wide cache
(``models/attention.py::mla_decode_attention``).
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoECfg

_MLA = AttnCfg(n_heads=16, n_kv_heads=16, head_dim=192, rope_theta=1e4,
               kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
               v_head_dim=128)
_MOE = MoECfg(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
              d_ff_shared=2816, capacity_factor=1.25, group=2048,
              norm_topk=False)

_FIRST = LayerCfg(mixer="attn", attn=_MLA, ffn_kind="dense",
                  dense=DenseFfnCfg(d_ff=10944, kind="swiglu"))
_MOE_LAYER = LayerCfg(mixer="attn", attn=_MLA, ffn_kind="moe", moe=_MOE)

CONFIG = ModelConfig(
    name="deepseek_v2_lite_16b",
    d_model=2048,
    vocab=102400,
    prefix=(_FIRST,),
    period=(_MOE_LAYER,),
    n_periods=26,
    tie_embeddings=False,
    rules_name="fsdp",
    long_context_ok=False,
    notes="MLA kv_lora=512; 64 routed top-6 + 2 shared; 1st layer dense",
)


def reduced() -> ModelConfig:
    mla = AttnCfg(n_heads=4, n_kv_heads=4, head_dim=24, kv_lora_rank=32,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    moe = MoECfg(n_experts=8, top_k=2, d_ff=64, n_shared=2, d_ff_shared=128,
                 group=16, norm_topk=False)
    first = LayerCfg(mixer="attn", attn=mla, ffn_kind="dense",
                     dense=DenseFfnCfg(d_ff=128, kind="swiglu"))
    moe_l = LayerCfg(mixer="attn", attn=mla, ffn_kind="moe", moe=moe)
    return replace(CONFIG, d_model=64, vocab=512, prefix=(first,),
                   period=(moe_l,), n_periods=2, param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
