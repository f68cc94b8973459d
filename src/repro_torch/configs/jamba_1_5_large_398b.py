"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE.
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts
top-2 on every other layer. [arXiv:2403.19887 / Jamba-1.5; hf]

Port of ``repro/configs/jamba_1_5_large_398b.py``; the field values are the
same. A period of 8 layers is [attn, mamba x 7]; the FFN alternates dense
and MoE (4 MoE + 4 dense a period, 36 MoE layers in all). The Mamba layers
use the SSD (Mamba-2) chunked scan, as the reference does.

398.6 B parameters, 94.2 B active a token. One period alone is 45.25 B
(90.5 GB in bf16), more than one 80 GB card holds, so the card serves the
model cut in depth: ``SERVED_CUT`` keeps the first 4 layers of the period
(23.03 B parameters, 46.05 GB in bf16). They run every layer kind of the
model at full width: attention with a dense FFN, Mamba with an MoE FFN,
Mamba with a dense FFN, Mamba with an MoE FFN.
"""

from dataclasses import replace

from repro_torch.models.attention import AttnCfg
from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mamba2 import MambaCfg
from repro_torch.models.mlp import DenseFfnCfg
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoECfg

_ATTN = AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128, rope_theta=1e4)
_MAMBA = MambaCfg(d_inner=16384, d_state=128, d_conv=4, head_dim=64,
                  n_groups=8, chunk=128)
_DENSE = DenseFfnCfg(d_ff=24576, kind="swiglu")
_MOE = MoECfg(n_experts=16, top_k=2, d_ff=24576, capacity_factor=1.25,
              group=2048, norm_topk=True)


def _layer(i: int) -> LayerCfg:
    mixer = "attn" if i == 0 else "mamba"
    ffn_kind = "moe" if i % 2 == 1 else "dense"
    return LayerCfg(
        mixer=mixer,
        attn=_ATTN if mixer == "attn" else None,
        mamba=_MAMBA if mixer == "mamba" else None,
        ffn_kind=ffn_kind,
        dense=_DENSE if ffn_kind == "dense" else None,
        moe=_MOE if ffn_kind == "moe" else None,
    )


CONFIG = ModelConfig(
    name="jamba_1_5_large_398b",
    d_model=8192,
    vocab=65536,
    prefix=(),
    period=tuple(_layer(i) for i in range(8)),
    n_periods=9,
    tie_embeddings=False,
    rules_name="fsdp",
    long_context_ok=True,
    notes="1 attn : 7 mamba, MoE every other layer; 398B total / ~94B active",
)

# The depth one card serves: the period's first 4 layers, once.
SERVED_CUT = dict(period=CONFIG.period[:4], n_periods=1)


def reduced() -> ModelConfig:
    attn = AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16)
    mamba = MambaCfg(d_inner=64, d_state=16, d_conv=4, head_dim=16,
                     n_groups=2, chunk=16)
    dense = DenseFfnCfg(d_ff=96, kind="swiglu")
    moe = MoECfg(n_experts=4, top_k=2, d_ff=96, group=16)

    def lay(i):
        mixer = "attn" if i == 0 else "mamba"
        fk = "moe" if i % 2 == 1 else "dense"
        return LayerCfg(mixer=mixer, attn=attn if mixer == "attn" else None,
                        mamba=mamba if mixer == "mamba" else None,
                        ffn_kind=fk, dense=dense if fk == "dense" else None,
                        moe=moe if fk == "moe" else None)

    return replace(CONFIG, d_model=32, vocab=256,
                   period=tuple(lay(i) for i in range(4)), n_periods=2,
                   param_dtype="float32",
                   q_chunk=32, kv_chunk=32, loss_chunk=64)
