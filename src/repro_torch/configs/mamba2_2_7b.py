"""mamba2-2.7b [ssm] — attention-free SSD. 64L d_model=2560,
d_inner=5120 (expand 2), d_state=128, head_dim=64 (→ 80 heads), no FFN.
[arXiv:2405.21060; unverified]

Port of ``repro/configs/mamba2_2_7b.py``; the field values are the same.
Prefill runs the SSD scan through the ``ssd_scan`` kernel; decode is an
O(1)-state step.
"""

from dataclasses import replace

from repro_torch.models.blocks import LayerCfg
from repro_torch.models.mamba2 import MambaCfg
from repro_torch.models.model import ModelConfig

_LAYER = LayerCfg(
    mixer="mamba",
    mamba=MambaCfg(d_inner=5120, d_state=128, d_conv=4, head_dim=64,
                   n_groups=1, chunk=128),
    ffn_kind="none",
)

CONFIG = ModelConfig(
    name="mamba2_2_7b",
    d_model=2560,
    vocab=50280,
    prefix=(),
    period=(_LAYER,),
    n_periods=64,
    tie_embeddings=True,
    rules_name="tp",
    long_context_ok=True,
    notes="pure SSM (SSD); no attention, no FFN; O(1) decode state",
)


def reduced() -> ModelConfig:
    layer = replace(_LAYER,
                    mamba=MambaCfg(d_inner=64, d_state=16, d_conv=4,
                                   head_dim=16, n_groups=1, chunk=16))
    return replace(CONFIG, d_model=32, vocab=256, period=(layer,),
                   n_periods=2, param_dtype="float32", loss_chunk=64)
