"""Dense feed-forward variants (port of ``repro/models/mlp.py``): SwiGLU
(llama family) and GELU (musicgen), every product through ``tile_matmul``
with the activation fused into its epilogue."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.tile_matmul.ops import matmul
from repro_torch.models.common import ParamSpec


@dataclass(frozen=True)
class DenseFfnCfg:
    d_ff: int
    kind: str = "swiglu"       # swiglu | gelu


def dense_ffn_specs(d_model: int, cfg: DenseFfnCfg, dtype) -> dict:
    if cfg.kind == "swiglu":
        return {
            "w_gate": ParamSpec((d_model, cfg.d_ff), ("embed", "mlp"), dtype),
            "w_up": ParamSpec((d_model, cfg.d_ff), ("embed", "mlp"), dtype),
            "w_down": ParamSpec((cfg.d_ff, d_model), ("mlp", "embed"), dtype),
        }
    return {
        "w_up": ParamSpec((d_model, cfg.d_ff), ("embed", "mlp"), dtype),
        "b_up": ParamSpec((cfg.d_ff,), ("mlp",), dtype, init="zeros"),
        "w_down": ParamSpec((cfg.d_ff, d_model), ("mlp", "embed"), dtype),
        "b_down": ParamSpec((d_model,), (None,), dtype, init="zeros"),
    }


def dense_ffn(x, p, cfg: DenseFfnCfg):
    """In bf16 the SiLU runs on the float32 accumulator before the cast,
    where the reference applies it to the bf16 product."""
    if cfg.kind == "swiglu":
        gate = matmul(x, p["w_gate"], activation="silu")
        return matmul(gate * matmul(x, p["w_up"]), p["w_down"])
    h = matmul(x, p["w_up"], p["b_up"], activation="gelu")
    return matmul(h, p["w_down"], p["b_down"])
