"""Step functions (port of ``repro/launch/steps.py``: the prefill and
decode steps). PyTorch runs eagerly, so a step is a closure over the config
with no compilation or sharding tree."""

from __future__ import annotations

from repro_torch.models import model as M


def make_prefill_step(cfg: M.ModelConfig):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: M.ModelConfig):
    def decode_step(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch)
    return decode_step
