"""Config registry (port of ``repro/configs/base.py::get_config``).

Each ``configs/<arch>.py`` exports ``CONFIG`` (full, literature-exact) and
``reduced()`` (a small same-family variant for CPU tests). Only the
architectures this package can run are listed.
"""

from __future__ import annotations

import importlib

from repro_torch.models.model import ModelConfig

ARCH_IDS = ["smollm_360m", "h2o_danube_1_8b", "command_r_plus_104b", "gemma3_12b",
            "mamba2_2_7b", "jamba_1_5_large_398b", "internvl2_76b", "deepseek_v2_lite_16b",
            "qwen2_moe_a2_7b", "musicgen_medium"]


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch} is not ported yet; ported: {ARCH_IDS} (see ROADMAP.md)")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced() if reduced else mod.CONFIG
