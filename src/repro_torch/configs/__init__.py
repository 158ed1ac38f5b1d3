"""Config registry: the 10 assigned architectures (``repro.configs``'s copy)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_PARALLEL,
                                      INPUT_SHAPES, MAMBA2, MAMBA2_SHARED,
                                      MLSTM, MOE, SLSTM, InputShape,
                                      ModelConfig, effective_window,
                                      shape_variant)

from repro_torch.configs import (command_r_35b, deepseek_moe_16b,
                                 gemma2_27b, internvl2_1b, musicgen_medium,
                                 qwen2_5_3b, qwen3_moe_30b_a3b, xlstm_1_3b,
                                 yi_9b, zamba2_1_2b)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (xlstm_1_3b, gemma2_27b, qwen3_moe_30b_a3b, internvl2_1b,
              qwen2_5_3b, musicgen_medium, command_r_35b, zamba2_1_2b,
              deepseek_moe_16b, yi_9b)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
