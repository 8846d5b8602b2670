"""Config registry: ``get_config(name)`` / ``list_archs()`` (the port's own
copy of ``repro.configs``; arch ids and values are identical)."""
from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME, ArchConfig,
                                     Family, MoEConfig, ShapeConfig,
                                     TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)

from repro_torch.configs import (moonshot_v1_16b_a3b, dbrx_132b,
                                 whisper_large_v3, minicpm_2b, command_r_35b,
                                 codeqwen1_5_7b, qwen2_5_32b, qwen2_5_32b_mla,
                                 hymba_1_5b, rwkv6_7b, llama_3_2_vision_11b)

_ARCHS = {}
for _m in (moonshot_v1_16b_a3b, dbrx_132b, whisper_large_v3, minicpm_2b,
           command_r_35b, codeqwen1_5_7b, qwen2_5_32b, qwen2_5_32b_mla,
           hymba_1_5b, rwkv6_7b, llama_3_2_vision_11b):
    _ARCHS[_m.CONFIG.name] = _m.CONFIG

__all__ = ["ALL_SHAPES", "SHAPES_BY_NAME", "ArchConfig", "Family",
           "MoEConfig", "ShapeConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "cells", "get_config", "get_shape",
           "list_archs"]


def list_archs():
    return sorted(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def cells(include_skips: bool = False):
    """All (arch, shape, skipped) cells; skips excluded unless
    include_skips."""
    out = []
    for a in list_archs():
        cfg = _ARCHS[a]
        for s in ALL_SHAPES:
            skipped = s.name in cfg.skip_shapes
            if include_skips or not skipped:
                out.append((cfg, s, skipped))
    return out
