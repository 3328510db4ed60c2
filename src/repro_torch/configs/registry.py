"""Architecture registry: --arch <id> resolution for every launcher."""
from repro_torch.configs import (deepseek_7b, deepseek_moe_16b,
                                 internlm2_1_8b, musicgen_medium,
                                 qwen1_5_110b, qwen2_vl_7b,
                                 qwen3_moe_235b_a22b, recurrentgemma_2b,
                                 rwkv6_1_6b, stablelm_3b)
from repro_torch.configs.base import SHAPES, ArchConfig, shape_applicable

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (deepseek_7b, stablelm_3b, internlm2_1_8b, qwen1_5_110b,
              deepseek_moe_16b, qwen3_moe_235b_a22b, musicgen_medium,
              qwen2_vl_7b, rwkv6_1_6b, recurrentgemma_2b)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) cell; long_500k only for sub-quadratic archs."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            yield arch, shape, shape_applicable(arch, shape)
