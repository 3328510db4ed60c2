"""Architecture registry: --arch <id> resolution for every launcher.

``ASSIGNED`` are the archs without multi-head latent attention, the
reference's ten and the cells of its dry run (``launch/dryrun.py --all``
sweeps these); the port also serves DeepSeek-V2-Lite, which the reference
does not define."""
from repro_torch.configs import (deepseek_7b, deepseek_moe_16b,
                                 deepseek_v2_lite, internlm2_1_8b,
                                 musicgen_medium, qwen1_5_110b, qwen2_vl_7b,
                                 qwen3_moe_235b_a22b, recurrentgemma_2b,
                                 rwkv6_1_6b, stablelm_3b)
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (deepseek_7b, stablelm_3b, internlm2_1_8b, qwen1_5_110b,
              deepseek_moe_16b, qwen3_moe_235b_a22b, musicgen_medium,
              qwen2_vl_7b, rwkv6_1_6b, recurrentgemma_2b, deepseek_v2_lite)
}
ASSIGNED = tuple(n for n, c in ARCHS.items() if not c.mla)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
