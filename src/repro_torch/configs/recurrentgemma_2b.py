"""RecurrentGemma-2B (arXiv:2402.19427): RG-LRU + local attention in a
(rec, rec, local) pattern; window 2048 (long_500k eligible)."""
from repro_torch.configs.base import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    rope_theta=10000.0, microbatches=4,
 block_pattern=("rec", "rec", "local"),
    window=2048,
    recurrent=RecurrentConfig(kind="rglru", lru_width=2560, conv_width=4,
                              chunk=256))
