"""RWKV-6 'Finch' 1.6B (arXiv:2404.05892): attention-free, data-dependent
decay linear attention; O(1)-state decode (long_500k eligible)."""
from repro_torch.configs.base import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=7168, vocab_size=65536,
    rope="none", microbatches=4,
 block_pattern=("rwkv",),
    recurrent=RecurrentConfig(kind="rwkv6", head_dim=64, chunk=64))
