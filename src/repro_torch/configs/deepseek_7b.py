"""DeepSeek-7B (arXiv:2401.02954): llama-arch dense, MHA (kv == heads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    head_dim=128, d_ff=11008, vocab_size=102400,
    rope_theta=10000.0, block_pattern=("attn",),
    microbatches=4)
