"""Qwen2-VL-7B (arXiv:2409.12191): GQA 7:1 with M-RoPE; dynamic-resolution
vision frontend is a STUB (input_specs provides patch embeddings and the
3-stream M-RoPE position ids)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope="mrope", rope_theta=1000000.0,
    mrope_sections=(16, 24, 24), microbatches=4,
 block_pattern=("attn",),
    input_mode="embeddings", needs_mrope_positions=True)
