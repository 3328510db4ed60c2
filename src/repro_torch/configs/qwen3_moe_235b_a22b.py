"""Qwen3-MoE-235B-A22B (hf:Qwen/Qwen3 family): 128 experts top-8 with
renormalized gates, GQA 16:1."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151936,
    rope_theta=1000000.0, block_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536,
                  norm_topk=True),
    microbatches=8)
