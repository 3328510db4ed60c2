"""DeepSeekMoE-16B (arXiv:2401.06066): fine-grained MoE, 2 shared + 64
routed experts top-6, first layer dense."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=102400,
    rope_theta=10000.0, block_pattern=("moe",),
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=2816,
                  first_k_dense=1, dense_d_ff=10944),
    microbatches=4)
