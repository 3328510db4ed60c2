"""DeepSeek-V2-Lite (arXiv:2405.04434; huggingface.co/deepseek-ai/
DeepSeek-V2-Lite): multi-head latent attention with a 512-wide latent KV
and 64 rotary dims under YaRN, on DeepSeekMoE's MoE layer (64 routed
experts top-6, 2 shared, first layer dense)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=192, d_ff=1408, vocab_size=102400,
    rope_theta=10000.0, block_pattern=("moe",),
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  num_shared_experts=2, shared_d_ff=2816,
                  first_k_dense=1, dense_d_ff=10944),
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, rope_scaling="yarn", rope_factor=40.0,
    rope_original_max=4096, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
    yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
    microbatches=4)
