"""MusicGen-medium (arXiv:2306.05284): decoder-only over EnCodec tokens.

Modality frontend is a STUB: input_specs provides precomputed frame
embeddings (B, S, D); the LM head projects to the 2048-entry codebook."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    rope="none", microbatches=4,
 block_pattern=("attn",),
    input_mode="embeddings")
