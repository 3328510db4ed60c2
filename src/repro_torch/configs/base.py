"""Architecture configuration schema + input shape suite (a copy of
``repro.configs.base`` whose activation dtypes are ``torch`` dtypes).

One ``ArchConfig`` per assigned architecture (exact published configs) plus
``reduced()`` variants for CPU smoke tests. The shape suite applies to every
LM-family arch; ``long_500k`` only lowers for sub-quadratic families
(DESIGN.md §4 of the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    norm_topk: bool = False          # renormalize top-k gates (Qwen3)
    first_k_dense: int = 0          # leading dense layers (DeepSeekMoE)
    dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    kind: str                        # 'rwkv6' | 'rglru'
    lru_width: int = 0               # rglru recurrent width
    conv_width: int = 4              # temporal conv (rglru)
    head_dim: int = 64               # rwkv6 head size
    chunk: int = 64                  # chunked-scan length
    scan_impl: str = "assoc"         # assoc | chunked (rglru prefill/train)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|audio|vlm|ssm|hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope: str = "rope"               # rope|mrope|none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    # Layer pattern: sequence of block kinds repeated to num_layers.
    # Kinds: 'attn' (attention+mlp), 'moe' (attention+moe),
    #        'rwkv' (rwkv6 mixer+channel-mix), 'rec' (rglru+mlp),
    #        'local' (sliding-window attention+mlp).
    block_pattern: tuple = ("attn",)
    window: int = 0                  # sliding-window size for 'local'
    input_mode: str = "tokens"       # tokens|embeddings (modality stubs)
    needs_mrope_positions: bool = False
    tie_embeddings: bool = False
    # Multi-head latent attention (DeepSeek-V2), on where kv_lora_rank > 0:
    # keys and values decompressed per head from a normed latent of
    # kv_lora_rank, each head's query and key split into a part without
    # rotary (qk_nope_head_dim) and one with it (qk_rope_head_dim; the
    # key's shared by every head), values of v_head_dim.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Rotary frequencies: "none" (plain) or "yarn" (YaRN, arXiv:2309.00071,
    # as DeepSeek-V2 sets it: rope_factor over rope_original_max positions,
    # the ramp between beta_fast and beta_slow rotations, and the softmax
    # scale times mscale(rope_factor, yarn_mscale_all_dim) squared).
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_original_max: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    dtype: str = "bfloat16"
    # Training-shape execution knobs (overridable by perf configs).
    microbatches: int = 1            # gradient-accumulation steps
    remat: str = "block"             # none|block
    scan_layers: bool = True

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def mla(self) -> bool:
        """Whether attention is multi-head latent attention."""
        return self.kv_lora_rank > 0

    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv", "rec") for k in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: no unbounded-window attention blocks."""
        return all(k in ("rwkv", "rec", "local") for k in self.block_pattern)

    def layer_kinds(self) -> list[str]:
        reps = -(-self.num_layers // len(self.block_pattern))
        return list((self.block_pattern * reps)[: self.num_layers])

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration of the same family."""
        changes = dict(
            num_layers=max(2, len(self.block_pattern)),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, int(4 * self.num_kv_heads
                                    / max(self.num_heads, 1))) or 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            dtype="float32",
            microbatches=1,
            mrope_sections=(4, 2, 2),
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, expert_d_ff=32,
                shared_d_ff=64 if self.moe.num_shared_experts else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                dense_d_ff=128 if self.moe.first_k_dense else 0)
            changes["num_layers"] = 2 + self.moe.first_k_dense
        if self.recurrent:
            changes["recurrent"] = dataclasses.replace(
                self.recurrent, head_dim=16, chunk=8,
                lru_width=64 if self.recurrent.lru_width else 0)
        if self.window:
            changes["window"] = 16
        if self.mla:
            changes.update(kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train|prefill|decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
