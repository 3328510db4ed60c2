"""Roofline terms on an NVIDIA H100 and the model's FLOPs: the port of
the framework-free part of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds, each a per-device
count over the H100's rate:

  compute    = FLOPs / peak dense bf16 FLOP/s
  memory     = bytes / HBM bandwidth
  collective = wire bytes / NVLink bandwidth

The constants are the NVIDIA H100 SXM5 (80 GB) datasheet's ("NVIDIA H100
Tensor Core GPU" datasheet): 989 TFLOPS of dense BF16 tensor-core
throughput (1,979 with structured sparsity, not used here), 3.35 TB/s of
HBM3 bandwidth and 900 GB/s of fourth-generation NVLink per GPU, the
sum of both directions over its 18 links: 450 GB/s a direction; its
memory is 80 GB. ``roofline_terms_from_trace`` takes the per-device
FLOP, byte and wire-byte counts of a dry run's trace
(``launch.trace_analysis``, the counterpart of the reference's HLO
parse); ``roofline_terms`` takes them from any caller;
``kernelized_terms`` credits flash attention with the score bytes.

``count_params``, ``active_params`` and ``model_flops`` are copies of
the reference's 6ND convention (MoE layers count their active experts)
on ``launch.inputs.param_specs``.
"""
from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM5 datasheet.
H100_PEAK_BF16_FLOPS = 989e12       # dense BF16 tensor-core FLOP/s
H100_HBM_BYTES_PER_S = 3.35e12      # HBM3
H100_NVLINK_BYTES_PER_S = 450e9     # NVLink 4: 900 GB/s, both directions
H100_MEMORY_BYTES = 80e9            # HBM3 capacity


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float      # MODEL_FLOPS / (FLOPs x chips)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(flops: float, bytes_: float, wire_bytes: float,
                   chips: int, model_flops: float) -> Roofline:
    """The three terms from per-device counts on ``chips`` H100s."""
    compute_s = flops / H100_PEAK_BF16_FLOPS
    memory_s = bytes_ / H100_HBM_BYTES_PER_S
    collective_s = wire_bytes / H100_NVLINK_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total = flops * chips
    ratio = model_flops / total if total else float("nan")
    return Roofline(float(flops), float(bytes_), float(wire_bytes),
                    compute_s, memory_s, collective_s, bottleneck,
                    float(model_flops), ratio)


def roofline_terms_from_trace(summary, chips: int,
                              model_flops: float) -> Roofline:
    """Terms from a dry run's trace (``trace_analysis.TraceSummary``, or
    anything with its ``dot_flops``, ``hbm_bytes`` and
    ``collective_wire_bytes``); all inputs are per device."""
    return roofline_terms(summary.dot_flops, summary.hbm_bytes,
                          summary.collective_wire_bytes, chips, model_flops)


def kernelized_terms(terms: dict, score_bytes: float) -> dict:
    """``terms`` (a ``Roofline.to_dict()``) with the flash-attention
    kernel: the materialised score tensors' bytes stay on chip (the
    reference's ``_kernelized``)."""
    memory_s = max(terms["bytes_per_device"] - score_bytes, 0.0) \
        / H100_HBM_BYTES_PER_S
    t = {"compute": terms["compute_s"], "memory": memory_s,
         "collective": terms["collective_s"]}
    return {"compute_s": terms["compute_s"], "memory_s": memory_s,
            "collective_s": terms["collective_s"],
            "bottleneck": max(t, key=t.get)}


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6ND convention; MoE uses active params)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(cfg) -> float:
    from repro_torch.launch import inputs
    return float(sum(math.prod(t.shape)
                     for t in _leaves(inputs.param_specs(cfg))))


def active_params(cfg) -> float:
    """Parameters touched per token (dense: all; MoE: shared + top-k)."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    mo = cfg.moe
    per_expert = 3 * cfg.d_model * mo.expert_d_ff
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k == "moe") \
        - mo.first_k_dense
    inactive = per_expert * (mo.num_experts - mo.top_k) * n_moe_layers
    return total - inactive


def model_flops(cfg, shape) -> float:
    n = active_params(cfg)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch
