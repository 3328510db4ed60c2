"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by
``kernels.build``), each behind a wrapper that launches it on CUDA
tensors and runs its plain PyTorch version on CPU tensors:

- hash_join:      bucketed sorted probe and range probe (equi-join), with
  the bucket table made once per build side (``probe_table``)
- segment_reduce: deterministic pairwise segmented sum/count/min/max
  over segments given by host row offsets or by ids in any order (ids
  out of order radix-sorted on the card first), two passes of its tree
  in one launch
- flash_attention: causal / sliding-window GQA online-softmax attention,
  in the model's (B, S, H, D) layout: bf16 at D = 64, 128, 256 on the
  tensor cores, float32 and other head dims on the CUDA cores
- rglru_scan:     the RG-LRU linear recurrence, sequential in time
- rwkv6_scan:     the RWKV-6 WKV recurrence: at K = V = 64 chunk-parallel
  on the tensor cores, other head dims sequential in time
- moe_gmm:        grouped (per-expert) matmul and the MoE expert FFN:
  bf16 with D and F multiples of 8 on ``wgmma``, other bf16 shapes on
  ``mma.sync``, float32 on the CUDA cores

``ref`` holds the last four's independent plain oracles, which are also
their plain versions.
"""
