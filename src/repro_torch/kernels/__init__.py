"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built by
``kernels.build``), each behind a wrapper that launches it on CUDA
tensors and runs its plain PyTorch version on CPU tensors:

- hash_join:      bucketed sorted probe and range probe (equi-join)
- segment_reduce: deterministic pairwise segmented sum/count/min/max
"""
