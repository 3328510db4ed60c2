"""PyTorch/CUDA port of the serverless query engine (``repro``).

The same module layout as the JAX package ``repro``, which stays the
reference: ``engine`` (the query engine, with the ``"torch"`` data-plane
backend in ``engine.compile``), ``core`` (the storage, pricing and
scheduling models it runs on) and ``kernels`` (hand-written CUDA kernels
for Hopper under ``csrc/``, each with a plain PyTorch version beside it).
Nothing here imports ``jax`` or ``repro``.
"""
