"""``ServingEngine`` on a (data 2, model 2) mesh of gloo CPU ranks
against the one-device engine: deepseek-moe ``reduced()`` at capacity
factor 16 (no drops, so per-shard routing changes nothing), 6 requests
in batches of 4 (the second batch half full), 6 new tokens, on the
``reference`` and ``flash_moe`` routes (the grouped matmul's plain
version on the CPU). Every rank returns the one-device engine's
completions, and ``cost_report`` counts the mesh's 4 chips. The prefill
runs the MoE's all-to-all path, decode its psum path.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs.registry import ARCHS

IMPLS = ["reference", "flash_moe"]


def cfg_of():
    cfg = ARCHS["deepseek-moe-16b"].reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))


def requests(cfg):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, cfg.vocab_size, rng.integers(4, 16)),
                    max_new_tokens=6) for i in range(6)]


def serve(impl, mesh=None):
    from repro_torch.serve.engine import ServingEngine
    cfg = cfg_of()
    engine = ServingEngine(cfg, batch_size=4, max_prompt=16, max_len=32,
                           impl=impl, device="cpu", mesh=mesh)
    done = engine.serve(requests(cfg))
    return ([r.completion.tolist() for r in done],
            engine.cost_report(1.0, len(done))["chips"])


def rank_main() -> dict:
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
    return {impl: serve(impl, mesh) for impl in IMPLS}


@pytest.fixture(scope="module")
def results():
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.spawn(rank_main, 4, backend="gloo", device="cpu",
                          timeout=300)


@pytest.mark.parametrize("impl", IMPLS)
def test_mesh_engine_equals_one_device(results, impl):
    want, chips = serve(impl)
    assert chips == 1
    for rank, r in enumerate(results):
        got, chips = r[impl]
        assert got == want, rank
        assert chips == 4
