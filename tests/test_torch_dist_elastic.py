"""Elastic training on a mesh: a ``Trainer`` on (data 2, model 2) is
pre-empted at step 3 and resumed on (data 4, model 1), on gloo CPU ranks
(recurrentgemma and deepseek-moe ``reduced()``, the latter at capacity
factor 16; 5 steps, a checkpoint every 3).

Checkpoints hold whole leaves: the step-3 state restored onto (4, 1) and
saved again gives the same objects byte for byte, and so does the state
restored onto one CPU device. Resumed on the same (2, 2) mesh, the run
ends byte-equal to an uninterrupted (2, 2) run (the resume is exact).
Resumed on (4, 1), its later steps sum over other shards in other orders,
so recurrentgemma's end state is held to the uninterrupted run within
1e-4 of each leaf's largest value and its losses within rtol 1e-5
(float32 moments: a bfloat16 moment rounded across an edge moves by an
ulp, 7.6e-6 on the embedding's first moment here). (The
MoE's load-balance term is a mean over the mesh's token shards, so
deepseek-moe's loss depends on the mesh: its continuation is not
compared.) ``cost_report`` counts the mesh's 4 chips.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS

STEPS, EVERY, PREEMPT = 5, 3, 3
ARCH_NAMES = ["recurrentgemma-2b", "deepseek-moe-16b"]


def cfg_of(name):
    cfg = ARCHS[name].reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def _trainer(name, store, mesh, hook=None, device="cpu"):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(cfg_of(name), store, DataConfig(seq_len=16, global_batch=8),
                   AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS,
                               moment_dtype="float32"),
                   TrainerConfig(total_steps=STEPS, checkpoint_every=EVERY,
                                 log_every=1),
                   preemption_hook=hook, device=device, mesh=mesh)


def _objects(store, prefix):
    return {k: bytes(store.get(k)) for k in store.list(prefix)}


def _resave(state, step, mesh_ckpt):
    """The objects of ``state`` (model, opt_state) saved afresh."""
    from repro_torch.core.storage_service import ObjectStore
    store = ObjectStore()
    mesh_ckpt.save_checkpoint(store, "ckpt", step, state[0])
    mesh_ckpt.save_checkpoint(store, "ckpt-opt", step, state[1])
    return store


def rank_main() -> dict:
    return {name: _one(name) for name in ARCH_NAMES}


def _one(name) -> dict:
    from repro_torch.checkpoint import object_store_ckpt as ckpt
    from repro_torch.core.storage_service import ObjectStore, copy_objects
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.trainer import Preempted

    rank = torch.distributed.get_rank()
    m22 = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
    m41 = mesh_mod.make_local_mesh(4, 1, device_type="cpu")
    out = {}
    store_a = ObjectStore()
    full = _trainer(name, store_a, m22).run()
    out["full"] = (full["metrics"], full["cost"]["chips"])

    def hook(step):
        if step == PREEMPT:
            raise Preempted(step)
    store_b = ObjectStore()
    out["preempted"] = _trainer(name, store_b, m22, hook).run()
    saved = _objects(store_b, "ckpt")
    store_c = ObjectStore()
    copy_objects(store_b, store_c, "ckpt")

    # The step-3 state restored onto (4, 1), saved again: the same bytes.
    t41 = _trainer(name, store_c, m41)
    state = t41._restore_or_init()
    again = _resave(state, state[2], ckpt)
    if rank == 0:
        out["reshard_equal"] = _objects(again, "ckpt") == {
            k: v for k, v in saved.items() if "/step-00000003/" in k}
    # ... and onto one device (rank 0 alone; no collective).
    if rank == 0:
        t1 = _trainer(name, store_b, None)
        state1 = t1._restore_or_init()
        one = _resave(state1, state1[2], ckpt)
        out["one_device_equal"] = _objects(one, "ckpt") == {
            k: v for k, v in saved.items() if "/step-00000003/" in k}
    torch.distributed.barrier()

    resumed_22 = _trainer(name, store_b, m22).run()
    out["resumed_22"] = resumed_22["metrics"]
    resumed_41 = _trainer(name, store_c, m41).run()
    out["resumed_41"] = (resumed_41["metrics"], resumed_41["cost"]["chips"])
    if rank == 0:
        final = "/step-00000005/"
        a = {k: v for k, v in _objects(store_a, "ckpt").items() if final in k}
        b = {k: v for k, v in _objects(store_b, "ckpt").items() if final in k}
        out["resume_22_equal"] = a == b and len(a) > 0
        out["final_a"] = _leaves(store_a)
        out["final_c"] = _leaves(store_c)
    return out


def _leaves(store):
    """The step-5 leaves of a store's checkpoints, as float64 arrays."""
    import json

    from repro_torch.checkpoint import object_store_ckpt as ckpt
    out = {}
    for prefix in ("ckpt", "ckpt-opt"):
        man = json.loads(store.get(f"{prefix}/step-00000005/MANIFEST.json"))
        for leaf in man["leaves"]:
            buf = b"".join(store.get(k) for k in leaf["chunks"])
            t = ckpt._from_bytes(buf, leaf["dtype"], leaf["shape"])
            out[f"{prefix}:{leaf['name']}"] = t.double().numpy()
    return out


@pytest.fixture(scope="module")
def results():
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.spawn(rank_main, 4, backend="gloo", device="cpu",
                          timeout=300)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_preempted_at_step_three(results, name):
    r = results[0][name]["preempted"]
    assert r["status"] == "preempted" and r["resumable_from"] == PREEMPT


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_restore_onto_another_mesh_is_byte_equal(results, name):
    assert results[0][name]["reshard_equal"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_restore_onto_one_device_is_byte_equal(results, name):
    assert results[0][name]["one_device_equal"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_resume_on_the_same_mesh_is_exact(results, name):
    r = results[0][name]
    assert r["resume_22_equal"]
    assert r["resumed_22"] == r["full"][0][PREEMPT:]


def test_resume_on_another_mesh_continues(results):
    r = results[0]["recurrentgemma-2b"]
    metrics, chips = r["resumed_41"]
    assert chips == 4 and r["full"][1] == 4
    for got, want in zip(metrics, r["full"][0][PREEMPT:]):
        assert got["step"] == want["step"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    a, c = r["final_a"], r["final_c"]
    assert set(a) == set(c)
    for k in a:
        tol = 1e-4 * max(float(np.abs(a[k]).max()), 1e-30)
        assert np.abs(a[k] - c[k]).max() <= tol, k
