"""The port's train step, checkpoints and ``Trainer`` on the CPU, against
the JAX reference.

``make_train_step`` with ``microbatches=2``: three steps from the
reference's weights and optimizer state, the losses within rtol 1e-5 of
the reference's jitted steps, every weight (and, with float32 moments,
every moment) within 1e-4 of the largest value of its leaf. Then
``tests/test_fault_tolerance.py`` on the port's ``Trainer``: checkpoint
round trips (a bfloat16 leaf among them, written without
``ml_dtypes``), chunking at the break-even size, the manifest as the
commit point, gc, preemption at step 7 and a bit-exact resume (final
parameters and moments ``torch.equal`` to an uninterrupted run's, whose
losses follow the reference ``Trainer`` from the same weights), the
elastic restore onto another dtype and device target, and the cost
report; and the reference's checkpoint property test. Last, the training
modules import neither JAX, the reference nor ``ml_dtypes``, and
``python -m repro_torch.launch.train --device cpu`` trains.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypo_compat import given, settings, st

from repro.configs.registry import ARCHS as JARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as jsteps
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import object_store_ckpt as ckpt
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.storage_service import ObjectStore
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_launch
from repro_torch.models import convert
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Preempted, Trainer, TrainerConfig
from test_torch_train_model import reference_params
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

ARCH = "internlm2-1.8b"


def _cfgs(arch=ARCH):
    return (dataclasses.replace(JARCHS[arch].reduced(), microbatches=2),
            dataclasses.replace(TARCHS[arch].reduced(), microbatches=2))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma-2b"])
def test_three_train_steps_match_reference(arch, moment_dtype):
    jcfg, tcfg = _cfgs(arch)
    # The launcher's learning rate. Adam's first steps divide by |g|, so
    # a gradient near eps carries float32 rounding into the update at
    # full size: at lr 1e-2, 4 of InternLM2's 16,384 embedding weights
    # end 2e-4 of the leaf's largest value apart, at 1e-3 2e-5.
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3,
                moment_dtype=moment_dtype)
    params = reference_params(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jfn, _ = jsteps.make_train_step(jcfg, mesh, jopt.AdamWConfig(**ocfg),
                                    donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init_opt_state(jp, jopt.AdamWConfig(**ocfg))
    model = convert.from_reference(tcfg, params, device="cpu")
    tst = topt.init_opt_state(model, topt.AdamWConfig(**ocfg))
    tfn = tsteps.make_train_step(tcfg, topt.AdamWConfig(**ocfg))
    pipe = JTokenPipeline(JDataConfig(seq_len=16, global_batch=4, seed=2,
                                      vocab_size=tcfg.vocab_size))
    for step in range(3):
        batch = pipe.batch_at(step)
        jp, jst, jm = jfn(jp, jst, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tst, tm = tfn(model, tst, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(tst.step) == 3

    def close(got, want):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.max(np.abs(want)))

    jax.tree.map(close, convert.to_reference(tcfg, model),
                 jax.tree.map(np.asarray, jp))
    if moment_dtype == "float32":
        # bfloat16 moments are held one step at a time in
        # test_torch_train_optim.py: from step 2 on, a moment rounded to
        # the other side of a bfloat16 edge (0.4% of its value) moves the
        # RG-LRU gates' gradients by up to 0.5% of their largest value.
        for t_mom, j_mom in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
            jax.tree.map(close, convert.to_reference(tcfg, t_mom),
                         jax.tree.map(np.asarray, j_mom))


def test_train_step_takes_only_differentiable_routes():
    _, tcfg = _cfgs()
    for impl in ("flash", "flash_moe"):
        with pytest.raises(ValueError, match="forward-only"):
            tsteps.make_train_step(tcfg, topt.AdamWConfig(), impl=impl)
    tsteps.make_train_step(tcfg, topt.AdamWConfig(), impl="blocked")


def test_microbatches_split_mrope_positions_on_axis_1():
    batch = {"embeds": torch.arange(4 * 3 * 2).reshape(4, 3, 2),
             "mrope_positions": torch.arange(3 * 4 * 3).reshape(3, 4, 3)}
    mbs = tsteps._split_microbatches(batch, 2)
    assert len(mbs) == 2
    torch.testing.assert_close(mbs[1]["embeds"], batch["embeds"][2:])
    torch.testing.assert_close(mbs[1]["mrope_positions"],
                               batch["mrope_positions"][:, 2:])
    with pytest.raises(ValueError):
        tsteps._split_microbatches(batch, 3)


# -- checkpoints (tests/test_fault_tolerance.py) ----------------------------

def test_checkpoint_roundtrip():
    store = ObjectStore()
    tree = {"a": torch.arange(100, dtype=torch.float32).reshape(10, 10),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "h": torch.randn(5, 7, generator=torch.Generator().manual_seed(0)
                             ).to(torch.bfloat16)}
    ckpt.save_checkpoint(store, "t", 7, tree)
    manifest = store.get("t/step-00000007/MANIFEST.json").decode()
    assert '"dtype": "bfloat16"' in manifest
    restored, step = ckpt.restore_checkpoint(store, "t", tree)
    assert step == 7
    for got, want in ((restored["a"], tree["a"]),
                      (restored["b"]["c"], tree["b"]["c"]),
                      (restored["h"], tree["h"])):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_checkpoint_chunking_respects_beas():
    store = ObjectStore()
    big = {"w": torch.zeros((1024, 1024), dtype=torch.float32)}   # 4 MiB
    ckpt.save_checkpoint(store, "big", 1, big)
    chunk_keys = [k for k in store.list("big/") if "chunk" in k]
    sizes = [store.size(k) for k in chunk_keys]
    # every chunk except the last is >= the minimum economical object size
    assert all(s >= 1024 ** 2 for s in sizes[:-1])
    assert sum(sizes) == 4 * 1024 ** 2


def test_manifest_is_commit_point():
    store = ObjectStore()
    tree = {"a": torch.ones(4)}
    ckpt.save_checkpoint(store, "c", 1, tree)
    # simulate a crash mid-write of step 2: leaves written, no manifest
    store.put("c/step-00000002/a/chunk-0000", b"\x00" * 16)
    assert ckpt.latest_step(store, "c") == 1


def test_checkpoint_gc_keeps_latest():
    store = ObjectStore()
    tree = {"a": torch.ones(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(store, "g", s, tree, keep=2)
    assert ckpt.latest_step(store, "g") == 5
    assert not [k for k in store.list("g/step-00000001/")]
    assert not [k for k in store.list("g/step-00000003/")]
    restored, _ = ckpt.restore_checkpoint(store, "g", tree, step=5)
    assert torch.equal(restored["a"], tree["a"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(ObjectStore(), "g", tree)


@settings(max_examples=15, deadline=None)
@given(shapes=st.lists(
    st.tuples(st.integers(1, 7), st.integers(1, 7)), min_size=1, max_size=4),
    step=st.integers(0, 10 ** 6))
def test_checkpoint_roundtrip_arbitrary_trees(shapes, step):
    rng = np.random.default_rng(0)
    tree = {f"leaf{i}": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
        for i, s in enumerate(shapes)}
    store = ObjectStore()
    ckpt.save_checkpoint(store, "p", step, tree)
    back, got_step = ckpt.restore_checkpoint(store, "p", tree)
    assert got_step == step
    for k in tree:
        assert torch.equal(back[k], tree[k])


# -- the Trainer -------------------------------------------------------------

DATA = DataConfig(seq_len=16, global_batch=4, seed=1)
TCFG = TrainerConfig(total_steps=10, checkpoint_every=5, log_every=1)


def _final_state(store, cfg, like_trainer):
    model, opt = like_trainer.init_state()
    model, _ = ckpt.restore_checkpoint(store, "ckpt", model)
    opt, _ = ckpt.restore_checkpoint(store, "ckpt-opt", opt)
    return model, opt


def test_preemption_and_bitexact_resume():
    """Kill training at step 7; a fresh Trainer resumes from step 5's
    manifest and ends with the uninterrupted run's parameters and
    moments, bit for bit. The uninterrupted run's losses follow the
    reference Trainer's from the same weights."""
    jcfg, tcfg = _cfgs()
    params = reference_params(ARCH, seed=TCFG.seed)
    ref_store = ObjectStore()
    t_ref = Trainer(tcfg, ref_store, DATA, tcfg=TCFG, device="cpu",
                    initial_params=params)
    ref = t_ref.run()
    assert ref["status"] == "done"
    jref = JTrainer(jcfg, jax.make_mesh((1, 1), ("data", "model")),
                    __import__("repro.core.storage_service",
                               fromlist=["ObjectStore"]).ObjectStore(),
                    JDataConfig(seq_len=16, global_batch=4, seed=1),
                    tcfg=JTrainerConfig(total_steps=10, checkpoint_every=5,
                                        log_every=1)).run()
    np.testing.assert_allclose([m["loss"] for m in ref["metrics"]],
                               [m["loss"] for m in jref["metrics"]],
                               rtol=1e-5)

    store = ObjectStore()

    def bomb(step):
        if step == 7:
            raise Preempted()

    t1 = Trainer(tcfg, store, DATA, tcfg=TCFG, preemption_hook=bomb,
                 device="cpu", initial_params=params)
    out1 = t1.run()
    assert out1["status"] == "preempted"
    assert out1["at_step"] == 7
    assert out1["resumable_from"] == 5

    t2 = Trainer(tcfg, store, DATA, tcfg=TCFG, device="cpu",
                 initial_params=params)
    out2 = t2.run()
    assert out2["status"] == "done"
    assert [m["step"] for m in out2["metrics"]] == list(range(6, 11))
    assert out2["metrics"][-1]["loss"] == ref["metrics"][-1]["loss"]
    got_m, got_o = _final_state(store, tcfg, t2)
    want_m, want_o = _final_state(ref_store, tcfg, t2)
    for (n, a), (_, b) in zip(got_m.named_parameters(),
                              want_m.named_parameters()):
        assert torch.equal(a, b), n
    assert int(got_o.step) == int(want_o.step) == 10
    for k in want_o.mu:
        assert torch.equal(got_o.mu[k], want_o.mu[k]), k
        assert torch.equal(got_o.nu[k], want_o.nu[k]), k


def test_elastic_restore_onto_another_target():
    """Save a bfloat16 model and its optimizer state, then restore onto a
    float32 model on an explicitly named device: the same values,
    widened; the step's int32 stays int32."""
    cfg = dataclasses.replace(TARCHS[ARCH].reduced(), dtype="bfloat16",
                              microbatches=2)
    store = ObjectStore()
    t1 = Trainer(cfg, store, DATA, tcfg=TrainerConfig(
        total_steps=5, checkpoint_every=5), device="cpu")
    assert t1.run()["status"] == "done"
    saved, _ = _final_state(store, cfg, t1)
    assert next(saved.parameters()).dtype == torch.bfloat16
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    t2 = Trainer(f32_cfg, store, DATA, tcfg=TrainerConfig(
        total_steps=10, checkpoint_every=5), device="cpu")
    like, like_opt = t2.init_state()
    model, step = ckpt.restore_checkpoint(store, "ckpt", like,
                                          device="cpu")
    opt, _ = ckpt.restore_checkpoint(store, "ckpt-opt", like_opt,
                                     device=torch.device("cpu"))
    assert step == 5 and model is like
    for (n, a), (_, b) in zip(model.named_parameters(),
                              saved.named_parameters()):
        assert a.dtype == torch.float32
        assert torch.equal(a, b.float()), n
    assert opt.step.dtype == torch.int32 and int(opt.step) == 5
    out = t2.run()                       # resumes from step 5 in float32
    assert out["status"] == "done"
    assert [m["step"] for m in out["metrics"]] == [10]


def test_cost_report():
    store = ObjectStore()
    t = Trainer(_cfgs()[1], store, DataConfig(seq_len=16, global_batch=4),
                tcfg=TrainerConfig(total_steps=2, checkpoint_every=2),
                device="cpu")
    out = t.run()
    cost = out["cost"]
    assert cost["chips"] == 1
    assert cost["elastic_usd"] > 0
    assert 0 < cost["utilization_breakeven"] < 1
    assert cost["storage"]["writes"] > 0


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_cfgs()[1], ObjectStore(), DATA)


def test_training_slice_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.train.trainer, repro_torch.launch.train, "
            "repro_torch.train.grad_compression, "
            "repro_torch.checkpoint.object_store_ckpt, "
            "repro_torch.data.pipeline\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'ml_dtypes')\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": src},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_train_launcher_on_the_cpu(capsys):
    out = train_launch.main(["--arch", "recurrentgemma-2b", "--steps", "3",
                             "--seq-len", "16", "--global-batch", "2",
                             "--checkpoint-every", "2", "--device", "cpu"])
    assert out["status"] == "done" and out["steps"] == 3
    assert out["cost"]["storage"]["writes"] > 0
    printed = capsys.readouterr().out
    assert "step     3 loss" in printed and "done" in printed
