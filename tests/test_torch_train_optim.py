"""The port's optimizer, gradient compression and data pipeline against
the JAX reference, on the CPU.

``apply_updates`` on the same parameters (float32 and bfloat16), grads
and state as the reference's, with float32 and bfloat16 moments and the
clip active and inactive: float32 results within 1e-6 relative to the
largest value of the leaf, bfloat16 ones at most one bfloat16 ulp apart
(the same float32 value may land on either side of a rounding edge).
Then the reference's three optimizer tests on the port. ``ef_compress``
and the int8 quantizer equal the reference's (the fed-back error within
one float32 rounding of q * scale); the error-feedback
property test of ``tests/test_properties.py`` on the port. The data
pipeline's batches, embedding batches, packed rows and prefetch plans
are byte-equal to the reference's, and its tests run on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypo_compat import given, settings, st

from repro.data import pipeline as jpipe
from repro.train import grad_compression as jgc
from repro.train import optimizer as jopt
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data import pipeline as tpipe
from repro_torch.train import grad_compression as tgc
from repro_torch.train import optimizer as topt
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

SHAPES = {"w": (6, 5), "b": (5,), "e": (3, 4, 2), "s": (7,)}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _assert_close(got: torch.Tensor, want, dtype):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    if dtype == torch.bfloat16:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
            np.max(np.abs(got - want))
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("start", [0, 5])
def test_apply_updates_matches_reference(param_dtype, moment_dtype,
                                         grad_clip, start):
    """One update from the initial state (step 0) and from a state in
    mid-run (step 5, moments nonzero); grad_clip 1.0 clips these grads
    (global norm about 8), 0.0 turns clipping off."""
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20,
               moment_dtype=moment_dtype, grad_clip=grad_clip)
    rng = np.random.default_rng(start)
    jdt = jnp.bfloat16 if param_dtype == torch.bfloat16 else jnp.float32
    mdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    arr = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
    mu = {k: (rng.standard_normal(s) * 0.1 * bool(start)).astype(np.float32)
          for k, s in SHAPES.items()}
    nu = {k: (rng.random(s) * 0.01 * bool(start)).astype(np.float32)
          for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in arr.items()}
    jstate = jopt.OptState(jnp.asarray(start, jnp.int32),
                           {k: jnp.asarray(v, mdt) for k, v in mu.items()},
                           {k: jnp.asarray(v, mdt) for k, v in nu.items()})
    jnew, jst, jm = jax.jit(lambda p, g, s: jopt.apply_updates(
        p, g, s, jopt.AdamWConfig(**cfg)))(
        jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate)
    # jnp.asarray may alias the numpy moments that the port's in-place
    # update writes below, and jit returns before it runs: wait for it.
    jax.block_until_ready((jnew, jst, jm))

    tmd = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    tp = {k: torch.from_numpy(v).to(param_dtype) for k, v in arr.items()}
    tstate = topt.OptState(
        torch.tensor(start, dtype=torch.int32),
        {k: torch.from_numpy(v).to(tmd) for k, v in mu.items()},
        {k: torch.from_numpy(v).to(tmd) for k, v in nu.items()})
    tnew, tst, tm = topt.apply_updates(
        tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
        topt.AdamWConfig(**cfg))
    assert int(tst.step) == int(jst.step) == start + 1
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for k in SHAPES:
        assert tnew[k].dtype == param_dtype
        assert tst.mu[k].dtype == tst.nu[k].dtype == tmd
        _assert_close(tnew[k], jnew[k], param_dtype)
        _assert_close(tst.mu[k], jst.mu[k], tmd)
        _assert_close(tst.nu[k], jst.nu[k], tmd)


def test_adamw_decreases_quadratic_loss():
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                           weight_decay=0.0, moment_dtype="float32")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init_opt_state(params, cfg)
    for _ in range(60):
        g = {"w": 2 * params["w"]}          # grad of sum(w^2)
        params, state, _ = topt.apply_updates(params, g, state, cfg)
    assert float(torch.sum(torch.square(params["w"]))) < 0.5


def test_schedule_warmup_and_cosine():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    assert float(topt.schedule(0, cfg)) == 0.0
    assert float(topt.schedule(10, cfg)) == pytest.approx(1.0)
    assert float(topt.schedule(100, cfg)) == pytest.approx(0.1)
    for step in (0, 3, 10, 37, 100, 150):
        assert float(topt.schedule(torch.tensor(step), cfg)) == float(
            jopt.schedule(jnp.asarray(step), jopt.AdamWConfig(
                lr=1.0, warmup_steps=10, total_steps=100,
                min_lr_ratio=0.1)))


def test_grad_clip_bounds_update():
    cfg = topt.AdamWConfig(lr=0.1, grad_clip=1.0, warmup_steps=0,
                           weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = topt.init_opt_state(params, cfg)
    huge = {"w": torch.tensor([1e9, -1e9, 1e9])}
    p2, _, m = topt.apply_updates(params, huge, state, cfg)
    assert float(m["grad_norm"]) > 1e8
    assert bool(torch.all(torch.isfinite(p2["w"])))


# -- gradient compression -------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_ef_compress_equals_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((33, 7)) * 10.0 ** (seed - 2)).astype(
        np.float32)
    e = (rng.standard_normal((33, 7)) * 1e-3).astype(np.float32)
    jq, js, je = jax.jit(jgc.ef_compress)(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = tgc.ef_compress(torch.from_numpy(g), torch.from_numpy(e))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    # new_error = target - q * scale: XLA may fuse the product into the
    # subtraction, so the two differ by at most one rounding of q * scale.
    target = g + e
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=2.0 ** -23 * np.max(np.abs(target)))
    np.testing.assert_array_equal(
        tgc.dequantize_int8(tq, ts).numpy(),
        np.asarray(jgc.dequantize_int8(jq, js)))


def test_compressed_psum_without_pod_axis_and_error_state():
    rng = np.random.default_rng(0)
    parts = {"a": rng.standard_normal((1, 4, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal((1, 5)).astype(np.float32)}}
    jerr = jgc.init_error_state(jax.tree.map(jnp.asarray, parts))
    jout, _ = jgc.compressed_psum(jax.tree.map(jnp.asarray, parts), jerr,
                                  jax.make_mesh((1, 1), ("data", "model")))
    tparts = {"a": torch.from_numpy(parts["a"]),
              "b": {"c": torch.from_numpy(parts["b"]["c"])}}
    terr = tgc.init_error_state(tparts)
    assert not terr["a"].any() and terr["b"]["c"].dtype == torch.float32
    tout, terr2 = tgc.compressed_psum(tparts, terr)
    assert terr2 is terr
    np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
    np.testing.assert_array_equal(tout["b"]["c"].numpy(),
                                  np.asarray(jout["b"]["c"]))

    class DataModelMesh:
        mesh_dim_names = ("data", "model")

    # A mesh without the pod axis is one pod: the partials unreduced
    # (the pod axis itself: tests/test_torch_dist_compress.py).
    tout, terr2 = tgc.compressed_psum(tparts, terr, DataModelMesh())
    assert terr2 is terr
    np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-3, 1e3))
def test_ef_quantization_error_bounded(seed, scale):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal((16,)) * scale).astype(
        np.float32))
    e = torch.zeros(16)
    q, s, new_e = tgc.ef_compress(g, e)
    # error bounded by half an int8 step
    assert float(torch.max(torch.abs(new_e))) <= float(s) * 0.5 + 1e-6
    # dequant + error reconstructs exactly
    np.testing.assert_allclose(q.numpy().astype(np.float32) * float(s)
                               + new_e.numpy(), g.numpy(),
                               rtol=1e-5, atol=float(s) * 1e-3)


# -- data pipeline -----------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_pipeline_batches_byte_equal(shards):
    cfg = dict(seq_len=16, global_batch=8, seed=3, vocab_size=100)
    for shard in range(shards):
        tp = tpipe.TokenPipeline(tpipe.DataConfig(**cfg), shard, shards)
        jp = jpipe.TokenPipeline(jpipe.DataConfig(**cfg), shard, shards)
        for step in (0, 1, 7, 123):
            a, b = tp.batch_at(step), jp.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes()
        assert tp.bytes_per_batch() == jp.bytes_per_batch()
        assert tp.prefetch_plan(workers=8) == jp.prefetch_plan(workers=8)


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_embeddings_batch_byte_equal(arch):
    from repro.configs.registry import ARCHS as JARCHS
    a = tpipe.embeddings_batch(TARCHS[arch].reduced(), 2, 12, step=4, seed=1)
    b = jpipe.embeddings_batch(JARCHS[arch].reduced(), 2, 12, step=4, seed=1)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_pipeline_deterministic_and_sharded():
    cfg = tpipe.DataConfig(seq_len=16, global_batch=8, seed=3,
                           vocab_size=100)
    a = tpipe.TokenPipeline(cfg).batch_at(5)
    b = tpipe.TokenPipeline(cfg).batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    s0 = tpipe.TokenPipeline(cfg, shard=0, num_shards=2).batch_at(5)
    s1 = tpipe.TokenPipeline(cfg, shard=1, num_shards=2).batch_at(5)
    assert s0["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_pipeline_prefetch_plan_within_burst():
    cfg = tpipe.DataConfig(seq_len=4096, global_batch=256)
    plan = tpipe.TokenPipeline(cfg).prefetch_plan(workers=8)
    assert plan["within_burst"] == 1.0
    assert plan == jpipe.TokenPipeline(jpipe.DataConfig(
        seq_len=4096, global_batch=256)).prefetch_plan(workers=8)


def test_pack_sequences_lossless():
    docs = [np.arange(1, 6), np.arange(10, 13), np.arange(20, 30)]
    rows, segs = tpipe.pack_sequences(docs, seq_len=8)
    flat = rows[segs > 0]
    np.testing.assert_array_equal(np.sort(flat),
                                  np.sort(np.concatenate(docs)))
    assert rows.shape[1] == 8
    jrows, jsegs = jpipe.pack_sequences(docs, seq_len=8)
    assert rows.tobytes() == jrows.tobytes()
    assert segs.tobytes() == jsegs.tobytes()
