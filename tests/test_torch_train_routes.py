"""The port's stand-in routes and the forward of the configs no other port
test holds, against the JAX reference on the CPU.

Routes (the port's counterparts of ``tests/test_substrate.py``'s
blocked and chunked tests, at their tolerance, rel 1e-4): ``impl=
"blocked"`` (``_blocked_sdpa``'s online softmax over key blocks; for
``local`` layers at window <= length, ``_local_sdpa``'s chunk pairs) and
the RG-LRU ``scan_impl`` ``chunked`` and ``chunked_block`` against the
port's reference route; each also against the reference's own loss on
the same route within 1e-5. Lengths: 32 (as the reference's test), 40
(not a whole number of the reduced window of 16: the local chunks pad)
and 300 (two 256-step chunks, the second mostly identity padding: the
``valid`` mask must keep the carried state from moving), plus 12, below
the window, where the blocked route masks the window itself. The
log-depth ``linear_scan`` is held against the sequential oracle.

Forward parity (prefill and one decode step, the reference route and the
kernel route with the kernels' plain versions, logits and caches within
1e-4) for StableLM-3B (head dim 80), DeepSeek-7B, Qwen1.5-110B (QKV
bias), Qwen2-VL-7B (embedding input, M-RoPE) and MusicGen-medium
(embedding input, no RoPE).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtfm
from repro.models.rglru import linear_scan as jlinear_scan
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ref as kref
from repro_torch.models import convert
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttfm
from test_torch_serve import _assert_caches_match, _close
from test_torch_train_model import reference_params, torch_batch, \
    train_batch
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

REL = 1e-4          # the reference's own blocked/chunked tolerance
PARITY_RTOL = 1e-5  # the same route in both packages
CACHE_LEN = 40


def _with_scan(cfg, scan_impl, chunk=8):
    return dataclasses.replace(cfg, recurrent=dataclasses.replace(
        cfg.recurrent, scan_impl=scan_impl, chunk=chunk))


def _losses(arch, *, s, impl="reference", scan_impl=None):
    """(port loss on ``impl``, port loss on the reference route, the
    reference's loss on ``impl``) for one batch of length ``s``."""
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = reference_params(arch)
    model = convert.from_reference(tcfg, params, device="cpu")
    batch = train_batch(tcfg, seed=3, s=s)
    with torch.no_grad():
        base, _ = ttfm.forward_train(model, tcfg, torch_batch(batch))
    if scan_impl:
        jcfg, tcfg = _with_scan(jcfg, scan_impl), _with_scan(tcfg, scan_impl)
    with torch.no_grad():
        got, _ = ttfm.forward_train(model, tcfg, torch_batch(batch),
                                    impl=impl)
    want, _ = jax.jit(lambda p, b: jtfm.forward_train(p, jcfg, b,
                                                      impl=impl))(
        params, jax.tree.map(jnp.asarray, batch))
    return float(got), float(base), float(want)


@pytest.mark.parametrize("arch,s", [("deepseek-7b", 32),
                                    ("recurrentgemma-2b", 32),
                                    ("recurrentgemma-2b", 40),
                                    ("recurrentgemma-2b", 12)])
def test_blocked_impl_matches_reference_loss(arch, s):
    got, base, want = _losses(arch, s=s, impl="blocked")
    assert got == pytest.approx(base, rel=REL)
    assert got == pytest.approx(want, rel=PARITY_RTOL)


@pytest.mark.parametrize("scan_impl", ["chunked", "chunked_block"])
@pytest.mark.parametrize("s", [32, 300])
def test_chunked_scans_match(scan_impl, s):
    got, base, want = _losses("recurrentgemma-2b", s=s, scan_impl=scan_impl)
    assert got == pytest.approx(base, rel=REL)
    assert got == pytest.approx(want, rel=PARITY_RTOL)


def test_chunked_block_padding_is_identity():
    """At a ragged length the block's output and carried state equal the
    unchunked block's: the padded steps are identity updates."""
    cfg = TARCHS["recurrentgemma-2b"].reduced()
    params = reference_params("recurrentgemma-2b")
    model = convert.from_reference(cfg, params, device="cpu")
    rgl = model.layers[0]["rgl"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 300, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, st = trglru.rglru_block(rgl, x, cfg)
        yc, stc = trglru.rglru_block(rgl, x, _with_scan(cfg, "chunked_block"))
    torch.testing.assert_close(yc, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stc.h, st.h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stc.conv, st.conv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 7, 64, 300])
def test_linear_scan_matches_oracle_and_reference(s):
    rng = np.random.default_rng(s)
    la = -np.abs(rng.standard_normal((2, s, 24))).astype(np.float32) * 3
    bb = rng.standard_normal((2, s, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (la, bb, h0)]
    got_all, got_last = trglru.linear_scan(*t)
    ora_all, ora_last = kref.rglru_scan_ref(*t)
    torch.testing.assert_close(got_all, ora_all, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_last, ora_last, rtol=1e-5, atol=1e-6)
    j_all, _ = jax.jit(jlinear_scan)(jnp.asarray(la), jnp.asarray(bb),
                                     jnp.asarray(h0))
    np.testing.assert_allclose(got_all.numpy(), np.asarray(j_all),
                               rtol=1e-5, atol=1e-6)
    c_all, c_last = trglru.linear_scan_chunked(*t, chunk=16)
    torch.testing.assert_close(c_all, ora_all, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c_last, ora_last, rtol=1e-5, atol=1e-6)


NEW_ARCHS = ["stablelm-3b", "deepseek-7b", "qwen1.5-110b", "qwen2-vl-7b",
             "musicgen-medium"]


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = reference_params(arch)
    model = convert.from_reference(tcfg, params, device="cpu")
    batch = train_batch(tcfg, seed=5)
    batch.pop("labels")
    s = 24
    jlogits, jcaches = jax.jit(lambda p, b: jtfm.forward_prefill(
        p, jcfg, b, CACHE_LEN, impl=impl))(
        params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        tlogits, tcaches = ttfm.forward_prefill(model, tcfg,
                                                torch_batch(batch),
                                                CACHE_LEN, impl=impl)
    _close(tlogits, jlogits)
    _assert_caches_match(jcfg, tcaches, jcaches)
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]
    jlogits, jcaches = jax.jit(lambda p, t, c, pos: jtfm.forward_decode(
        p, jcfg, t, c, pos))(params, jnp.asarray(tok), jcaches,
                             jnp.asarray(s, jnp.int32))
    with torch.no_grad():
        tlogits, tcaches = ttfm.forward_decode(
            model, tcfg, torch.from_numpy(tok), tcaches, s)
    _close(tlogits, jlogits)
    _assert_caches_match(jcfg, tcaches, jcaches)
