"""The port's model kernels and model modules against the JAX reference.

Flash attention and the RG-LRU scan (``repro_torch.kernels``) against the
Pallas kernels in interpret mode and the jnp oracles of
``repro.kernels.ref``; on the CPU each wrapper runs its kernel's plain
PyTorch version. Then one test per model module (``rms_norm``, rotary
embeddings, ``mlp``, ``attention_prefill``, ``attention_decode``,
``rglru_block``, ``rglru_block_decode``) against its JAX counterpart with
the reference's weights. Inputs are made with numpy from a seed.

Tolerances: float32 2e-5 for attention and 1e-5 for the scan (the
reference's own kernel tests), bfloat16 2e-2 (one bf16 rounding of the
output); module outputs float32 within 2e-5 (one reduction order against
another).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_hmajor
from repro.kernels.rglru_scan import rglru_scan_blocked
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import rglru as trglru
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MOD_TOL = 2e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _jax_params(tree):
    params, _ = jcommon.split_tree(tree)
    return jax.tree.map(np.asarray, params)


def _torch_params(params):
    return {k: _torch_params(v) if isinstance(v, dict) else _t(v)
            for k, v in params.items()}


# -- flash attention ---------------------------------------------------------

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(1, 64, 2, 2, 16), (2, 128, 4, 2, 32), (1, 256, 8, 1, 16),  # MQA
          (2, 96, 6, 3, 8)]                                  # non-pow2 heads
MASKS = [(True, 0), (True, 48), (False, 0)]


def _qkv(rng, b, sq, skv, h, hkv, d, dtype):
    """The same bits for both frameworks (rounded to ``dtype`` once)."""
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    j = [jnp.asarray(a, _JDT[dtype]) for a in arrs]
    t = [_t(np.asarray(x.astype(jnp.float32))).to(_TDT[dtype]) for x in j]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_sweep_vs_ref(rng, dtype, b, s, h, hkv, d, causal,
                                      window):
    (jq, jk, jv), (q, k, v) = _qkv(rng, b, s, s, h, hkv, d, dtype)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == _TDT[dtype] and got.shape == q.shape
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(got, want, _TOL[dtype])
    _close(tref.flash_attention_ref(q, k, v, causal=causal, window=window),
           want, _TOL[dtype])


@pytest.mark.parametrize("b,s,h,hkv,d,causal,window",
                         [shape + (True, 48) for shape in SHAPES]
                         + [SHAPES[1] + (True, 0), SHAPES[1] + (False, 0)])
def test_flash_attention_vs_pallas_interpret(rng, b, s, h, hkv, d, causal,
                                             window):
    (jq, jk, jv), (q, k, v) = _qkv(rng, b, s, s, h, hkv, d, "float32")
    want = flash_attention_hmajor(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal=causal, window=window,
        block_q=32, block_k=32, interpret=True).transpose(0, 2, 1, 3)
    _close(tfa.flash_attention(q, k, v, causal=causal, window=window), want,
           _TOL["float32"])


@pytest.mark.parametrize("sq,skv,causal,window", [
    (100, 100, True, 0), (100, 100, True, 48), (100, 100, False, 17),
    (33, 75, True, 0), (75, 33, False, 0), (1, 45, False, 0)])
def test_flash_attention_ragged_lengths(rng, sq, skv, causal, window):
    """Lengths that are no tile multiple (the reference kernel asserts
    divisibility, so the oracle is the jnp reference)."""
    (jq, jk, jv), (q, k, v) = _qkv(rng, 2, sq, skv, 4, 2, 16, "float32")
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(tfa.flash_attention(q, k, v, causal=causal, window=window), want,
           _TOL["float32"])


def test_flash_attention_fully_masked_rows_give_zero(rng):
    """Queries 40..63 see no key (window 8 past the last of 32 keys): the
    Pallas kernel's guard and denominator floor give 0 there, and so must
    the port."""
    (jq, jk, jv), (q, k, v) = _qkv(rng, 1, 64, 32, 4, 2, 16, "float32")
    want = flash_attention_hmajor(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal=False, window=8, block_q=32,
        block_k=32, interpret=True).transpose(0, 2, 1, 3)
    got = tfa.flash_attention(q, k, v, causal=False, window=8)
    _close(got, want, _TOL["float32"])
    assert not got[:, 40:].any()
    assert bool(got[:, :39].abs().amax(dim=-1).gt(0).all())


def test_flash_attention_convex_and_checks(rng):
    (_, _, _), (q, k, v) = _qkv(rng, 1, 64, 64, 2, 2, 8, "float32")
    out = tfa.flash_attention(q, k, v, causal=False)
    assert float(out.max()) <= float(v.max()) + 1e-4
    assert float(out.min()) >= float(v.min()) - 1e-4
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 64, 3, 8),
                            torch.zeros(1, 64, 3, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k.to(torch.bfloat16), v)


# -- RG-LRU scan --------------------------------------------------------------

@pytest.mark.parametrize("b,s,w,chunk,bw", [
    (1, 32, 16, 8, 8),
    (2, 100, 64, 16, 32),
    (1, 256, 32, 64, 32),
])
def test_rglru_scan_vs_reference(rng, b, s, w, chunk, bw):
    la = -np.exp(rng.standard_normal((b, s, w)).astype(np.float32))
    b_in = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    got_all, got_last = trg.rglru_scan(_t(la), _t(b_in), _t(h0))
    want_all, want_last = jref.rglru_scan_ref(jnp.asarray(la),
                                              jnp.asarray(b_in),
                                              jnp.asarray(h0))
    _close(got_all, want_all, 1e-5)
    _close(got_last, want_last, 1e-5)
    pad = (-s) % chunk
    pal_all, pal_last = rglru_scan_blocked(
        jnp.pad(la, ((0, 0), (0, pad), (0, 0))),
        jnp.pad(b_in, ((0, 0), (0, pad), (0, 0))), jnp.asarray(h0),
        chunk=chunk, block_w=bw, interpret=True)
    _close(got_all, pal_all[:, :s], 1e-5)
    _close(got_last, pal_last, 1e-5)


def test_rglru_scan_strong_decay_is_exact(rng):
    b, s, w = 1, 64, 8
    la = np.full((b, s, w), -40.0, np.float32)
    b_in = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = np.full((b, w), 1e6, np.float32)
    got_all, got_last = trg.rglru_scan(_t(la), _t(b_in), _t(h0))
    assert bool(torch.isfinite(got_all).all())
    pal_all, pal_last = rglru_scan_blocked(jnp.asarray(la), jnp.asarray(b_in),
                                           jnp.asarray(h0), chunk=16,
                                           block_w=8, interpret=True)
    _, want_last = jref.rglru_scan_ref(jnp.asarray(la), jnp.asarray(b_in),
                                       jnp.asarray(h0))
    _close(got_last, want_last, 1e-5)
    _close(got_all, pal_all, 1e-5)


def test_rglru_scan_checks():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        trg.rglru_scan(x, x, torch.zeros(1, 4))
    with pytest.raises(ValueError):
        trg.rglru_scan(x.double(), x.double(), torch.zeros(1, 8).double())


# -- model modules ----------------------------------------------------------

def _cfgs(name):
    return JARCHS[name].reduced(), TARCHS[name].reduced()


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(tcommon.rms_norm(_t(x), _t(w), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), MOD_TOL)
    xb = _t(x).to(torch.bfloat16)
    assert tcommon.rms_norm(xb, _t(w)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rotary_embeddings(rng, theta):
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 12)).astype(np.int32)
    _close(tcommon.apply_rope(_t(x), _t(pos), theta),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           1e-4)
    pos3 = rng.integers(0, 500, (3, 2, 12)).astype(np.int32)
    _close(tcommon.apply_mrope(_t(x), _t(pos3), (4, 2, 2), theta),
           jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (4, 2, 2),
                               theta), 1e-4)


def test_mlp(rng):
    params = _jax_params(jmlp.init_mlp(jax.random.PRNGKey(1), 64, 128))
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    _close(tmlp.mlp(_torch_params(params), _t(x)),
           jmlp.mlp(params, jnp.asarray(x)), MOD_TOL)


_jattn = jax.jit(jattn.attention, static_argnames=("cfg", "window"))
_jattn_prefill = jax.jit(jattn.attention_prefill,
                         static_argnames=("cfg", "cache_len", "window"))
_jattn_decode = jax.jit(jattn.attention_decode,
                        static_argnames=("cfg", "window"))


@pytest.mark.parametrize("arch,window,s,cache_len", [
    ("recurrentgemma-2b", 16, 24, 40),    # rolling window cache
    ("recurrentgemma-2b", 16, 12, 40),    # prompt shorter than the window
    ("internlm2-1.8b", 0, 24, 40),
    ("qwen1.5-110b", 0, 20, 16),          # qkv bias; prompt past the cache
])
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_attention_prefill_and_decode(rng, arch, window, s, cache_len, impl):
    jcfg, tcfg = _cfgs(arch)
    params = _jax_params(jattn.init_attention(jax.random.PRNGKey(2), jcfg))
    tp = _torch_params(params)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s))
    jy, jc = _jattn_prefill(params, jnp.asarray(x), jcfg, jnp.asarray(pos),
                            cache_len=cache_len, window=window)
    ty, tc = tattn.attention_prefill(tp, _t(x), tcfg, _t(pos),
                                     cache_len=cache_len, window=window,
                                     impl=impl)
    _close(ty, jy, MOD_TOL)
    _close(tc.k, jc.k, MOD_TOL)
    _close(tc.v, jc.v, MOD_TOL)
    assert tc.length == int(jc.length)
    _close(tattn.attention(tp, _t(x), tcfg, _t(pos), window=window,
                           impl=impl),
           _jattn(params, jnp.asarray(x), jcfg, jnp.asarray(pos),
                  window=window), MOD_TOL)
    for step in range(3):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jc = _jattn_decode(params, jnp.asarray(xd), jcfg,
                               jnp.asarray(s + step, jnp.int32), jc,
                               window=window)
        ty, tc = tattn.attention_decode(tp, _t(xd), tcfg, s + step, tc,
                                        window=window)
        _close(ty, jy, MOD_TOL)
        _close(tc.k, jc.k, MOD_TOL)
        assert tc.length == int(jc.length)


_jrglru_block = jax.jit(jrglru.rglru_block, static_argnames=("cfg",))
_jrglru_decode = jax.jit(jrglru.rglru_block_decode, static_argnames=("cfg",))


def test_rglru_block_and_decode(rng):
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    params = _jax_params(jrglru.init_rglru(jax.random.PRNGKey(3), jcfg))
    tp = _torch_params(params)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    jy, js = _jrglru_block(params, jnp.asarray(x), jcfg)
    for use_kernel in (False, True):
        ty, ts = trglru.rglru_block(tp, _t(x), tcfg, use_kernel=use_kernel)
        _close(ty, jy, MOD_TOL)
        _close(ts.h, js.h, MOD_TOL)
        _close(ts.conv, js.conv, MOD_TOL)
    # A block that continues from a state, then decode steps.
    x2 = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jy, js = _jrglru_block(params, jnp.asarray(x2), jcfg, js)
    ty, ts = trglru.rglru_block(tp, _t(x2), tcfg, ts, use_kernel=True)
    _close(ty, jy, MOD_TOL)
    _close(ts.h, js.h, MOD_TOL)
    for _ in range(3):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, js = _jrglru_decode(params, jnp.asarray(xd), jcfg, js)
        ty, ts = trglru.rglru_block_decode(tp, _t(xd), tcfg, ts)
        _close(ty, jy, MOD_TOL)
        _close(ts.h, js.h, MOD_TOL)
        _close(ts.conv, js.conv, MOD_TOL)
