"""The port's RWKV-6 scan and MoE grouped matmul, and the model modules
around them, against the JAX reference on the CPU.

``rwkv6_scan`` and ``gmm`` / ``moe_grouped_ffn`` (``repro_torch.kernels``;
on a CPU tensor each wrapper runs its kernel's plain PyTorch version)
against the Pallas kernels in interpret mode and the jnp oracles of
``repro.kernels.ref``. Then ``group_norm_heads``, the RWKV-6 time mix (both
routes), its decode step and the channel mix, and ``moe_layer`` (both
routes, with a forced capacity overflow and a decode-sized input), each
against its JAX counterpart with the reference's weights. Inputs are made
with numpy from a seed.

Tolerances: the scan 2e-4 in float32 (the reference's own kernel test:
a chunked form against a step loop), bfloat16 inputs 2e-2 (one bf16
rounding of the output); gmm 1e-5 in float32 with atol 8e-5 (the
reference's test, sums of up to 64 products) and 2e-2 in bf16; module
outputs float32 within 2e-5 (one reduction order against another), 1e-4
where a 24-step scan state is compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import gmm as pallas_gmm
from repro.kernels.rwkv6_scan import rwkv6_scan_hmajor
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv6 as trwkv
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCAN_TOL = 2e-4
BF16_TOL = 2e-2
MOD_TOL = 2e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol if atol is None else atol)


def _jax_params(tree):
    params, _ = jcommon.split_tree(tree)
    return jax.tree.map(np.asarray, params)


def _torch_params(params):
    return {k: _torch_params(v) if isinstance(v, dict) else _t(v)
            for k, v in params.items()}


def _cfgs(name):
    return JARCHS[name].reduced(), TARCHS[name].reduced()


# -- RWKV-6 scan ------------------------------------------------------------

def _rwkv_inputs(rng, b, s, h, k, decay_shift=-2.0, log_w=None):
    """The reference's kernel-test distributions, as float32 numpy."""
    f = lambda shape, scale: (rng.standard_normal(shape)  # noqa: E731
                              * scale).astype(np.float32)
    r, kk, v = (f((b, s, h, k), 0.5) for _ in range(3))
    lw = -np.exp(f((b, s, h, k), 0.5) + decay_shift) if log_w is None \
        else np.full((b, s, h, k), log_w, np.float32)
    u = f((h, k), 0.3)
    s0 = f((b, h, k, k), 0.1)
    return r, kk, v, lw.astype(np.float32), u, s0


@pytest.mark.parametrize("b,s,h,k,chunk", [
    (1, 32, 1, 8, 8),
    (2, 96, 2, 16, 32),
    (1, 128, 4, 16, 64),
])
def test_rwkv6_scan_vs_pallas_and_step_oracle(rng, b, s, h, k, chunk):
    arrs = _rwkv_inputs(rng, b, s, h, k)
    o, sf = trs.rwkv6_scan(*map(_t, arrs), chunk=chunk)
    assert o.dtype == torch.float32 and o.shape == (b, s, h, k)
    o_seq, s_seq = jref.rwkv6_step_ref(*map(jnp.asarray, arrs))
    _close(o, o_seq, SCAN_TOL)
    _close(sf, s_seq, SCAN_TOL)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    r, kk, v, lw, u, s0 = arrs
    o_pal, s_pal = rwkv6_scan_hmajor(tr(r), tr(kk), tr(v), tr(lw),
                                     jnp.asarray(u), jnp.asarray(s0),
                                     chunk=chunk, interpret=True)
    _close(o, tr(o_pal), SCAN_TOL)
    _close(sf, s_pal, SCAN_TOL)
    # The port's step oracle is the reference's.
    o_st, s_st = tref.rwkv6_step_ref(*map(_t, arrs))
    _close(o_st, o_seq, SCAN_TOL)
    _close(s_st, s_seq, SCAN_TOL)


@pytest.mark.parametrize("s,chunk", [(100, 32), (7, 64), (65, 64)])
def test_rwkv6_scan_ragged_length(rng, s, chunk):
    """S no whole number of chunks: zero padding inside the plain
    version, the reference's padding wrapper ``ops.rwkv6_scan`` outside."""
    arrs = _rwkv_inputs(rng, 2, s, 2, 16)
    o, sf = trs.rwkv6_scan(*map(_t, arrs), chunk=chunk)
    assert o.shape == (2, s, 2, 16)
    o_seq, s_seq = jref.rwkv6_step_ref(*map(jnp.asarray, arrs))
    _close(o, o_seq, SCAN_TOL)
    _close(sf, s_seq, SCAN_TOL)
    o_ops, s_ops = jops.rwkv6_scan(*map(jnp.asarray, arrs), chunk=chunk)
    _close(o, o_ops, SCAN_TOL)
    _close(sf, s_ops, SCAN_TOL)
    o_ch, s_ch = jref.rwkv6_chunked_ref(*map(jnp.asarray, arrs),
                                        chunk=chunk)
    _close(o, o_ch, SCAN_TOL)
    _close(sf, s_ch, SCAN_TOL)


def test_rwkv6_scan_strong_decay_is_exact(rng):
    """log_w = -6 over a 64-step chunk is a decay mass of 384: exp(384)
    overflows float32, so the reference's factorized kernel form breaks
    there; the port's plain version (exact pairwise decays) and the step
    oracle stay finite and agree."""
    arrs = _rwkv_inputs(rng, 1, 128, 2, 16, log_w=-6.0)
    o, sf = trs.rwkv6_scan(*map(_t, arrs), chunk=64)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(sf).all())
    o_seq, s_seq = jref.rwkv6_step_ref(*map(jnp.asarray, arrs))
    _close(o, o_seq, SCAN_TOL)
    _close(sf, s_seq, SCAN_TOL)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    r, kk, v, lw, u, s0 = arrs
    o_pal, _ = rwkv6_scan_hmajor(tr(r), tr(kk), tr(v), tr(lw),
                                 jnp.asarray(u), jnp.asarray(s0), chunk=64,
                                 interpret=True)
    assert not bool(jnp.isfinite(o_pal).all())


def test_rwkv6_scan_bf16_inputs(rng):
    arrs = _rwkv_inputs(rng, 2, 64, 2, 16)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in arrs[:3]]
    tb = [_t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
          for x in jb]
    rest_j = [jnp.asarray(a) for a in arrs[3:]]
    o, sf = trs.rwkv6_scan(*tb, *map(_t, arrs[3:]), chunk=16)
    assert o.dtype == torch.bfloat16 and sf.dtype == torch.float32
    o_seq, s_seq = jref.rwkv6_step_ref(*jb, *rest_j)
    assert o_seq.dtype == jnp.bfloat16
    _close(o, o_seq, BF16_TOL)
    _close(sf, s_seq, SCAN_TOL)


def test_rwkv6_scan_checks():
    x = torch.zeros(1, 8, 2, 4)
    u, s0 = torch.zeros(2, 4), torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError):
        trs.rwkv6_scan(x, x, x, x, torch.zeros(3, 4), s0)
    with pytest.raises(ValueError):
        trs.rwkv6_scan(x, x, x, x, u, torch.zeros(1, 2, 4, 5))
    with pytest.raises(ValueError):
        trs.rwkv6_scan(x.double(), x.double(), x.double(), x, u, s0)
    with pytest.raises(ValueError):
        trs.rwkv6_scan(x, x, x, x.to(torch.bfloat16), u, s0)


# -- grouped matmul ---------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("e,c,d,f,bc,bf,bd", [
    (2, 16, 32, 24, 8, 8, 16),
    (8, 64, 64, 48, 32, 16, 32),
    (1, 128, 16, 128, 128, 128, 16),
])
def test_gmm_vs_pallas_and_oracle(rng, dtype, tol, e, c, d, f, bc, bf, bd):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = jnp.asarray(rng.standard_normal((e, c, d)), jdt)
    w = jnp.asarray(rng.standard_normal((e, d, f)), jdt)
    tx, tw = (_t(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (x, w))
    got = tgmm.gmm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (e, c, f)
    want = pallas_gmm(x, w, block_c=bc, block_f=bf, block_d=bd,
                      interpret=True)
    _close(got, want, tol, tol * 8)
    _close(got, jref.gmm_ref(x, w), tol, tol * 8)


@pytest.mark.parametrize("e,c,d,f", [(4, 12, 32, 48), (3, 5, 24, 16)])
def test_moe_grouped_ffn_vs_oracle(rng, e, c, d, f):
    arrs = [(rng.standard_normal(shape) * s).astype(np.float32)
            for shape, s in (((e, c, d), 1.0), ((e, d, f), 0.2),
                             ((e, d, f), 0.2), ((e, f, d), 0.2))]
    got = tgmm.moe_grouped_ffn(*map(_t, arrs))
    _close(got, jref.moe_grouped_ffn_ref(*map(jnp.asarray, arrs)), 1e-5)
    # The reference's kernel route: three Pallas gmm calls.
    _close(got, jops.moe_grouped_ffn(*map(jnp.asarray, arrs)), 1e-5)
    _close(tref.moe_grouped_ffn_ref(*map(_t, arrs)), got, 1e-6)


def test_gmm_checks():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        tgmm.gmm(x, torch.zeros(2, 5, 6))
    with pytest.raises(ValueError):
        tgmm.gmm(x, torch.zeros(3, 4, 6))
    with pytest.raises(ValueError):
        tgmm.gmm(x, torch.zeros(2, 4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tgmm.gmm(x.double(), torch.zeros(2, 4, 6).double())


# -- model modules -----------------------------------------------------------

def test_group_norm_heads(rng):
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tcommon.group_norm_heads(_t(x), _t(w), _t(bias), 4),
           jcommon.group_norm_heads(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(bias), 4), MOD_TOL)
    got = tcommon.group_norm_heads(_t(x).to(torch.bfloat16),
                                   _t(w).to(torch.bfloat16),
                                   _t(bias).to(torch.bfloat16), 4)
    assert got.dtype == torch.bfloat16


_jtmix = jax.jit(jrwkv.rwkv_time_mix, static_argnames=("cfg", "use_kernel"))
_jtmix_decode = jax.jit(jrwkv.rwkv_time_mix_decode, static_argnames=("cfg",))
_jcmix = jax.jit(jrwkv.rwkv_channel_mix)


def _rwkv_params(cfg_j, seed):
    p = _jax_params(jrwkv.init_rwkv(jax.random.PRNGKey(seed), cfg_j))
    # The reference initialises u to zero and ln_x to (1, 0); draw them so
    # the bonus and the norm's affine part are exercised.
    rng = np.random.default_rng(seed)
    for name in ("bonus_u", "ln_x_w", "ln_x_b"):
        p[name] = (p[name] + rng.standard_normal(p[name].shape) * 0.3
                   ).astype(np.float32)
    return p


def _state(s):
    return trwkv.RwkvState(*(_t(np.asarray(a)) for a in s))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_time_mix_prefill_and_decode(rng, use_kernel):
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    params = _rwkv_params(jcfg, 4)
    tp = _torch_params(params)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)  # 2.5 chunks
    jy, js = _jtmix(params, jnp.asarray(x), jcfg)
    ty, ts = trwkv.rwkv_time_mix(tp, _t(x), tcfg, use_kernel=use_kernel)
    _close(ty, jy, MOD_TOL)
    for got, want in zip(ts, js):
        _close(got, want, 1e-4)
    # A block that continues from a state, on the reference's kernel route.
    x2 = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jy, js = _jtmix(params, jnp.asarray(x2), jcfg, js, use_kernel=True)
    ty, ts = trwkv.rwkv_time_mix(tp, _t(x2), tcfg, ts,
                                 use_kernel=use_kernel)
    _close(ty, jy, MOD_TOL)
    for got, want in zip(ts, js):
        _close(got, want, 1e-4)
    for _ in range(3):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, js = _jtmix_decode(params, jnp.asarray(xd), jcfg, js)
        ty, ts = trwkv.rwkv_time_mix_decode(tp, _t(xd), tcfg, ts)
        _close(ty, jy, MOD_TOL)
        for got, want in zip(ts, js):
            _close(got, want, 1e-4)


def test_rwkv_channel_mix(rng):
    jcfg, _ = _cfgs("rwkv6-1.6b")
    params = _jax_params(jrwkv.init_rwkv_channel_mix(jax.random.PRNGKey(5),
                                                     jcfg))
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x_prev = rng.standard_normal((2, 64)).astype(np.float32)
    _close(trwkv.rwkv_channel_mix(_torch_params(params), _t(x), _t(x_prev)),
           _jcmix(params, jnp.asarray(x), jnp.asarray(x_prev)), MOD_TOL)


_jmoe = jax.jit(jmoe.moe_layer, static_argnames=("cfg", "use_kernel"))


@pytest.mark.parametrize("arch,capacity_factor,s", [
    ("deepseek-moe-16b", 1.25, 24),     # shared experts
    ("deepseek-moe-16b", 0.25, 24),     # forced capacity overflow
    ("deepseek-moe-16b", 1.25, 1),      # decode: capacity 1 at batch 2
    ("qwen3-moe-235b-a22b", 1.25, 24),  # renormalized top-k, no shared
])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_layer(rng, arch, capacity_factor, s, use_kernel):
    jcfg, tcfg = _cfgs(arch)
    moe = dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, moe=moe)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    params = _jax_params(jmoe.init_moe(jax.random.PRNGKey(6), jcfg))
    tp = _torch_params(params)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    jy, jaux = _jmoe(params, jnp.asarray(x), jcfg, use_kernel=use_kernel)
    ty, taux = tmoe.moe_layer(tp, _t(x), tcfg, use_kernel=use_kernel)
    _close(ty, jy, MOD_TOL)
    _close(taux, jaux, 1e-6)
    x2d = _t(x).reshape(-1, 64)
    gates, idx, _ = tmoe._route(tp, x2d, tcfg.moe, tcfg.moe.norm_topk)
    cap = tmoe._capacity(2 * s, tcfg.moe)
    assert cap == jmoe._capacity(2 * s, jcfg.moe)
    _, slot, keep = tmoe._dispatch(x2d, gates, idx, cap,
                                   tcfg.moe.num_experts)
    _, jslot, jkeep = jmoe._dispatch(jnp.asarray(x2d.numpy()),
                                     jnp.asarray(gates.numpy()),
                                     jnp.asarray(idx.numpy()), cap,
                                     jcfg.moe.num_experts)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if capacity_factor < 1:
        assert not bool(keep.all())      # some slots dropped
    if s == 1:
        assert cap == 1
    if tcfg.moe.norm_topk:
        _close(gates.sum(-1), np.ones(2 * s, np.float32), 1e-6)
