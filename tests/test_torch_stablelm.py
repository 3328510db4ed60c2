"""StableLM-3B, the one registered model with a head dim (80) that is not
64, 128 or 256, against the JAX reference on the CPU.

Its ``reduced()`` config with ``head_dim`` kept at 80 (2 ``attn`` layers,
width 64, 4 heads, MHA): ``forward_prefill`` on the kernel route
(``impl="flash"``: flash attention's plain version on the CPU, the
wgmma kernel on the card, its head dim's 16-column tail zero-filled) and
on the reference route, then one greedy
``forward_decode`` step, each against the reference's model on the
reference's weights, carried across by ``models.convert``: last-token
logits and every layer's cache within 1e-4 (float32, a few layers of
differently ordered sums), greedy tokens identical. Prompts of 24 tokens
are made with numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtfm
from repro.models.common import split_tree
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH, HEAD_DIM = "stablelm-3b", 80
B, S, CACHE_LEN = 2, 24, 32
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JARCHS[ARCH].reduced(), head_dim=HEAD_DIM)
    tcfg = dataclasses.replace(TARCHS[ARCH].reduced(), head_dim=HEAD_DIM)
    params, _ = split_tree(jtfm.init_model(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, convert.from_reference(tcfg, params,
                                                      device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def test_full_config_takes_the_mma_route():
    """The published config's bf16 head dim of 80 takes the wgmma
    kernel's route (``"tc"``), which the mma.sync route held before."""
    cfg = TARCHS[ARCH]
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads) == (80, 32, 32)
    assert tfa._route(torch.bfloat16, cfg.head_dim) == "tc"


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_prefill_and_one_decode_step_match_reference(models, impl):
    jcfg, tcfg, params, model = models
    assert tcfg.head_dim == HEAD_DIM and tcfg.layer_kinds() == ["attn"] * 2
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jcaches = jtfm.forward_prefill(
        params, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN, impl=impl)
    tlogits, tcaches = ttfm.forward_prefill(
        model, tcfg, {"tokens": torch.from_numpy(toks)}, CACHE_LEN,
        impl=impl)
    _close(tlogits, jlogits)
    jlayers = list(convert.unstack_segments(
        jcfg, jax.tree.map(np.asarray, jcaches)))
    for (_, jc), tc in zip(jlayers, tcaches, strict=True):
        assert tc.k.shape[-1] == HEAD_DIM
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, -1).to(torch.int32)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    jlogits, _ = jtfm.forward_decode(params, jcfg, jtok[:, None], jcaches,
                                     jnp.asarray(S, jnp.int32))
    tlogits, _ = ttfm.forward_decode(model, tcfg, ttok[:, None], tcaches, S)
    _close(tlogits, jlogits)
    assert torch.argmax(tlogits, -1).tolist() \
        == np.asarray(jnp.argmax(jlogits, -1)).tolist()
