"""The port's ``forward_train`` against the JAX reference, on the CPU.

Every registered architecture's ``reduced()`` config (``remat="block"``:
the port's ``torch.utils.checkpoint`` units against the reference's
``jax.checkpoint`` scan body) with the reference's weights loaded through
``models.convert``: the masked loss within rtol 1e-5. Then the gradients
of one ``attn`` (InternLM2), ``local``/``rec`` (RecurrentGemma),
``rwkv`` (RWKV-6) and ``moe`` (DeepSeekMoE, with a nonzero load-balance
term) config, leaf by leaf through ``convert.to_reference``:
max |g_port - g_ref| <= 1e-4 max |g_ref| + 1e-6 (float32, the same sums
in other orders through a few layers and their backward). Token batches
from numpy seeds; the embedding-input configs (MusicGen, Qwen2-VL with
M-RoPE positions) take ``data.pipeline.embeddings_batch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtfm
from repro.models.common import split_tree
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data.pipeline import embeddings_batch
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

torch.backends.cuda.matmul.allow_tf32 = False

B, S = 2, 24
# The archs both registries list: an arch only the port has (DeepSeek-V2's
# latent attention) is held against its PyTorch reference instead
# (tests/test_torch_mla.py).
BOTH = sorted(TARCHS.keys() & JARCHS.keys())
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
GRAD_ARCHS = ["internlm2-1.8b", "recurrentgemma-2b", "rwkv6-1.6b",
              "deepseek-moe-16b"]


def reference_params(arch, seed=0):
    jcfg = JARCHS[arch].reduced()
    params, _ = split_tree(jtfm.init_model(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(np.asarray, params)


def train_batch(cfg, seed=0, *, mask=False, b=B, s=S):
    """A numpy training batch of ``cfg``'s input mode."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        batch = embeddings_batch(cfg, b, s, step=seed, seed=seed)
    else:
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if mask:
        batch["mask"] = (rng.random((b, s)) < 0.75).astype(np.float32)
    return batch


def jax_loss_fn(jcfg, impl="reference"):
    return jax.jit(lambda p, b: jtfm.forward_train(p, jcfg, b, impl=impl))


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", BOTH)
def test_forward_train_loss_matches_reference(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = reference_params(arch)
    batch = train_batch(tcfg, seed=1, mask=True)
    jloss, jm = jax_loss_fn(jcfg)(params, jax.tree.map(jnp.asarray, batch))
    model = convert.from_reference(tcfg, params, device="cpu")
    with torch.no_grad():
        tloss, tm = ttfm.forward_train(model, tcfg, torch_batch(batch))
    assert tloss.dtype == torch.float32 and tloss.shape == ()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    assert float(tm["nll"]) == float(tloss)


def _assert_grads_close(got: dict, want: dict, path=""):
    for k, w in want.items() if isinstance(want, dict) else enumerate(want):
        g = got[k]
        if isinstance(w, (dict, list)):
            _assert_grads_close(g, w, f"{path}/{k}")
            continue
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, k)
        err = float(np.max(np.abs(g - w))) if w.size else 0.0
        bound = GRAD_REL * float(np.max(np.abs(w))) + GRAD_ABS
        assert err <= bound, (f"{path}/{k}", err, bound)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = reference_params(arch)
    batch = train_batch(tcfg, seed=2)
    jgrads, jaux = jax.jit(jax.grad(
        lambda p, b: (lambda out: (out[0], out[1]["aux"]))(
            jtfm.forward_train(p, jcfg, b)), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    model = convert.from_reference(tcfg, params, device="cpu")
    names, leaves = zip(*model.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = ttfm.forward_train(model, tcfg, torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    if tcfg.moe:
        # The load-balance term reaches the router's gradient.
        aux = float(metrics["aux"].detach())
        assert aux > 0
        np.testing.assert_allclose(aux, float(jaux),
                                   rtol=LOSS_RTOL)
    got = convert.to_reference(tcfg, dict(zip(names, grads)))
    _assert_grads_close(got, jax.tree.map(np.asarray, jgrads))


def test_to_reference_inverts_from_reference():
    """Every leaf comes back equal, bfloat16 widened to float32."""
    arch = "recurrentgemma-2b"
    tcfg = TARCHS[arch].reduced()
    params = reference_params(arch)
    back = convert.to_reference(tcfg, convert.from_reference(
        tcfg, params, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    bf = convert.to_reference(tcfg, convert.from_reference(
        tcfg, params, device="cpu", dtype=torch.bfloat16))
    want = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                             np.float32), params)
    jax.tree.map(np.testing.assert_array_equal, bf, want)
