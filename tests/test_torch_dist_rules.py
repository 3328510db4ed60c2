"""The port's sharding rules against the reference's, with no processes.

``sharding.rules.pspec_for`` of every parameter of all ten registered
configs, full and ``reduced()``, on fake meshes (16, 16), (2, 16, 16),
(2, 4) and (4, 8), equals the reference's ``PartitionSpec`` (the port
keeps layers unstacked: its spec is the reference's without the leading
``layers`` entry), and the logical axes each ``init_*`` records
(``transformer.param_axes``) equal the reference's ``split_tree`` axes.
Also ``cache_pspec``, ``batch_pspec``, ``activation_rules``,
``dp_axes_for``, ``batch_shardings``, ``cache_shardings`` and the
DTensor placements of a spec. Shapes only: nothing is drawn.
"""
import functools

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.models.common import split_tree
from repro.sharding import rules as jrules
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import rules as trules
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

# The archs both registries list: an arch only the port has (DeepSeek-V2's
# latent attention) is held against its PyTorch reference instead
# (tests/test_torch_mla.py).
BOTH = sorted(TARCHS.keys() & JARCHS.keys())
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4)),
          "4x8": (("data", "model"), (4, 8))}


def fake_mesh(key):
    names, shape = MESHES[key]

    class _FakeMesh:
        axis_names = names

        class devices:
            pass
    _FakeMesh.devices.shape = shape
    return _FakeMesh()


def _spec(ps) -> tuple:
    return tuple(ps)


@functools.lru_cache(maxsize=None)
def reference_leaves(arch: str, reduced: bool) -> dict:
    """{port parameter name: (stacked shape, stacked axes)} of the
    reference's tree, by the port's layer order."""
    jcfg = JARCHS[arch].reduced() if reduced else JARCHS[arch]
    tree = jax.eval_shape(functools.partial(jtfm.init_model, cfg=jcfg),
                          jax.random.PRNGKey(0))
    shapes, axes = split_tree(tree)
    out = {}
    for k in ("embed", "ln_f", "lm_head"):
        if k in shapes:
            out[f"top.{k}"] = (tuple(shapes[k].shape), axes[k])
    base = 0
    for (unit, repeats), seg_s, seg_a in zip(
            jtfm.compute_segments(jcfg), shapes["segments"],
            axes["segments"]):
        for r in range(repeats):
            for j in range(len(unit)):
                i = base + r * len(unit) + j
                for path, leaf in _walk(seg_s[f"sub{j}"]):
                    ax = _at(seg_a[f"sub{j}"], path)
                    out[f"layers.{i}." + ".".join(path)] = \
                        (tuple(leaf.shape), ax)
        base += len(unit) * repeats
    return out


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _cfg(arch, reduced):
    return TARCHS[arch].reduced() if reduced else TARCHS[arch]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", BOTH)
def test_param_axes_match_reference(arch, reduced):
    ref = reference_leaves(arch, reduced)
    axes = ttfm.param_axes(_cfg(arch, reduced))
    shapes = ttfm.param_shapes(_cfg(arch, reduced))
    assert set(axes) == set(ref)
    for name, (shape, ax) in ref.items():
        stacked = name.startswith("layers.")
        assert axes[name] == (ax[1:] if stacked else ax), name
        assert shapes[name] == (shape[1:] if stacked else shape), name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", BOTH)
def test_pspec_for_matches_reference(arch, reduced, mesh):
    m = fake_mesh(mesh)
    axes = ttfm.param_axes(_cfg(arch, reduced))
    shapes = ttfm.param_shapes(_cfg(arch, reduced))
    n_sharded = 0
    for name, (shape, ax) in reference_leaves(arch, reduced).items():
        want = _spec(jrules.pspec_for(shape, ax, m))
        got = trules.pspec_for(shapes[name], axes[name], m)
        if name.startswith("layers."):
            assert want[0] is None, name
            want = want[1:]
        assert got == want, (name, got, want)
        n_sharded += any(e is not None for e in got)
    assert n_sharded > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_and_batch_pspec_match_reference(mesh):
    m = fake_mesh(mesh)
    for shape in [(2, 8, 4096, 8, 128), (3, 6, 2048, 1, 256),
                  (1, 32, 1024, 16, 64), (4, 1, 512, 2, 128),
                  (2, 64, 100, 3, 64)]:
        assert trules.cache_pspec(shape, m) == \
            _spec(jrules.cache_pspec(shape, m)), shape
    assert trules.batch_pspec(m) == _spec(jrules.batch_pspec(m))
    assert trules.activation_rules(m) == jrules.activation_rules(m)
    for b in (1, 2, 3, 4, 8, 16, 32, 48, 64, 512):
        assert tsteps.dp_axes_for(b, m) == jsteps.dp_axes_for(b, m), b


def test_rule_tables_equal_reference():
    assert trules.PARAM_RULES == jrules.PARAM_RULES
    assert trules.ACT_RULES == jrules.ACT_RULES
    assert trules.cache_logical_axes("kv") == \
        jrules.cache_logical_axes("kv")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-vl-7b",
                                  "musicgen-medium"])
def test_batch_shardings_match_reference(arch, kind):
    import jax.sharding as jsh
    m = fake_mesh("2x16x16")
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()

    class _Named:
        def __init__(self, mesh, spec):
            self.spec = spec
    saved = jsteps.NamedSharding
    jsteps.NamedSharding = _Named
    try:
        for b in (0, 8, 12, 64):
            want = jsteps.batch_shardings(jcfg, m, kind, b,
                                          jrules.activation_rules(m))
            got = tsteps.batch_shardings(tcfg, m, kind, b,
                                         trules.activation_rules(m))
            assert got == {k: _spec(v.spec) for k, v in want.items()}
            assert isinstance(next(iter(want.values())).spec,
                              jsh.PartitionSpec)
    finally:
        jsteps.NamedSharding = saved


FSDP_ACT = {"batch": ("data", "model"), "seq": None, "embed": None,
            "ff": None, "heads": None, "kv_heads": None, "vocab": None,
            None: None}


@pytest.mark.parametrize("act", ["none", "rules", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_local_rows_split_follows_batch_shardings(mesh, act):
    """The axes a step cuts its rows over (``steps.batch_axes``) are the
    batch entry of the reference's ``batch_shardings``, for batches that
    divide (pod, data), only data, or neither, under the default rules,
    the mesh's activation rules and the hillclimb's FSDP rules (batch on
    ``("data", "model")``); ``local_rows`` splits over exactly those axes
    and keeps a batch whole where they are empty."""
    m = fake_mesh(mesh)
    rules = {"none": None, "rules": jrules.activation_rules(m),
             "fsdp": FSDP_ACT}[act]
    jcfg, tcfg = JARCHS["internlm2-1.8b"].reduced(), \
        TARCHS["internlm2-1.8b"].reduced()

    class _Named:
        def __init__(self, mesh, spec):
            self.spec = spec
    saved = jsteps.NamedSharding
    jsteps.NamedSharding = _Named
    try:
        for b in (1, 2, 3, 4, 8, 12, 16, 24, 64, 512):
            for kind in ("train", "prefill", "decode"):
                want = jsteps.batch_shardings(jcfg, m, kind, b, rules)
                entry = want["tokens"].spec[0]
                want_axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                assert tsteps.batch_axes(tcfg, m, kind, b, rules) == \
                    tuple(want_axes), (b, kind)
    finally:
        jsteps.NamedSharding = saved


def test_local_rows_cuts_the_split_axes_pod_major(monkeypatch):
    """Each rank's rows of a (pod 2, data 2, model 2) mesh: over
    ``("pod", "data")`` pod-major, over ``("data",)`` the data index
    alone, the whole batch for ``()``; a batch that does not divide its
    axes raises."""
    import torch

    from repro_torch.core import shard_map as tsm
    names, _ = MESHES["2x16x16"]

    class _Mesh:
        mesh_dim_names = names
        shape = (2, 2, 2)

    coords = {"pod": 1, "data": 0, "model": 1}
    monkeypatch.setattr(tsm, "axis_index", lambda mesh, a: coords[a])
    batch = {"tokens": torch.arange(8)[:, None],
             "mrope_positions": torch.arange(8)[None, :, None].expand(
                 3, 8, 1)}
    rows = tsteps.local_rows(batch, _Mesh(), ("pod", "data"))
    assert rows["tokens"][:, 0].tolist() == [4, 5]
    assert rows["mrope_positions"][0, :, 0].tolist() == [4, 5]
    assert tsteps.local_rows(batch, _Mesh(), ("data",))["tokens"][
        :, 0].tolist() == [0, 1, 2, 3]
    assert tsteps.local_rows(batch, _Mesh(), ("data", "model"))["tokens"][
        :, 0].tolist() == [2, 3]
    assert tsteps.local_rows(batch, _Mesh(), ()) is batch
    with pytest.raises(ValueError):
        tsteps.local_rows({"tokens": torch.arange(6)[:, None]}, _Mesh(),
                          ("pod", "data"))


def test_cache_shardings_follow_reference():
    """The port's per-layer caches get the reference's stacked layout
    without its layers entry."""
    import torch

    from repro.models import transformer as jt
    m = fake_mesh("2x4")
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b", "internlm2-1.8b"):
        jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
        shapes = jax.eval_shape(lambda: jt.init_cache(jcfg, 8, 32,
                                                      jax.numpy.float32))

        class _Named:
            def __init__(self, mesh, spec):
                self.spec = spec
        saved = jsteps.NamedSharding
        jsteps.NamedSharding = _Named
        try:
            want = jsteps.cache_shardings(shapes, m)
        finally:
            jsteps.NamedSharding = saved
        caches = ttfm.init_cache(tcfg, 8, 32, torch.float32, device="cpu")
        got = tsteps.cache_shardings(caches, m)
        kinds = ttfm.layer_kinds(tcfg)
        flat = []
        for (unit, repeats), seg in zip(jt.compute_segments(jcfg), want):
            for _ in range(repeats):
                flat += [seg[f"sub{j}"] for j in range(len(unit))]
        assert len(flat) == len(got) == len(kinds)
        for g, w in zip(got, flat):
            for gs, ws in zip(g, w):
                if gs == ():      # the KV cache's length: a host int
                    continue
                assert gs == _spec(ws.spec)[1:], (arch, gs, ws.spec)


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None), [Shard(0), Shard(0), Replicate()]),
    (("data", "model"), [Replicate(), Shard(0), Shard(1)]),
    ((None, "model", "data"), [Replicate(), Shard(2), Shard(1)]),
    ((None, None), [Replicate(), Replicate(), Replicate()]),
])
def test_placements_for(spec, want):
    m = fake_mesh("2x16x16")
    m.mesh_dim_names = None
    assert trules.placements_for(spec, m) == want


def test_param_shardings_are_placements():
    m = fake_mesh("2x4")
    cfg = TARCHS["deepseek-moe-16b"].reduced()
    out = trules.param_shardings(ttfm.param_shapes(cfg),
                                 ttfm.param_axes(cfg), m)
    assert out["layers.1.ffn.w_gate"] == [Shard(1), Shard(0)]
    assert out["top.embed"] == [Shard(1), Shard(0)]
    shapes, placements = tsteps.model_shardings(cfg, m)
    assert placements == out and set(shapes) == set(out)
    opt = tsteps.opt_shardings(placements, m)
    assert opt.step == [Replicate(), Replicate()]
    assert opt.mu == placements and opt.nu == placements
