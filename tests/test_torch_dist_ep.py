"""The expert-parallel MoE (``moe_layer(mesh=...)``) against the
reference's ``_moe_ep``, on a (data 2, model 4) mesh of gloo CPU ranks.

The reference runs in a subprocess on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distribution.py`` does) and writes its weights, inputs and
EP outputs; the port's 8 ranks (``launch.mesh.spawn``) take the same
weights, placed by the rules (DTensors), and each its batch shard.
Both paths, at the **default** capacity factor (1.25: the per-shard
capacities and drops are the same on both sides): the all-to-all path
(qwen3-moe and deepseek-moe ``reduced()``, S = 8) and the psum path
(S = 1), within the reference test's 5e-4; the aux loss within rtol
1e-5. At capacity 16 (no drops) the EP layer also equals the port's
single-device layer. A planted fault, the return exchange without its
transpose (the slots come back in the wrong order), must fail. The
order of a pod-major batch shard is checked with distinct values per
shard against DTensor's ``distribute_tensor``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TOL = 5e-4                       # the reference test's bound
CASES = [("qwen3-moe-235b-a22b", 8), ("deepseek-moe-16b", 8),
         ("qwen3-moe-235b-a22b", 1), ("deepseek-moe-16b", 1)]
B = 4


def _run_reference(out_dir: Path) -> None:
    code = f"""
        import dataclasses, jax, jax.numpy as jnp, numpy as np
        from repro.configs.registry import ARCHS
        from repro.models import moe as moe_mod
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        for i, (arch, s) in enumerate({CASES!r}):
            cfg = ARCHS[arch].reduced()
            p = moe_mod.init_moe(jax.random.PRNGKey(i), cfg)
            params = jax.tree.map(lambda x: x.value, p,
                                  is_leaf=lambda x: hasattr(x, "axes"))
            rng = np.random.default_rng(i)
            x = jnp.asarray(rng.standard_normal(({B}, s, cfg.d_model)),
                            jnp.float32)
            y, aux = jax.jit(lambda p_, x_: moe_mod.moe_layer(
                p_, x_, cfg, mesh=mesh))(params, x)
            flat = {{"x": np.asarray(x), "y": np.asarray(y),
                    "aux": np.asarray(aux)}}
            for k, v in params.items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        flat["shared." + kk] = np.asarray(vv)
                else:
                    flat[k] = np.asarray(v)
            np.savez("{out_dir}/case%d.npz" % i, **flat)
        print("ok")
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def _params(npz, cfg, mesh):
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import split_tree
    whole = {}
    for k in npz.files:
        if k in ("x", "y", "aux"):
            continue
        if k.startswith("shared."):
            whole.setdefault("shared", {})[k[7:]] = torch.from_numpy(npz[k])
        else:
            whole[k] = torch.from_numpy(npz[k])
    _, axes = split_tree(moe_mod.init_moe(None, cfg))
    return whole, (tfm.distribute(whole, axes, mesh) if mesh else None)


def _faulty_from_experts(yb, mesh, tp):
    """The return exchange without the transpose: slots of other experts
    come back in the wrong places."""
    from repro_torch.core import shard_map as sm
    el, tc, d = yb.shape
    send = yb.reshape(tp, el, tc // tp, d).contiguous()
    return sm.all_to_all(send, mesh, "model").reshape(el * tp, tc // tp, d)


def rank_main(ref_dir: str) -> dict:
    """One rank's EP outputs of every case, and the single-device layer's
    on the same shard (capacity 16)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import shard_map as sm
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = mesh_mod.make_local_mesh(2, 4, device_type="cpu")
    rows = (("data",), None, None)
    out = {"cases": []}
    for i, (arch, s) in enumerate(CASES):
        npz = np.load(os.path.join(ref_dir, f"case{i}.npz"))
        cfg = ARCHS[arch].reduced()
        whole, dist_p = _params(npz, cfg, mesh)
        x = torch.from_numpy(npz["x"])
        xl = sm.local_shard(x, rows, mesh)
        y, aux = moe_mod.moe_layer(dist_p, xl, cfg, mesh=mesh)
        want = sm.local_shard(torch.from_numpy(npz["y"]), rows, mesh)
        case = {"err": float((y - want).abs().max()), "aux": float(aux),
                "aux_ref": float(npz["aux"])}
        big = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
        y16, _ = moe_mod.moe_layer(dist_p, xl, big, mesh=mesh)
        y1, _ = moe_mod.moe_layer(whole, x, big)
        case["err16"] = float((y16 - sm.local_shard(y1, rows, mesh))
                              .abs().max())
        if s > 1:
            saved = moe_mod._from_experts
            moe_mod._from_experts = _faulty_from_experts
            try:
                yf, _ = moe_mod.moe_layer(dist_p, xl, cfg, mesh=mesh)
            finally:
                moe_mod._from_experts = saved
            case["err_fault"] = float((yf - want).abs().max())
        out["cases"].append(case)
    # Distinct values per shard: a (pod, data) batch entry is pod-major,
    # as DTensor lays out Shard(0) on both dims.
    pmesh = mesh_mod.make_local_mesh(2, 2, pod=2, device_type="cpu")
    full = torch.arange(16.0).reshape(8, 2)
    spec = (("pod", "data"), None)
    mine = sm.local_shard(full, spec, pmesh)
    ref = distribute_tensor(full, pmesh, [Shard(0), Shard(0),
                                          torch.distributed.tensor.Replicate()]
                            ).to_local()
    out["shard_equal"] = bool(torch.equal(mine, ref))
    out["shard_rows"] = mine[:, 0].tolist()
    out["dp_index"] = sm.dp_index(pmesh)
    out["gathered"] = sm.gather_full(mine, spec, pmesh).tolist()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch import mesh as mesh_mod
    ref_dir = tmp_path_factory.mktemp("ep_ref")
    _run_reference(ref_dir)
    return mesh_mod.spawn(rank_main, 8, str(ref_dir), backend="gloo",
                          device="cpu", timeout=300)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-S{s}" for a, s in CASES])
def test_ep_equals_reference_ep(results, case):
    for rank, r in enumerate(results):
        c = r["cases"][case]
        assert c["err"] < TOL, (rank, c)
        assert c["aux"] == pytest.approx(c["aux_ref"], rel=1e-5), (rank, c)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-S{s}" for a, s in CASES])
def test_ep_equals_single_device_without_drops(results, case):
    for rank, r in enumerate(results):
        assert r["cases"][case]["err16"] < TOL, rank


@pytest.mark.parametrize("case", [i for i, (_, s) in enumerate(CASES)
                                  if s > 1],
                         ids=[f"{a}-S{s}" for a, s in CASES if s > 1])
def test_wrong_return_exchange_fails(results, case):
    worst = max(r["cases"][case]["err_fault"] for r in results)
    assert worst > 100 * TOL, worst


def test_pod_major_batch_shards(results):
    for rank, r in enumerate(results):
        assert r["shard_equal"], rank
    # rank = (pod, data, model) row-major over (2, 2, 2): the batch shard
    # index is pod * 2 + data, rows [2i, 2i + 1] of 0..7.
    for rank, r in enumerate(results):
        i = rank // 2
        assert r["dp_index"] == i
        assert r["shard_rows"] == [4.0 * i, 4.0 * i + 2.0]
        assert r["gathered"] == torch.arange(16.0).reshape(8, 2).tolist()
