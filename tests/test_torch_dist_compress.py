"""``compressed_psum`` over a real pod axis against the reference, on a
(pod 2, data 2, model 2) mesh of gloo CPU ranks.

The reference runs its ``compressed_psum`` in a subprocess on 8 host
devices and writes its outputs and new error state; the port's 8 ranks
(``launch.mesh.spawn``) reduce the same partials (a leaf as a DTensor
sharded over ``"pod"``, one nested leaf as a tensor every rank holds
whole) and must give both to float32 rounding (2 float32 ulps of the
leaf's largest value: the scale, the product and the division may round
in another order). Then the reference test's checks on the port: the
one-step relative error under 0.02, a nonzero error state, and the
9-step running mean closer than one step's. The gather moves int8: one
byte an element per peer.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SHAPES = {"w": (2, 16, 16), "b": (2, 33)}
F32_ULP = float(np.finfo(np.float32).eps)


def _inputs():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal(SHAPES["w"]).astype(np.float32),
         "b": (3.0 * rng.standard_normal(SHAPES["b"])).astype(np.float32)}
    e = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    return g, e


def _run_reference(out: Path) -> None:
    code = f"""
        import jax, jax.numpy as jnp, numpy as np, sys
        sys.path.insert(0, {str(Path(__file__).parent)!r})
        from test_torch_dist_compress import _inputs
        from repro.train import grad_compression as gc
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        g, e = _inputs()
        g = {{"w": jnp.asarray(g["w"]), "n": {{"b": jnp.asarray(g["b"])}}}}
        e = {{"w": jnp.asarray(e["w"]), "n": {{"b": jnp.asarray(e["b"])}}}}
        o, ne = gc.compressed_psum(g, e, mesh, axis="pod")
        np.savez({str(out)!r}, out_w=np.asarray(o["w"]),
                 out_b=np.asarray(o["n"]["b"]), e_w=np.asarray(ne["w"]),
                 e_b=np.asarray(ne["n"]["b"]))
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def rank_main() -> dict:
    from repro_torch.core import shard_map as sm
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import grad_compression as gc

    mesh = mesh_mod.make_local_mesh(2, 2, pod=2, device_type="cpu")
    g, e = _inputs()
    spec = ("pod", None, None)
    w = torch.from_numpy(g["w"])
    partials = {"w": sm.make_dtensor(sm.local_shard(w, spec, mesh), spec,
                                     mesh, w.shape),
                "n": {"b": torch.from_numpy(g["b"])}}
    errors = {"w": torch.from_numpy(e["w"]),
              "n": {"b": torch.from_numpy(e["b"])}}
    sm.reset_comm()
    out, new_e = gc.compressed_psum(partials, errors, mesh, axis="pod")
    wire = dict(sm.COMM["all_gather"])
    res = {"out_w": out["w"].to_local().numpy(),
           "out_b": out["n"]["b"].to_local().numpy(),
           "e_w": sm.gather_full(new_e["w"].to_local(), spec, mesh).numpy(),
           "e_b": sm.gather_full(new_e["n"]["b"].to_local(), ("pod", None),
                                 mesh).numpy(),
           "wire": wire}
    # The reference test's convergence check, on zero initial errors.
    g1 = {"w": w}
    err = {"w": torch.zeros(SHAPES["w"])}
    o, err = gc.compressed_psum(g1, err, mesh, axis="pod")
    want = g["w"].mean(axis=0)
    got = o["w"].to_local().numpy()
    res["rel"] = float(np.abs(got - want).max() / np.abs(want).max())
    res["err_max"] = float(err["w"].to_local().abs().max())
    acc = got.copy()
    err = {"w": sm.gather_full(err["w"].to_local(), spec, mesh)}
    for _ in range(8):
        o, err = gc.compressed_psum(g1, err, mesh, axis="pod")
        acc = acc + o["w"].to_local().numpy()
        err = {"w": sm.gather_full(err["w"].to_local(), spec, mesh)}
    acc /= 9.0
    res["rel9"] = float(np.abs(acc - want).max() / np.abs(want).max())
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch import mesh as mesh_mod
    ref = tmp_path_factory.mktemp("compress") / "ref.npz"
    _run_reference(ref)
    got = mesh_mod.spawn(rank_main, 8, backend="gloo", device="cpu",
                         timeout=300)
    return np.load(ref), got


@pytest.mark.parametrize("key", ["out_w", "out_b", "e_w", "e_b"])
def test_equals_reference(results, key):
    ref, got = results
    want = ref[key]
    for rank, r in enumerate(got):
        tol = 2 * F32_ULP * float(np.abs(want).max())
        assert np.abs(r[key] - want).max() <= tol, (rank, key)


def test_reference_convergence_checks(results):
    _, got = results
    for r in got:
        assert r["rel"] < 0.02
        assert r["err_max"] > 0
        assert r["rel9"] < r["rel"]


def test_int8_on_the_wire(results):
    _, got = results
    per_peer = int(np.prod(SHAPES["w"][1:]) + np.prod(SHAPES["b"][1:]))
    for r in got:
        # one all-gather a leaf over 2 pod ranks: 1 byte an element.
        assert r["wire"]["calls"] == 2
        assert r["wire"]["bytes"] == per_peer


def test_without_the_axis_returns_partials():
    from repro_torch.train import grad_compression as gc
    g, e = _inputs()
    out, ne = gc.compressed_psum({"w": torch.from_numpy(g["w"])},
                                 {"w": torch.from_numpy(e["w"])}, None)
    assert torch.equal(out["w"], torch.from_numpy(g["w"][0]))
    assert ne["w"] is not None
