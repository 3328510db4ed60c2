"""The mesh helpers and launchers on gloo CPU ranks.

``launch.mesh.spawn`` returns each rank's result in rank order, raises a
rank's exception in the caller, kills ranks that outlive its timeout,
and takes the backend only as the caller names it (``nccl`` refuses CPU
ranks and more ranks than cards; ``cuda`` raises without a card). The
launchers train and serve on a (data 2, model 2) mesh with
``--backend gloo``, and every new module of the distribution slice
imports neither JAX nor the reference.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.launch import mesh as mesh_mod

REPO = Path(__file__).resolve().parents[1]


def _rank_info(tag):
    mesh = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
    return (tag, torch.distributed.get_rank(), mesh.get_coordinate(),
            str(mesh_mod.local_device()))


def _fails_on_rank_one():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.barrier()


def _sleeps():
    time.sleep(120)


def test_spawn_returns_results_in_rank_order():
    out = mesh_mod.spawn(_rank_info, 4, "x", backend="gloo", device="cpu",
                         timeout=120)
    assert [o[1] for o in out] == [0, 1, 2, 3]
    assert [tuple(o[2]) for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {o[0] for o in out} == {"x"} and {o[3] for o in out} == {"cpu"}


def test_spawn_raises_a_ranks_exception():
    with pytest.raises(Exception, match="rank one fails on purpose"):
        mesh_mod.spawn(_fails_on_rank_one, 2, backend="gloo", device="cpu",
                       timeout=120)


def test_spawn_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mesh_mod.spawn(_sleeps, 2, backend="gloo", device="cpu", timeout=8)
    assert time.monotonic() - t0 < 60


def test_backend_is_the_callers_choice():
    with pytest.raises(ValueError, match="CUDA ranks only"):
        mesh_mod.spawn(_sleeps, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="nccl or gloo"):
        mesh_mod.spawn(_sleeps, 2, backend="mpi", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.spawn(_sleeps, 2, backend="gloo", device="cuda")


def test_local_device_outside_spawn_raises():
    with pytest.raises(RuntimeError):
        mesh_mod.local_device()


def test_train_launcher_on_a_mesh(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                      "--steps", "2", "--seq-len", "16", "--data", "2",
                      "--model", "2", "--backend", "gloo"])
    assert out["status"] == "done" and out["cost"]["chips"] == 4
    with pytest.raises(SystemExit):
        train.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                    "--data", "2"])
    assert "needs --backend" in capsys.readouterr().err


def test_serve_launcher_on_a_mesh(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                "--requests", "4", "--max-new-tokens", "3", "--data", "2",
                "--model", "2", "--backend", "gloo"])
    out = capsys.readouterr().out
    assert "4 requests" in out and "'chips': 4" in out


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.sharding.rules, repro_torch.core.shard_map, "
            "repro_torch.launch.mesh, repro_torch.launch.steps, "
            "repro_torch.models.moe, repro_torch.train.grad_compression\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'jaxlib')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
