"""Meshes and the processes behind them (the counterpart of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.DeviceMesh`` whose dims carry the
reference's axis names (``"pod"``, ``"data"``, ``"model"``), built over a
process group that is already initialised, one process a rank. Defined
as functions, so importing this module touches no process group.

``spawn`` starts the ranks of a mesh on this host: ``world`` processes
(start method ``spawn``) that meet through a ``FileStore`` in a
temporary directory (no network), each with its process group and
compute device set up, before it calls the given function. The backend
is the caller's choice and nothing else picks it:

  * ``"nccl"`` needs a card of its own for every rank, and raises
    otherwise;
  * ``"gloo"`` runs CPU ranks, and several ranks on one card (NCCL
    refuses two ranks on one device): compute stays on the card, and
    gloo moves the collectives' bytes through host memory, or, with
    ``transport="cuda_ipc"``, the ranks' device mailboxes do
    (``core.shard_map.open_mailboxes``; gloo then carries barriers and
    small host objects only).

``fake_world`` is the compile-only dry run's world: this process as
rank 0 of ``world`` ranks on PyTorch's fake backend, whose collectives
move nothing, so ``make_production_mesh`` builds the 16x16 and 2x16x16
meshes in one process (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import shard_map as sm
from repro_torch.core.device import resolve_device

_LOCAL: dict = {"device": None}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 pod mesh (data, model); 2x16x16 with a 'pod' axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of ``world`` ranks on the fake backend
    (``torch.testing._internal.distributed.fake_pg``): every collective
    returns at once and moves no bytes. The group is destroyed on exit,
    so another world may follow in the same process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                    device_type: str = "cuda"):
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over the
    ranks of the initialised process group (their count must be the
    product of the sizes)."""
    if pod:
        return init_device_mesh(device_type, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def local_device() -> torch.device:
    """The device this rank computes on (set up by ``spawn``)."""
    if _LOCAL["device"] is None:
        raise RuntimeError("no rank device: call inside mesh.spawn")
    return _LOCAL["device"]


def _check_backend(backend: str, world: int, device,
                   transport) -> torch.device:
    device = resolve_device(device)
    if transport not in (None, "cuda_ipc"):
        raise ValueError(f"transport {transport!r}: None or 'cuda_ipc'")
    if transport == "cuda_ipc" and (backend != "gloo"
                                    or device.type != "cuda"):
        raise ValueError("the cuda_ipc transport serves gloo ranks on one "
                         "card")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs CUDA ranks only")
        n = torch.cuda.device_count()
        if n < world:
            raise ValueError(f"nccl needs a card for each of the {world} "
                             f"ranks; this host has {n}: use gloo")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return device


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device_type: str, transport, store_dir: str,
               args: tuple) -> None:
    if device_type == "cuda":
        # nccl: one card a rank; gloo: every rank on the first card.
        index = rank if backend == "nccl" else 0
        torch.cuda.set_device(index)
        _LOCAL["device"] = torch.device("cuda", index)
    else:
        _LOCAL["device"] = torch.device("cpu")
        # CPU ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=rank, world_size=world)
    try:
        if transport == "cuda_ipc":
            sm.open_mailboxes(_LOCAL["device"])
        try:
            out = fn(*args)
        except BaseException:
            # When one rank fails its peers fail too (their collectives
            # lose it): the first failure in time is the cause.
            with open(os.path.join(store_dir, f"error-{rank}.txt"),
                      "w") as f:
                f.write(f"{time.time()!r}\n{traceback.format_exc()}")
            raise
        with open(os.path.join(store_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        sm.close_mailboxes()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _join(ctx, deadline: float, store_dir: str) -> bool:
    """``ctx.join`` until ``deadline``; a rank's failure is raised as the
    first rank's failure in time."""
    try:
        return ctx.join(timeout=max(deadline - time.monotonic(), 0.0))
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        errors = []
        for name in os.listdir(store_dir):
            if name.startswith("error-"):
                with open(os.path.join(store_dir, name)) as f:
                    when, _, text = f.read().partition("\n")
                errors.append((float(when), name[6:-4], text))
        if not errors:
            raise
        when, rank, text = min(errors)
        raise RuntimeError(f"rank {rank} failed first:\n{text}") from exc


def spawn(fn: Callable, world: int, *args, backend: str, device="cuda",
          timeout: float = 600.0, transport=None) -> list:
    """Run ``fn(*args)`` on ``world`` ranks; returns each rank's result,
    in rank order (results travel by pickle). Any rank's exception is
    raised here; ranks still running after ``timeout`` seconds are
    killed and ``TimeoutError`` raised. ``fn`` must be importable by name
    (a module-level function). ``transport="cuda_ipc"`` (gloo ranks on
    one card only) moves the collectives' payloads through device
    mailboxes."""
    device = _check_backend(backend, world, device, transport)
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, device.type, transport,
                              store_dir, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not _join(ctx, deadline, store_dir):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
        out = []
        for rank in range(world):
            with open(os.path.join(store_dir, f"result-{rank}.pkl"),
                      "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
