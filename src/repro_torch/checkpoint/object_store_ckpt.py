"""Object-store checkpointing with elastic restore (the port of
``repro.checkpoint.object_store_ckpt``).

Compute is stateless; all durable training state lives in the object
store. Checkpoints are:

  * chunked into objects at or above the shuffle break-even access size
    (``core.breakeven.beas``: requests are priced per object, so small
    objects are uneconomical; huge objects forfeit parallel restore),
  * written leaves-first, manifest-last (atomic commit: a checkpoint
    without a manifest is invisible),
  * restored onto any device or mesh: leaves are saved whole
    (unsharded), so a restart may change the device, the mesh or the
    dtype it restores onto (elastic restore).

On a mesh (DTensor leaves) saving is collective: every rank gathers each
leaf whole, rank 0 writes it to its store, and the others wait at a
barrier. Restoring is collective too: rank 0 reads each leaf and
broadcasts its bytes, and every rank keeps its shard by the layout of
its like-tree leaf. Only rank 0's store is read or written.

A tree is a ``Model`` (leaves named by ``named_parameters()``), an
``OptState`` or another named tuple (by field), a dict (by key) or a
list, nested, with tensors or numpy arrays as leaves; nested names join
with ``/``. bfloat16 leaves are written as their raw 16-bit payload with
dtype ``"bfloat16"`` in the manifest, so neither side needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core import breakeven
from repro_torch.core import shard_map as sm
from repro_torch.core.storage_service import ObjectStore

MIB = 1024 ** 2


def _chunk_bytes() -> int:
    b = breakeven.beas("c6g.xlarge")
    return max(int(b or 4 * MIB), 4 * MIB)


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs in the tree's order."""
    if isinstance(tree, nn.Module):
        items = list(tree.named_parameters())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree, nn.Module):
            out.append((name, sub))
        else:
            out += _leaf_paths(sub, name)
    return out


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """The leaf's bytes as a host array, and its manifest dtype."""
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_bytes(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).reshape(
            shape)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype))
    return torch.from_numpy(arr.copy()).reshape(shape)


def _mesh_of(leaves) -> Any:
    for _, leaf in leaves:
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _whole(leaf):
    """A leaf's whole value (a DTensor gathered: a collective)."""
    if isinstance(leaf, DTensor):
        return sm.gather_full(leaf.to_local().detach(), sm.spec_of(leaf),
                              leaf.device_mesh)
    return leaf


def save_checkpoint(store: ObjectStore, prefix: str, step: int, tree,
                    keep: int = 3) -> str:
    """Write ``tree`` under ``prefix/step-N``; returns the manifest key.
    With DTensor leaves every rank calls it, and rank 0 writes."""
    base = f"{prefix}/step-{step:08d}"
    leaves = _leaf_paths(tree)
    mesh = _mesh_of(leaves)
    writer = mesh is None or dist.get_rank() == 0
    chunk = _chunk_bytes()
    manifest: dict[str, Any] = {"step": step, "leaves": []}
    for name, leaf in leaves:
        leaf = _whole(leaf)
        if not writer:
            continue
        arr, dtype = _host_array(leaf)
        buf = memoryview(arr.reshape(-1).view(np.uint8))
        n_chunks = max(1, math.ceil(len(buf) / chunk))
        keys = []
        for c in range(n_chunks):
            key = f"{base}/{name}/chunk-{c:04d}"
            store.put(key, bytes(buf[c * chunk:(c + 1) * chunk]))
            keys.append(key)
        manifest["leaves"].append({
            "name": name, "shape": list(arr.shape), "dtype": dtype,
            "chunks": keys, "bytes": len(buf),
        })
    if writer:
        # Manifest last: commit point.
        store.put(f"{base}/MANIFEST.json", json.dumps(manifest).encode())
        _gc(store, prefix, keep)
    if mesh is not None:
        dist.barrier()
    return f"{base}/MANIFEST.json"


def _bcast_object(obj, mesh):
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def latest_step(store: ObjectStore, prefix: str,
                mesh=None) -> Optional[int]:
    """The newest committed step; with ``mesh``, rank 0's answer on every
    rank."""
    if mesh is not None:
        found = latest_step(store, prefix) if dist.get_rank() == 0 \
            else None
        return _bcast_object(found, mesh)
    steps = []
    for key in store.list(prefix + "/"):
        if key.endswith("/MANIFEST.json"):
            part = key[len(prefix) + 1:].split("/")[0]
            if part.startswith("step-"):
                steps.append(int(part[5:]))
    return max(steps) if steps else None


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``; a module's parameters are replaced in place."""
    if isinstance(like, nn.Module):
        for _, p in like.named_parameters():
            t = next(leaves)
            if isinstance(p, DTensor):
                # ``p.data = t`` would leave a DTensor's shard as it was.
                with torch.no_grad():
                    p.to_local().copy_(t.to_local())
            else:
                p.data = t
        return like
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _read_leaf(store, meta, mesh) -> torch.Tensor:
    """A saved leaf, whole; under a mesh read by rank 0 and broadcast (on
    the rank's card for NCCL and for ranks that share a card through
    device mailboxes, on the host for other gloo ranks)."""
    if mesh is None:
        buf = b"".join(store.retrying_get(k) for k in meta["chunks"])
        return _from_bytes(buf, meta["dtype"], meta["shape"])
    on_card = dist.get_backend() == "nccl" or sm.mailboxes_open()
    wire = torch.device("cuda", torch.cuda.current_device()) if on_card \
        else torch.device("cpu")
    raw = torch.empty(meta["bytes"], dtype=torch.uint8, device=wire)
    if dist.get_rank() == 0:
        buf = b"".join(store.retrying_get(k) for k in meta["chunks"])
        raw.copy_(torch.frombuffer(bytearray(buf), dtype=torch.uint8))
    sm.broadcast(raw, src=0)
    return _from_bytes(raw.cpu().numpy().tobytes(), meta["dtype"],
                       meta["shape"])


def restore_checkpoint(store: ObjectStore, prefix: str, like_tree,
                       step: Optional[int] = None, device=None, mesh=None):
    """Rebuild ``like_tree``'s structure from storage; returns (tree,
    step). Each leaf comes back in its ``like_tree`` leaf's dtype, on
    ``device`` (default: where that leaf lies): the elastic restore
    target. A ``Model`` in ``like_tree`` gets the restored tensors as
    its parameters. With ``mesh`` every rank calls it: a DTensor leaf of
    ``like_tree`` (placed by the rules on this mesh) comes back as this
    rank's shard in its layout, any other leaf whole."""
    if step is None:
        step = latest_step(store, prefix, mesh)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {prefix}")
    base = f"{prefix}/step-{step:08d}"
    manifest = None
    if mesh is None or dist.get_rank() == 0:
        manifest = json.loads(store.get(f"{base}/MANIFEST.json").decode())
    manifest = _bcast_object(manifest, mesh)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    restored = []
    for name, like in _leaf_paths(like_tree):
        t = _read_leaf(store, by_name[name], mesh)
        if isinstance(like, DTensor):
            spec = sm.spec_of(like)
            local = sm.local_shard(t, spec, like.device_mesh).to(
                device=device if device is not None else like.device,
                dtype=like.dtype).contiguous()
            restored.append(sm.make_dtensor(local, spec, like.device_mesh,
                                            t.shape))
            continue
        like = torch.as_tensor(like)
        restored.append(t.to(device=device if device is not None
                             else like.device, dtype=like.dtype))
    return _rebuild(like_tree, iter(restored)), step


def _gc(store: ObjectStore, prefix: str, keep: int) -> None:
    steps = sorted({int(k[len(prefix) + 1:].split("/")[0][5:])
                    for k in store.list(prefix + "/")
                    if "/step-" in "/" + k[len(prefix):]})
    for s in steps[:-keep] if keep else []:
        for key in store.list(f"{prefix}/step-{s:08d}/"):
            store.delete(key)


def checkpoint_cost(store: ObjectStore) -> dict:
    """Request/storage cost of checkpoint traffic so far (paper pricing)."""
    from repro_torch.core import pricing
    stats = store.stats
    return {
        "writes": stats.writes,
        "write_cost_usd": pricing.storage_request_cost(
            pricing.S3_STANDARD, 0, stats.writes, 0, stats.write_bytes),
        "storage_gib": store.total_bytes() / 1024 ** 3,
    }
