"""Object-store checkpointing with elastic restore (the port of
``repro.checkpoint.object_store_ckpt``).

Compute is stateless; all durable training state lives in the object
store. Checkpoints are:

  * chunked into objects at or above the shuffle break-even access size
    (``core.breakeven.beas``: requests are priced per object, so small
    objects are uneconomical; huge objects forfeit parallel restore),
  * written leaves-first, manifest-last (atomic commit: a checkpoint
    without a manifest is invisible),
  * restored onto any device: leaves are saved whole, so a restart may
    change the device or the dtype it restores onto.

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
from torch import nn

from repro_torch.core import breakeven
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


def save_checkpoint(store: ObjectStore, prefix: str, step: int, tree,
                    keep: int = 3) -> str:
    """Write ``tree`` under ``prefix/step-N``; returns the manifest key."""
    base = f"{prefix}/step-{step:08d}"
    chunk = _chunk_bytes()
    manifest: dict[str, Any] = {"step": step, "leaves": []}
    for name, leaf in _leaf_paths(tree):
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
    # Manifest last: commit point.
    store.put(f"{base}/MANIFEST.json", json.dumps(manifest).encode())
    _gc(store, prefix, keep)
    return f"{base}/MANIFEST.json"


def latest_step(store: ObjectStore, prefix: str) -> Optional[int]:
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
            p.data = next(leaves)
        return like
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def restore_checkpoint(store: ObjectStore, prefix: str, like_tree,
                       step: Optional[int] = None, device=None):
    """Rebuild ``like_tree``'s structure from storage; returns (tree,
    step). Each leaf comes back in its ``like_tree`` leaf's dtype, on
    ``device`` (default: where that leaf lies): the elastic restore
    target. A ``Model`` in ``like_tree`` gets the restored tensors as
    its parameters."""
    if step is None:
        step = latest_step(store, prefix)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {prefix}")
    base = f"{prefix}/step-{step:08d}"
    manifest = json.loads(store.get(f"{base}/MANIFEST.json").decode())
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    restored = []
    for name, like in _leaf_paths(like_tree):
        meta = by_name[name]
        buf = b"".join(store.retrying_get(k) for k in meta["chunks"])
        t = _from_bytes(buf, meta["dtype"], meta["shape"])
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
