"""Training data pipeline: sharded synthetic token streams with
burst-aware prefetch planning.

The pipeline models the paper's data-access discipline: batches are fetched
from object storage in chunks sized by the network burst budget
(``core.token_bucket.plan_transfer`` — Fig 14 applied to training input),
and the shuffle planner decides reader parallelism against partition IOPS.
Generation is deterministic per (seed, shard, step) so elastic restarts
replay the exact stream from any step — a fault-tolerance requirement.

A copy of ``repro.data.pipeline`` with its imports retargeted: numpy
only, so the batches are byte-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core import token_bucket
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    vocab_size: int = 32000


class TokenPipeline:
    """Deterministic synthetic LM batches (tokens + next-token labels)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.shard)
        toks = rng.integers(0, self.cfg.vocab_size,
                            (self.local_batch, self.cfg.seq_len + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def bytes_per_batch(self) -> int:
        return self.local_batch * (self.cfg.seq_len + 1) * 4

    def prefetch_plan(self, workers: Optional[int] = None) -> dict:
        """Burst-aware fetch plan for one global batch from object storage
        (paper Fig 14: keep each loader inside its burst budget)."""
        total = self.bytes_per_batch() * self.num_shards
        workers = workers or self.num_shards
        return token_bucket.plan_transfer(total, workers)


def embeddings_batch(cfg: ArchConfig, batch: int, seq: int,
                     step: int, seed: int = 0) -> dict:
    """Modality-stub batches: precomputed frame/patch embeddings (audio /
    vlm archs) + labels; vlm adds 3-stream M-RoPE positions."""
    rng = np.random.default_rng(seed * 7919 + step)
    out = {
        "embeds": rng.standard_normal((batch, seq, cfg.d_model),
                                      dtype=np.float32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq),
                               dtype=np.int32),
    }
    if cfg.rope == "mrope":
        t = np.arange(seq, dtype=np.int32)
        out["mrope_positions"] = np.broadcast_to(t[None, None],
                                                 (3, batch, seq)).copy()
    return out


def pack_sequences(docs: list[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Greedy sequence packing: concatenate docs into fixed-length rows,
    returning (tokens (N, seq_len), segment_ids) — padding-free batching."""
    rows, segs = [], []
    cur = np.full(seq_len, pad_id, dtype=np.int32)
    seg = np.zeros(seq_len, dtype=np.int32)
    pos, seg_id = 0, 1
    for doc in docs:
        d = np.asarray(doc, dtype=np.int32)
        while len(d):
            space = seq_len - pos
            take = min(space, len(d))
            cur[pos:pos + take] = d[:take]
            seg[pos:pos + take] = seg_id
            pos += take
            d = d[take:]
            if pos == seq_len:
                rows.append(cur)
                segs.append(seg)
                cur = np.full(seq_len, pad_id, dtype=np.int32)
                seg = np.zeros(seq_len, dtype=np.int32)
                pos = 0
        seg_id += 1
    if pos:
        rows.append(cur)
        segs.append(seg)
    return np.stack(rows), np.stack(segs)
