"""Spill-to-disk substrate for out-of-core fragment execution.

When an operator's ``core.memory.OperatorGrant`` refuses a reservation,
buffered batches move to *spill files*: append-only local files holding
zero-copy ``columnar`` frames. Read-back memory-maps the file and hands
``columnar.deserialize_frame`` the mapped buffer, so spilled columns come
back as ``np.frombuffer`` views over OS-paged memory — only the columns
(and pages) an operator touches are ever resident, which is exactly the
column-sliced cheap-re-read property the frame format was built for.

Spill files are unlinked the moment they are opened (Linux keeps the
inode alive while the mapping exists), so worker crashes leak nothing.

``SPILL_STATS`` is the process-global spy the differential spill-parity
tests and the ``out_of_core`` bench section read: tests assert
``spill_bytes > 0`` and ``spill_rounds >= 2`` under a forcing budget, and
the bench records spilled volume next to rows/s.
"""
from __future__ import annotations

import mmap
import os
import tempfile
from typing import Iterable, Optional

from repro_torch.core.memory import OperatorGrant
from repro_torch.engine import columnar
from repro_torch.engine.columnar import ColumnBatch

# Process-global observability: reset per run, read by tests/bench.
SPILL_STATS = {
    "spill_bytes": 0,        # frame bytes written to spill files
    "spill_chunks": 0,       # batches moved to disk
    "spill_rounds": 0,       # accumulator flush events (buffer -> disk)
    "spilled_builds": 0,     # hash-join build sides demoted to mmap frames
    "readback_bytes": 0,     # frame bytes mapped back for consumption
}


def reset_stats() -> None:
    for k in SPILL_STATS:
        SPILL_STATS[k] = 0


class SpillFile:
    """Append-only file of ``columnar`` frames with mmap read-back."""

    def __init__(self, prefix: str = "repro-spill-"):
        fd, path = tempfile.mkstemp(prefix=prefix, suffix=".frames")
        self._fd = fd
        os.unlink(path)              # anonymous: gone when fd/mmap die
        self._size = 0
        self._mm: Optional[mmap.mmap] = None

    def append(self, batch: ColumnBatch) -> tuple[int, int]:
        """Serialize ``batch`` as one frame at the tail; returns
        ``(offset, length)`` for later ``read``."""
        if self._mm is not None:
            raise RuntimeError("spill file is frozen for reading")
        data = columnar.serialize_frame(batch)
        offset = self._size
        os.pwrite(self._fd, data, offset)
        self._size += len(data)
        SPILL_STATS["spill_bytes"] += len(data)
        SPILL_STATS["spill_chunks"] += 1
        return offset, len(data)

    def _map(self) -> memoryview:
        if self._mm is None:
            self._mm = mmap.mmap(self._fd, self._size,
                                 access=mmap.ACCESS_READ)
        return memoryview(self._mm)

    def read(self, offset: int, length: int,
             columns: Optional[Iterable[str]] = None) -> ColumnBatch:
        """Zero-copy view of one spilled frame: columns are
        ``np.frombuffer`` over the mapping, paged in on access."""
        SPILL_STATS["readback_bytes"] += length
        return columnar.deserialize_frame(
            self._map()[offset:offset + length], columns)

    @property
    def nbytes(self) -> int:
        return self._size


def spill_build(batch: ColumnBatch) -> ColumnBatch:
    """Demote a hash-join build side to a spilled frame: the returned
    batch has the same columns/rows but every array is a zero-copy view
    over a memory-mapped frame file — file-backed, reclaimable pages
    instead of anonymous heap, which is what the join grant refused."""
    sf = SpillFile(prefix="repro-spill-build-")
    off, length = sf.append(batch)
    SPILL_STATS["spilled_builds"] += 1
    # The arrays keep the mmap (and file) alive via their .base chain.
    return sf.read(off, length)


class BatchAccumulator:
    """Order-preserving accumulator of morsel outputs under a grant.

    ``add`` reserves each batch's bytes; when the grant refuses, every
    buffered batch (and the incoming one) moves to the spill file — one
    *spill round* — and the reservations are released. ``finalize``
    concatenates all chunks in arrival order, mixing live and mapped
    arrays, reserving the output size (``force=True``: a barrier
    consumer needs the whole thing)."""

    def __init__(self, grant: OperatorGrant):
        self.grant = grant
        # Entries in arrival order: ("mem", batch) | ("disk", off, len).
        self._entries: list[tuple] = []
        self._file: Optional[SpillFile] = None
        self._mem_bytes = 0
        self.rows = 0

    def _spill_round(self) -> None:
        if self._file is None:
            self._file = SpillFile()
        for i, entry in enumerate(self._entries):
            if entry[0] == "mem":
                off, length = self._file.append(entry[1])
                self._entries[i] = ("disk", off, length)
        if self._mem_bytes:
            self.grant.release(self._mem_bytes)
            self._mem_bytes = 0
        SPILL_STATS["spill_rounds"] += 1

    def add(self, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        self.rows += batch.num_rows
        n = batch.nbytes()
        if self.grant.try_reserve(n):
            self._entries.append(("mem", batch))
            self._mem_bytes += n
            return
        self._spill_round()
        if self.grant.try_reserve(n):    # freed headroom fits the morsel
            self._entries.append(("mem", batch))
            self._mem_bytes += n
        else:                            # morsel alone exceeds the grant
            off, length = self._file.append(batch)
            self._entries.append(("disk", off, length))

    def _chunks(self) -> list[ColumnBatch]:
        out = []
        for entry in self._entries:
            if entry[0] == "mem":
                out.append(entry[1])
            else:
                out.append(self._file.read(entry[1], entry[2]))
        return out

    def finalize(self) -> ColumnBatch:
        chunks = self._chunks()
        had_disk = any(e[0] == "disk" for e in self._entries)
        self._entries = []
        batch = ColumnBatch.concat(chunks)
        if len(chunks) > 1 or had_disk:
            # Charge the materialized concat (force: a barrier consumer
            # needs it whole); buffered chunk reservations are released —
            # their arrays die with the entry list.
            if self._mem_bytes:
                self.grant.release(self._mem_bytes)
                self._mem_bytes = 0
            self.grant.reserve(batch.nbytes(), force=True)
        return batch


class PartitionAccumulator:
    """Per-partition chunked emission buffer for spill-aware shuffles.

    Each morsel's partition slices are appended under their partition id;
    over-grant buffers spill whole (one round covers every partition's
    buffered chunks — radix spill is all-or-nothing per round, keeping
    the round count meaningful). ``take(p)`` concatenates partition
    ``p``'s chunks in arrival order, so the shuffle object is
    bit-identical to the single-shot partitioner's output."""

    def __init__(self, partitions: int, grant: OperatorGrant):
        self.partitions = partitions
        self.grant = grant
        self._entries: list[list[tuple]] = [[] for _ in range(partitions)]
        self._file: Optional[SpillFile] = None
        self._mem_bytes = 0

    def _spill_round(self) -> None:
        if self._file is None:
            self._file = SpillFile()
        for plist in self._entries:
            for i, entry in enumerate(plist):
                if entry[0] == "mem":
                    off, length = self._file.append(entry[1])
                    plist[i] = ("disk", off, length)
        if self._mem_bytes:
            self.grant.release(self._mem_bytes)
            self._mem_bytes = 0
        SPILL_STATS["spill_rounds"] += 1

    def add(self, part: int, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        n = batch.nbytes()
        if self.grant.try_reserve(n):
            self._entries[part].append(("mem", batch))
            self._mem_bytes += n
            return
        self._spill_round()
        if self.grant.try_reserve(n):
            self._entries[part].append(("mem", batch))
            self._mem_bytes += n
        else:
            off, length = self._file.append(batch)
            self._entries[part].append(("disk", off, length))

    def take(self, part: int) -> ColumnBatch:
        """Materialize one partition (chunks in arrival order) and drop
        its buffers. Peak extra memory is one partition's output — the
        chunked-emission contract the worker's accounting asserts."""
        chunks = []
        for entry in self._entries[part]:
            if entry[0] == "mem":
                chunks.append(entry[1])
                self._mem_bytes -= entry[1].nbytes()
                self.grant.release(entry[1].nbytes())
            else:
                chunks.append(self._file.read(entry[1], entry[2]))
        self._entries[part] = []
        batch = ColumnBatch.concat(chunks)
        return batch
