"""Columnar batches and (de)serialization for the query engine.

A ``ColumnBatch`` is a dict of equally sized numpy 1-D arrays. Batches are
stored as single objects in the object store (the Parquet analog: columnar,
one partition per object, with a lightweight header usable for projection
pushdown — only requested columns are materialized from the buffer).
String-typed TPC columns are dictionary-encoded to small ints with the
dictionaries kept in ``DICTIONARIES`` (vectorized execution stays numeric).

Two on-the-wire formats coexist:

* npz (``serialize``/zlib) — the ZSTD-Parquet stand-in for *base tables*,
  where storage cost matters more than encode speed.
* ``FRAME_MAGIC`` frames (``serialize_frame``) — a zero-copy format for
  *shuffle intermediates*: a JSON header plus raw little-endian column
  buffers. Decoding a column is a single ``np.frombuffer`` view into the
  payload; projection pushdown skips unrequested buffers without touching
  them. Per-column zlib compression is available behind a flag for
  network-bound deployments.

``deserialize`` sniffs the magic and accepts either format.
"""
from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Iterable, Optional

import numpy as np


class ColumnBatch(dict):
    """dict[str, np.ndarray] with row-count invariants and helpers."""

    def __init__(self, columns: dict[str, np.ndarray]):
        super().__init__()
        n = None
        for k, v in columns.items():
            v = np.asarray(v)
            if n is None:
                n = len(v)
            if len(v) != n:
                raise ValueError(f"column {k}: {len(v)} rows != {n}")
            self[k] = v
        self._rows = n or 0

    @property
    def num_rows(self) -> int:
        return self._rows

    def select(self, mask: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({k: v[mask] for k, v in self.items()})

    def project(self, names: Iterable[str]) -> "ColumnBatch":
        names = list(names)
        return ColumnBatch({k: self[k] for k in names})

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.values()))

    @staticmethod
    def concat(batches: list["ColumnBatch"]) -> "ColumnBatch":
        batches = [b for b in batches if b.num_rows]
        if not batches:
            return ColumnBatch({})
        if len(batches) == 1:          # fast path: no copy for a lone batch
            return batches[0]
        keys = batches[0].keys()
        return ColumnBatch(
            {k: np.concatenate([b[k] for b in batches]) for k in keys})


def serialize(batch: ColumnBatch, columns: Optional[Iterable[str]] = None
              ) -> bytes:
    """npz-framed columnar object (compressed; the ZSTD-Parquet stand-in)."""
    buf = io.BytesIO()
    cols = batch if columns is None else batch.project(columns)
    np.savez_compressed(buf, **{k: np.asarray(v) for k, v in cols.items()})
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Zero-copy frame format (shuffle intermediates)
# ---------------------------------------------------------------------------
#
# Layout:  magic(4) | flags(1) | header_len(u32 LE) | header JSON | pad |
#          column buffers (each 16-byte aligned, concatenated in order)
# Header:  {"cols": [[name, dtype_str, offset, stored_nbytes, raw_nbytes],
#           ...], "rows": n}
# flags bit 0: per-column zlib compression (offsets then index compressed
# buffers; decoding a projection only decompresses the requested columns).

FRAME_MAGIC = b"CF01"
_FRAME_ALIGN = 16
FLAG_COMPRESSED = 1


def _align(n: int) -> int:
    return (n + _FRAME_ALIGN - 1) // _FRAME_ALIGN * _FRAME_ALIGN


def serialize_frame(batch: ColumnBatch,
                    columns: Optional[Iterable[str]] = None,
                    compress: bool = False) -> bytes:
    cols = batch if columns is None else batch.project(columns)
    payloads = []
    meta = []
    offset = 0
    for name, arr in cols.items():
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        stored = zlib.compress(raw, 1) if compress else raw
        meta.append([name, arr.dtype.str, offset, len(stored), len(raw)])
        pad = _align(len(stored)) - len(stored)
        payloads.append(stored)
        if pad:
            payloads.append(b"\x00" * pad)
        offset += _align(len(stored))
    header = json.dumps({"cols": meta, "rows": cols.num_rows}).encode()
    flags = FLAG_COMPRESSED if compress else 0
    prefix = FRAME_MAGIC + struct.pack("<BI", flags, len(header)) + header
    prefix += b"\x00" * (_align(len(prefix)) - len(prefix))
    return prefix + b"".join(payloads)


def deserialize_frame(data: bytes,
                      columns: Optional[Iterable[str]] = None) -> ColumnBatch:
    """Decode a frame; unrequested column buffers are never touched. Without
    compression each column is a zero-copy ``np.frombuffer`` view.

    ``data`` may be any buffer-protocol object — in particular a
    ``memoryview`` over an mmap'd spill file (``engine.spill``), in which
    case the views are file-backed and page in on first access."""
    if bytes(data[:4]) != FRAME_MAGIC:
        raise ValueError("not a columnar frame")
    flags, header_len = struct.unpack_from("<BI", data, 4)
    header_end = 4 + 5 + header_len
    header = json.loads(bytes(data[9:header_end]))
    base = _align(header_end)
    compressed = flags & FLAG_COMPRESSED
    columns = None if columns is None else list(columns)
    want = None if columns is None else set(columns)
    out = {}
    for name, dtype_str, offset, stored, raw in header["cols"]:
        if want is not None and name not in want:
            continue
        dtype = np.dtype(dtype_str)
        if compressed:
            buf = zlib.decompress(data[base + offset:base + offset + stored])
        else:
            buf = data
        count = raw // dtype.itemsize if dtype.itemsize else 0
        out[name] = np.frombuffer(buf, dtype=dtype, count=count,
                                  offset=0 if compressed else base + offset)
    if want is not None:   # preserve requested order; missing name -> KeyError
        out = {k: out[k] for k in columns}
    return ColumnBatch(out)


def schema_widths(data: bytes) -> dict[str, int]:
    """Per-column dtype widths (bytes/value) of a serialized object,
    WITHOUT decoding any column data. Frames read the JSON header only;
    npz objects read each member's .npy header (the first block of the
    zip entry) — the planner uses this to scale size estimates by real
    column widths instead of a flat column count."""
    if data[:4] == FRAME_MAGIC:
        _, header_len = struct.unpack_from("<BI", data, 4)
        header = json.loads(data[9:4 + 5 + header_len])
        return {name: np.dtype(dtype_str).itemsize
                for name, dtype_str, *_ in header["cols"]}
    import zipfile
    header_readers = {(1, 0): np.lib.format.read_array_header_1_0,
                      (2, 0): np.lib.format.read_array_header_2_0}
    out: dict[str, int] = {}
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for info in zf.infolist():
            name = info.filename
            if not name.endswith(".npy"):
                continue
            with zf.open(info) as f:
                version = np.lib.format.read_magic(f)
                reader = header_readers.get(version)
                if reader is None:   # unknown .npy format revision
                    continue
                _shape, _fortran, dtype = reader(f)
            out[name[:-4]] = dtype.itemsize
    return out


def deserialize(data: bytes, columns: Optional[Iterable[str]] = None
                ) -> ColumnBatch:
    """Projection pushdown: only requested columns are materialized.
    Accepts both npz table objects and zero-copy shuffle frames."""
    if data[:4] == FRAME_MAGIC:
        return deserialize_frame(data, columns)
    with np.load(io.BytesIO(data)) as z:
        names = list(z.files if columns is None else columns)
        return ColumnBatch({k: z[k] for k in names})


# Dictionary encodings for TPC string columns (kept numeric in batches).
DICTIONARIES: dict[str, list[str]] = {
    "l_returnflag": ["A", "N", "R"],
    "l_linestatus": ["F", "O"],
    "l_shipmode": ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"],
    "o_orderpriority": ["1-URGENT", "2-HIGH", "3-MEDIUM",
                        "4-NOT SPECIFIED", "5-LOW"],
    "wcs_click_type": ["view", "cart", "purchase"],
}


def decode(name: str, codes: np.ndarray) -> list[str]:
    d = np.asarray(DICTIONARIES[name])
    return d[np.asarray(codes, dtype=np.int64)].tolist()
