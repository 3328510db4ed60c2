"""Synthetic TPC-H / TPCx-BB table generators (paper Table 4).

Standard-generator-shaped distributions (uniform keys/dates, no skew — the
paper deliberately uses synthetic data to avoid data and computational
skew), partitioned into columnar objects on the object store. Scale is
expressed in rows so tests run at laptop scale while the benchmark harness
reports the paper's SF1000 sizes analytically.
"""
from __future__ import annotations

import numpy as np

from repro_torch.engine import columnar
from repro_torch.engine.columnar import ColumnBatch
from repro_torch.core.storage_service import ObjectStore

# Days since 1992-01-01; TPC-H dates span 1992-01-01 .. 1998-12-31.
DATE_MIN, DATE_MAX = 0, 2555
DATE_1994_01_01 = 731
DATE_1995_01_01 = 1096


def gen_lineitem(rows: int, seed: int = 0) -> ColumnBatch:
    r = np.random.default_rng(seed)
    orderkey = r.integers(1, max(2, rows // 4), size=rows, dtype=np.int64)
    ship = r.integers(DATE_MIN, DATE_MAX - 122, size=rows, dtype=np.int32)
    commit = ship + r.integers(-30, 61, size=rows, dtype=np.int32)
    receipt = ship + r.integers(1, 31, size=rows, dtype=np.int32)
    return ColumnBatch({
        "l_orderkey": orderkey,
        "l_quantity": r.integers(1, 51, size=rows).astype(np.float64),
        "l_extendedprice": np.round(r.uniform(900.0, 105000.0, rows), 2),
        "l_discount": np.round(r.integers(0, 11, size=rows) * 0.01, 2),
        "l_tax": np.round(r.integers(0, 9, size=rows) * 0.01, 2),
        "l_returnflag": r.integers(0, 3, size=rows, dtype=np.int8),
        "l_linestatus": r.integers(0, 2, size=rows, dtype=np.int8),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipmode": r.integers(0, 7, size=rows, dtype=np.int8),
    })


def gen_orders(rows: int, seed: int = 1) -> ColumnBatch:
    r = np.random.default_rng(seed)
    return ColumnBatch({
        "o_orderkey": np.arange(1, rows + 1, dtype=np.int64),
        "o_orderdate": r.integers(DATE_MIN, DATE_MAX - 151, size=rows,
                                  dtype=np.int32),
        "o_orderpriority": r.integers(0, 5, size=rows, dtype=np.int8),
        "o_totalprice": np.round(r.uniform(850.0, 560000.0, rows), 2),
    })


def gen_clickstreams(rows: int, n_users: int = 0, n_items: int = 0,
                     seed: int = 2) -> ColumnBatch:
    """TPCx-BB web_clickstreams-alike (user, timestamped clicks on items)."""
    r = np.random.default_rng(seed)
    n_users = n_users or max(4, rows // 64)
    n_items = n_items or max(8, rows // 128)
    return ColumnBatch({
        "wcs_user_sk": r.integers(0, n_users, size=rows, dtype=np.int64),
        "wcs_click_date_sk": r.integers(0, 365, size=rows, dtype=np.int32),
        "wcs_click_time_sk": r.integers(0, 86400, size=rows, dtype=np.int32),
        "wcs_item_sk": r.integers(0, n_items, size=rows, dtype=np.int64),
        "wcs_click_type": r.choice(3, size=rows,
                                   p=[0.88, 0.09, 0.03]).astype(np.int8),
    })


def gen_item(n_items: int, seed: int = 3) -> ColumnBatch:
    r = np.random.default_rng(seed)
    return ColumnBatch({
        "i_item_sk": np.arange(n_items, dtype=np.int64),
        "i_category_id": r.integers(0, 10, size=n_items, dtype=np.int8),
    })


TABLES = {
    "lineitem": gen_lineitem,
    "orders": gen_orders,
    "clickstreams": gen_clickstreams,
    "item": gen_item,
}

# Paper Table 4 (SF1000): table -> (GiB, partitions, MiB/partition).
SF1000_LAYOUT = {
    "lineitem": (177.4, 996, 182.4),
    "orders": (44.9, 249, 176.1),
    "clickstreams": (94.9, 1000, 92.7),
    "item": (0.08, 1, 75.8),
}


def load_table(store: ObjectStore, name: str, rows: int, partitions: int,
               seed: int = 0, prefix: str = "tables") -> list[str]:
    """Generate + partition a table into the object store; returns keys."""
    batch = TABLES[name](rows, seed=seed)
    keys = []
    bounds = np.linspace(0, batch.num_rows, partitions + 1).astype(int)
    for p in range(partitions):
        part = ColumnBatch({k: v[bounds[p]:bounds[p + 1]]
                            for k, v in batch.items()})
        key = f"{prefix}/{name}/part-{p:05d}"
        store.put(key, columnar.serialize(part))
        keys.append(key)
    return keys


def load_table_hash_partitioned(store: ObjectStore, name: str, rows: int,
                                partition_key: str, fanout: int,
                                seed: int = 0,
                                prefix: str = "tables") -> list[str]:
    """Generate a table stored HASH-partitioned: object i holds exactly
    the rows with ``partition_key % fanout == i`` — the layout
    ``logical.scan(..., partitioned_by=(key, fanout))`` declares, which
    lets the optimizer elide co-partition and combine shuffles on that
    key entirely."""
    from repro_torch.engine.operators import radix_partition
    batch = TABLES[name](rows, seed=seed)
    keys = []
    for p, part in enumerate(radix_partition(batch, partition_key, fanout)):
        key = f"{prefix}/{name}/hashpart-{p:05d}"
        store.put(key, columnar.serialize(part))
        keys.append(key)
    return keys
