"""The paper's query suite: TPC-H Q1, Q6, Q12 and TPCx-BB Q3 (§3.1).

I/O-heavy queries chosen by the paper to expose resource behaviour: Q1/Q6
select-project-aggregate, Q12 and Q3 join with broad operator sets
including UDFs. Each query is authored on the logical builder
(``engine.logical``) and lowered through the optimizer
(``engine.optimizer``) into the physical plan the coordinator schedules:
``qX_logical`` returns the declarative ``LogicalQuery``; ``qX_plan``
lowers it (projection pruning, predicate pushdown, partial/final
aggregate split, build-side + fan-out selection) for callers that want
the physical ``QueryPlan`` directly. Pure-numpy reference
implementations ride along for correctness tests; the pre-logical
hand-built plans live on as golden parity fixtures in
``tests/golden_plans.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.engine import datagen, optimizer
from repro_torch.engine.columnar import ColumnBatch
from repro_torch.engine.logical import LogicalQuery, col, count_, scan, sum_
from repro_torch.engine.plans import QueryPlan

# dictionary codes (columnar.DICTIONARIES)
MAIL, SHIP = 2, 5
URGENT, HIGH = 0, 1
VIEW, PURCHASE = 0, 2


# ---------------------------------------------------------------------------
# TPC-H Q6 — scan-heavy filter + global aggregate
# ---------------------------------------------------------------------------

def q6_logical(shipdate_lo: int = datagen.DATE_1994_01_01,
               discount: float = 0.06,
               quantity: float = 24.0) -> LogicalQuery:
    return (
        scan("lineitem")
        .filter((col("l_shipdate") >= shipdate_lo)
                & (col("l_shipdate") < shipdate_lo + 365)
                & col("l_discount").between(round(discount - 0.01, 2),
                                            round(discount + 0.01, 2))
                & (col("l_quantity") < quantity))
        .select((col("l_extendedprice") * col("l_discount"))
                .alias("revenue"))
        .agg(sum_("revenue").alias("revenue"))
        .collect("tpch_q6"))


def q6_plan(shipdate_lo: int = datagen.DATE_1994_01_01,
            discount: float = 0.06, quantity: float = 24.0) -> QueryPlan:
    return optimizer.plan(q6_logical(shipdate_lo, discount, quantity))


def q6_reference(lineitem: ColumnBatch,
                 shipdate_lo: int = datagen.DATE_1994_01_01,
                 discount: float = 0.06, quantity: float = 24.0) -> float:
    m = ((lineitem["l_shipdate"] >= shipdate_lo)
         & (lineitem["l_shipdate"] < shipdate_lo + 365)
         & (lineitem["l_discount"] >= round(discount - 0.01, 2))
         & (lineitem["l_discount"] <= round(discount + 0.01, 2))
         & (lineitem["l_quantity"] < quantity))
    return float(np.sum(lineitem["l_extendedprice"][m]
                        * lineitem["l_discount"][m]))


# ---------------------------------------------------------------------------
# TPC-H Q1 — scan-heavy grouped aggregation
# ---------------------------------------------------------------------------

def q1_logical(delta_days: int = 90) -> LogicalQuery:
    cutoff = datagen.DATE_MAX - delta_days
    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    charge = (col("l_extendedprice") * (1 - col("l_discount"))) \
        * (1 + col("l_tax"))
    return (
        scan("lineitem")
        .filter(col("l_shipdate") <= cutoff)
        .select("l_returnflag", "l_linestatus", "l_quantity",
                "l_extendedprice", "l_discount",
                disc_price.alias("disc_price"), charge.alias("charge"))
        .group_by("l_returnflag", "l_linestatus")
        .agg(sum_("l_quantity").alias("sum_qty"),
             sum_("l_extendedprice").alias("sum_base_price"),
             sum_("disc_price").alias("sum_disc_price"),
             sum_("charge").alias("sum_charge"),
             sum_("l_discount").alias("sum_disc"),
             # Count partials re-aggregate as sums downstream — the
             # optimizer's agg-split pass owns that mapping.
             count_("l_quantity").alias("count_order"))
        .collect("tpch_q1"))


def q1_plan(delta_days: int = 90) -> QueryPlan:
    return optimizer.plan(q1_logical(delta_days))


def q1_reference(lineitem: ColumnBatch, delta_days: int = 90) -> ColumnBatch:
    cutoff = datagen.DATE_MAX - delta_days
    m = lineitem["l_shipdate"] <= cutoff
    li = lineitem.select(m)
    disc_price = li["l_extendedprice"] * (1 - li["l_discount"])
    charge = disc_price * (1 + li["l_tax"])
    keys = li["l_returnflag"].astype(np.int64) * 2 \
        + li["l_linestatus"].astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    def agg(x):
        return np.bincount(inv, weights=x, minlength=len(uniq))
    return ColumnBatch({
        "l_returnflag": (uniq // 2).astype(np.int8),
        "l_linestatus": (uniq % 2).astype(np.int8),
        "sum_qty": agg(li["l_quantity"]),
        "sum_base_price": agg(li["l_extendedprice"]),
        "sum_disc_price": agg(disc_price),
        "sum_charge": agg(charge),
        "sum_disc": agg(li["l_discount"]),
        "count_order": np.bincount(inv, minlength=len(uniq)),
    })


# ---------------------------------------------------------------------------
# TPC-H Q12 — join + grouped conditional aggregation (shuffle-heavy)
# ---------------------------------------------------------------------------

def q12_logical(shuffle_partitions: int | None = 8,
                year_lo: int = datagen.DATE_1994_01_01) -> LogicalQuery:
    lineitem = (
        scan("lineitem")
        .filter(col("l_shipmode").isin([MAIL, SHIP])
                & (col("l_commitdate") < col("l_receiptdate"))
                & (col("l_shipdate") < col("l_commitdate"))
                & (col("l_receiptdate") >= year_lo)
                & (col("l_receiptdate") < year_lo + 365))
        .select("l_orderkey", "l_shipmode"))
    orders = scan("orders").select("o_orderkey", "o_orderpriority")
    high = col("o_orderpriority").case_in([URGENT, HIGH])
    return (
        lineitem
        .join(orders, on=("l_orderkey", "o_orderkey"))
        .select("l_shipmode", high.alias("high_line"),
                (1 - high).alias("low_line"))
        .group_by("l_shipmode")
        .agg(sum_("high_line").alias("high_line_count"),
             sum_("low_line").alias("low_line_count"))
        .collect("tpch_q12", shuffle_partitions=shuffle_partitions))


def q12_plan(shuffle_partitions: int = 8,
             year_lo: int = datagen.DATE_1994_01_01) -> QueryPlan:
    return optimizer.plan(q12_logical(shuffle_partitions, year_lo))


def q12_reference(lineitem: ColumnBatch, orders: ColumnBatch,
                  year_lo: int = datagen.DATE_1994_01_01) -> ColumnBatch:
    m = (np.isin(lineitem["l_shipmode"], [MAIL, SHIP])
         & (lineitem["l_commitdate"] < lineitem["l_receiptdate"])
         & (lineitem["l_shipdate"] < lineitem["l_commitdate"])
         & (lineitem["l_receiptdate"] >= year_lo)
         & (lineitem["l_receiptdate"] < year_lo + 365))
    li = lineitem.select(m)
    omap = dict(zip(orders["o_orderkey"].tolist(),
                    orders["o_orderpriority"].tolist()))
    prio = np.asarray([omap.get(int(k), -1) for k in li["l_orderkey"]])
    keep = prio >= 0
    shipmode = li["l_shipmode"][keep]
    high = np.isin(prio[keep], [URGENT, HIGH]).astype(np.float64)
    uniq, inv = np.unique(shipmode, return_inverse=True)
    return ColumnBatch({
        "l_shipmode": uniq,
        "high_line_count": np.bincount(inv, weights=high,
                                       minlength=len(uniq)),
        "low_line_count": np.bincount(inv, weights=1.0 - high,
                                      minlength=len(uniq)),
    })


# ---------------------------------------------------------------------------
# TPCx-BB Q3 — MapReduce-style UDF job over clickstreams
# ---------------------------------------------------------------------------

def bb_q3_logical(item_table_key: str, target_category: int = 3,
                  window: int = 5,
                  shuffle_partitions: int | None = 8) -> LogicalQuery:
    """``shuffle_partitions`` only pins row shuffles; this query has
    none after the agg-split optimization (the map pipeline partially
    aggregates, so the combine fan-out is optimizer-owned)."""
    return (
        scan("clickstreams", ["wcs_user_sk", "wcs_click_date_sk",
                              "wcs_click_time_sk", "wcs_item_sk",
                              "wcs_click_type"])
        .map_udf("clicks_before_purchase",
                 kwargs={"target_category": target_category,
                         "window": window},
                 broadcast={"item_categories": {"key": item_table_key,
                                                "column": "i_category_id"}},
                 output_columns=["viewed_item", "n"])
        .group_by("viewed_item")
        .agg(sum_("n").alias("views"))
        .collect("tpcxbb_q3", shuffle_partitions=shuffle_partitions))


def bb_q3_plan(item_table_key: str, target_category: int = 3,
               window: int = 5, shuffle_partitions: int = 8,
               top_k: int = 10) -> QueryPlan:
    return optimizer.plan(bb_q3_logical(item_table_key, target_category,
                                        window, shuffle_partitions))


def bb_q3_reference(clicks: ColumnBatch, item: ColumnBatch,
                    target_category: int = 3, window: int = 5
                    ) -> dict[int, int]:
    order = np.lexsort((clicks["wcs_click_time_sk"],
                        clicks["wcs_click_date_sk"], clicks["wcs_user_sk"]))
    user = clicks["wcs_user_sk"][order]
    item_sk = clicks["wcs_item_sk"][order]
    ctype = clicks["wcs_click_type"][order]
    cats = item["i_category_id"]
    counts: dict[int, int] = {}
    for p in np.flatnonzero((ctype == PURCHASE)
                            & (cats[item_sk] == target_category)):
        lo = max(0, p - window)
        for j in range(lo, p):
            if user[j] == user[p] and ctype[j] == VIEW:
                counts[int(item_sk[j])] = counts.get(int(item_sk[j]), 0) + 1
    return counts


QUERY_BUILDERS = {
    "q1": q1_plan,
    "q6": q6_plan,
    "q12": q12_plan,
}

# Logical builders by canonical name (and short alias) for tooling such
# as ``python -m repro_torch.engine.explain``. TPCx-BB Q3 needs a broadcast
# item-table key; tooling passes a placeholder.
LOGICAL_BUILDERS = {
    "tpch_q1": q1_logical,
    "tpch_q6": q6_logical,
    "tpch_q12": q12_logical,
    "q1": q1_logical,
    "q6": q6_logical,
    "q12": q12_logical,
    "tpcxbb_q3": lambda: bb_q3_logical("tables/item/part-00000"),
    "bb_q3": lambda: bb_q3_logical("tables/item/part-00000"),
}
