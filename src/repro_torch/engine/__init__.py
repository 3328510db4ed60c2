"""Skyrise serverless query engine on PyTorch (paper §3.2): a
shared-storage engine whose coordinator and workers are stateless tasks
communicating only through the object store, runnable in 'elastic'
(FaaS) or 'provisioned' (IaaS) mode with identical physical plans.

Author queries with the logical builder (``engine.logical``), lower them
with ``engine.optimizer`` or hand them to ``engine.coordinator.
Coordinator.run``. Execution runs on the ``torch`` backend on
``device="cuda"`` by default; ``backend="numpy"`` selects the
interpreted float64 semantic reference. ``python -m
repro_torch.engine.explain <query>`` shows a query's logical plan, the
applied optimizer rules and the physical pipelines.

The public API is the reference's (``repro.engine``): ``Coordinator``,
``QueryPlan`` and the logical builder.
"""
from repro_torch.engine import (columnar, compile, coordinator,  # noqa: F401
                                datagen, logical, operators, optimizer,
                                plans, queries, worker)
from repro_torch.engine.coordinator import Coordinator
from repro_torch.engine.logical import (col, count_, lit, max_, min_, scan,
                                        sum_)
from repro_torch.engine.plans import QueryPlan


def __getattr__(name):
    # ``explain`` loads lazily so ``python -m repro_torch.engine.explain``
    # doesn't trip runpy's already-imported warning.
    if name == "explain":
        import importlib
        return importlib.import_module("repro_torch.engine.explain")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    # primary entry points
    "Coordinator", "QueryPlan",
    # logical builder
    "scan", "col", "lit", "sum_", "count_", "min_", "max_",
    # modules
    "columnar", "compile", "coordinator", "datagen", "explain", "logical",
    "operators", "optimizer", "plans", "queries", "worker",
]
