"""tSPM+ query-serving front end (the read path).

Layers (see each module's docstring):

  * :mod:`~repro_torch.serving.tspm.plan`     — typed, canonicalized plan IR;
  * :mod:`~repro_torch.serving.tspm.replica`  — snapshot-isolated read replicas,
    double-buffered at tick boundaries;
  * :mod:`~repro_torch.serving.tspm.cache`    — LRU result cache keyed on
    (canonical plan, snapshot version);
  * :mod:`~repro_torch.serving.tspm.features` — streaming per-patient feature
    store, point-in-time consistent with each view;
  * :mod:`~repro_torch.serving.tspm.server`   — the batched QueryServer façade
    (``session.serve()``), its predicate op on the session's device.
"""
from repro_torch.serving.tspm.cache import ResultCache
from repro_torch.serving.tspm.features import FeatureStore
from repro_torch.serving.tspm.plan import BARRIER_OPS, VECTOR_OPS, QueryPlan, plan
from repro_torch.serving.tspm.replica import (EvalColumns, ReadReplica,
                                              ReplicaView, uncompacted_rows)
from repro_torch.serving.tspm.server import QueryResult, QueryServer, Ticket

__all__ = [
    "BARRIER_OPS", "VECTOR_OPS", "QueryPlan", "plan",
    "ReadReplica", "ReplicaView", "EvalColumns", "uncompacted_rows",
    "ResultCache", "FeatureStore",
    "QueryServer", "QueryResult", "Ticket",
]
