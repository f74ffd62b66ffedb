"""Multi-replica serving: engine workers, the router and the controller.

Counterpart of ``repro.serve.cluster``.  One replica is one
:class:`EngineWorker`: an engine session behind a narrow
submit/step/stats/migrate API, in a ``prefill | decode | mixed`` role.
The :class:`Router` scores replicas by load and by content-addressed
prefix affinity; the :class:`ClusterController` owns placement, the
fleet's round clock, the ``SwapHandle`` handoff between prefill and
decode replicas, and the retry path when a worker dies.  A request's
tokens are those of one direct engine whatever the topology (see
``controller.py``).  Each worker has an engine of its own over the same
model and parameter tensors (``make_cluster``).
"""

from repro_torch.serve.cluster.controller import (
    AsyncClusterFrontend,
    ClusterController,
    make_cluster,
)
from repro_torch.serve.cluster.router import ROUTER_POLICIES, Router, route_handoff
from repro_torch.serve.cluster.worker import (
    ROLES,
    EngineWorker,
    HandoffTicket,
    WorkerDead,
    WorkerStats,
)

__all__ = [
    "AsyncClusterFrontend",
    "ClusterController",
    "EngineWorker",
    "HandoffTicket",
    "ROLES",
    "ROUTER_POLICIES",
    "Router",
    "WorkerDead",
    "WorkerStats",
    "make_cluster",
    "route_handoff",
]
