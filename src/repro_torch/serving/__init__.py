"""Serving: ``MonitorSession`` over the collaborative engine
(``serving/api.py``), its async workers (``serving/async_rpc.py``), the
wire codec (``serving/wire.py``), the same-host shared-memory rings
(``serving/shm.py``), the standalone correction server
(``serving/server.py``, run with ``python -m repro_torch.launch.server``),
the threshold policies and the cascade (``serving/policy.py``), the
metrics trackers (``serving/tracker.py``) and mesh-sharded serving
(``serving/mesh.py``, imported on use).  A fleet of correction servers
behind a routing supervisor (``TransportSpec.parse("fleet:<router>")``)
lives in ``serving/fleet.py``, imported on use (its subprocess backend
pulls in the launcher):

    from repro_torch.serving import MonitorSession, SessionConfig, TransportSpec
"""
from repro_torch.serving import async_rpc, collaborative, engine, shm, tracker, wire  # noqa: F401,E501
from repro_torch.serving.api import (MonitorSession, SessionConfig,  # noqa: F401
                                     TransportSpec)
from repro_torch.serving.collaborative import CollaborativeEngine  # noqa: F401
from repro_torch.serving.policy import (BudgetPolicy, CascadeSession,  # noqa: F401
                                        FixedPolicy, QuantilePolicy,
                                        TriggerPolicy)
from repro_torch.serving.server import CorrectionServer  # noqa: F401
from repro_torch.serving.tracker import (CompositeTracker, Histogram,  # noqa: F401
                                         InMemoryTracker, JsonFileTracker,
                                         LogTracker, NoopTracker, Tracker)
