"""Multi-replica serving tier: a prefix-affinity consistent-hash router
in front of N inference engines.

Port of ``deeplearning4j_tpu/serving/router/``.  :class:`PrefixRouter`
hashes each request by its content-addressed prefix chain onto a
virtual-node :class:`~.ring.HashRing` of replicas;
:class:`~.replicas.ReplicaPool` supplies breaker-style health,
:class:`RouterServer` exposes the ``ModelServer`` HTTP surface, and
replicas are in-process engines (:class:`~.replicas.EngineReplica`) or
spawned ``ModelServer`` processes (:class:`~.replicas.ProcessReplica`).
"""

from .replicas import (AllReplicasUnavailable, EngineReplica, ProcessReplica,
                       Replica, ReplicaPool, ReplicaUnavailable)
from .ring import HashRing
from .router import PrefixRouter, RouterConfig
from .server import RouterServer

__all__ = [
    "AllReplicasUnavailable",
    "EngineReplica",
    "HashRing",
    "PrefixRouter",
    "ProcessReplica",
    "Replica",
    "ReplicaPool",
    "ReplicaUnavailable",
    "RouterConfig",
    "RouterServer",
]
