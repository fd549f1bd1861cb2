"""Cluster layer: worker pools + policy scheduling over the offload runtime.

``ClusterPool`` owns worker lifecycle (spawn/attach, liveness, restart,
reap, elastic add/remove under traffic); ``Scheduler`` routes
``async_offload`` calls by policy with credit-based flow control, sticky
``session=`` affinity (``SessionRouter``), and fails over on worker death.
See the module docstrings for the policy, backpressure and membership
contracts.
"""

from repro_torch.cluster.pool import ClusterPool, register_cluster_handlers
from repro_torch.cluster.scheduler import POLICIES, Scheduler, as_completed, gather
from repro_torch.cluster.sessions import SessionRouter, rendezvous_hash
from repro_torch.offload.dataplane import BufferDirectory, BufferRecord

__all__ = [
    "BufferDirectory",
    "BufferRecord",
    "ClusterPool",
    "Scheduler",
    "SessionRouter",
    "POLICIES",
    "as_completed",
    "gather",
    "register_cluster_handlers",
    "rendezvous_hash",
]
