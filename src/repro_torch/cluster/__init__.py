"""repro_torch.cluster — multi-node fabric model + tiered hierarchical
collectives (DESIGN.md §9).

Port of ``src/repro/cluster/``.  A :class:`ClusterTopology` is N× one
intra-node :class:`~repro_torch.core.links.NodeProfile` plus an inter-node
NIC tier (rail-aligned RDMA rails, cross-rail spine path, host TCP),
itself expressed as a NodeProfile so the whole Stage-1/Stage-2 control
plane applies per tier.  A :class:`ClusterCommunicator` composes one
FlexCommunicator per tier into hierarchical AllReduce / AllGather /
ReduceScatter, and :class:`ClusterTimingModel` prices the hierarchy
against the flat inter-node ring.  ``topology.py`` and ``simulator.py``
are copies of the reference's.

``ClusterCommunicator`` is re-exported lazily: it pulls in the
communicator stack (torch), while the topology/simulator halves stay
importable as leaf modules.
"""

from repro_torch.cluster.simulator import ClusterTimingModel, PHASE_SYNC_US
from repro_torch.cluster.topology import (ClusterTopology, cluster_for,
                                          degrade_cluster, make_cluster,
                                          make_nic_tier, make_pod_tier,
                                          nic_tier_name, pod_tier_name)

_LAZY = ("ClusterCommunicator",)


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.cluster import communicator
        return getattr(communicator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ClusterCommunicator",
    "ClusterTimingModel",
    "ClusterTopology",
    "PHASE_SYNC_US",
    "cluster_for",
    "degrade_cluster",
    "make_cluster",
    "make_nic_tier",
    "make_pod_tier",
    "nic_tier_name",
    "pod_tier_name",
]
