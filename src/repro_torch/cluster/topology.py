# Copied from src/repro/cluster/topology.py; only the imports are renamed.
"""ClusterTopology — the multi-node fabric model (DESIGN.md §9).

The paper's FlexLink is strictly intra-node: one H800 box whose NVLink /
PCIe / RDMA links Algorithm 1 aggregates.  At production scale the box is
the *inner* tier of a two-tier fabric — Meta's 100k-GPU stack composes
every collective as intra-node fast fabric + inter-node NIC tier, and
Blink builds a separate topology-aware schedule per tier (PAPERS.md).
This module makes the node count a first-class axis:

* a :class:`ClusterTopology` is N× one :class:`NodeProfile` (the intra
  tier) plus an **inter-node NIC tier** expressed as a second
  ``NodeProfile`` whose links are the cluster's aggregatable inter-node
  routes: the rail-aligned RDMA rails (the tier's *primary* — NIC ``i``
  of node ``a`` pairs with NIC ``i`` of node ``b``, no spine crossing),
  the cross-rail path through the spine switch, and the frontend-NIC
  host TCP path.  Expressing the tier as a NodeProfile is the point:
  the whole Stage-1/Stage-2 machinery (tuner, SlotController,
  PathTimingModel, TuningProfile) applies to it unchanged, keyed by the
  tier profile's name;
* ``flatten()`` is the N=1 view — the bare node profile — so every
  existing single-node code path is the degenerate special case, not a
  parallel implementation;
* at pod scale (DESIGN.md §15) a third **pod/DCN tier** composes on top:
  ``pods`` pods of ``n_nodes`` nodes each, joined by oversubscribed
  spine uplinks expressed as yet another ``NodeProfile``
  (``tier="pod"``), so the same Stage-1/Stage-2 machinery, member
  drains, codecs and fault timelines apply to the cross-pod fabric
  unchanged.  ``pods=1`` is bit-identical to the 2-tier view.

Tier profiles are synthesized deterministically from their parameters and
registered in ``links.PROFILES`` under ``<cluster>:nic``, so
``CommConfig(profile=...)`` (and therefore communicator memoization and
the persistent TuningProfile) work for the inter tier exactly as they do
for a box.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.links import (LinkKind, LinkSpec, NodeProfile, PROFILES,
                              degrade_profile, parse_degrade,
                              register_profile)

#: inter-node tier constants (physically motivated, never fitted to any
#: FlexLink result — same calibration discipline as links.py):
#: rail-aligned RDMA write latency ~2us + per-step spine/switch hop 2us;
#: the cross-rail path pays the spine and congestion; host TCP is the
#: frontend NIC.  Effective payload fractions mirror the secondary-path
#: discipline of the intra DB (achievable collective payload well under
#: raw line rate).
RAIL_STEP_US = 2.0
RAIL_FIXED_US = 15.0
RAIL_EFFICIENCY = 0.45          # effective / raw (bidirectional) for rails
XRAIL_STEP_US = 6.0
XRAIL_FIXED_US = 25.0
XRAIL_EFFICIENCY = 0.30
TCP_RAW_GBPS = 25.0             # 2x100Gb frontend NICs, bidirectional
TCP_EFFECTIVE_GBPS = 6.0
TCP_STEP_US = 20.0
TCP_FIXED_US = 50.0
INTER_HOP_US = 2.0              # per-ring-step switch traversal

#: pod/DCN tier constants (DESIGN.md §15) — same physically-motivated
#: discipline.  A pod's uplinks terminate on the datacenter spine: a
#: cross-pod hop pays multiple switch traversals (leaf -> spine -> leaf)
#: and the spine is *oversubscribed* — the provisioned cross-pod
#: bisection is a fraction of the sum of pod uplink line rates.  The
#: cross-spine-block detour and the frontend WAN path are the tier's
#: secondary routes.
SPINE_STEP_US = 8.0
SPINE_FIXED_US = 40.0
SPINE_EFFICIENCY = 0.35         # effective / raw for the spine uplinks
XSPINE_STEP_US = 15.0
XSPINE_FIXED_US = 80.0
XSPINE_EFFICIENCY = 0.20
POD_TCP_RAW_GBPS = 25.0         # frontend NICs again, now pod-aggregate
POD_TCP_EFFECTIVE_GBPS = 4.0
POD_TCP_STEP_US = 40.0
POD_TCP_FIXED_US = 120.0
POD_HOP_US = 5.0                # per-ring-step cross-pod switch traversals
DEFAULT_OVERSUBSCRIPTION = 4.0  # spine oversubscription factor


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    """N homogeneous nodes + the NIC tier between them (+ a pod tier).

    ``nic_tier`` is a synthetic :class:`NodeProfile` (``tier="inter"``)
    whose primary is the rail-aligned NIC path; ``nics_per_node`` rails of
    ``nic_gbit`` Gb/s each, rail-aligned across nodes when
    ``rail_aligned`` (the pairing :meth:`rail_rings` describes).

    ``pod_tier`` (DESIGN.md §15) is the optional third tier: the
    cross-pod DCN fabric between ``n_pods`` pods of ``n_nodes`` nodes
    each, another synthetic :class:`NodeProfile` (``tier="pod"``) whose
    primary is the oversubscribed spine uplink pool.  ``pods=1`` keeps
    ``pod_tier=None`` and every field at its default — the 2-tier view
    is bit-identical to a topology built before the pod tier existed
    (the parity contract the tests pin).
    """

    name: str
    node: NodeProfile
    n_nodes: int
    nic_tier: NodeProfile
    nics_per_node: int
    nic_gbit: float
    rail_aligned: bool = True
    n_pods: int = 1
    pod_tier: Optional[NodeProfile] = None
    pod_uplinks: int = 0
    pod_gbit: float = 0.0
    oversubscription: float = DEFAULT_OVERSUBSCRIPTION

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.nics_per_node < 1:
            raise ValueError("nics_per_node must be >= 1")
        if self.n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {self.n_pods}")
        if (self.n_pods > 1) != (self.pod_tier is not None):
            raise ValueError(
                "pod_tier must be set exactly when n_pods > 1 "
                f"(n_pods={self.n_pods}, pod_tier="
                f"{getattr(self.pod_tier, 'name', None)!r})")

    # -- views -----------------------------------------------------------------

    def flatten(self) -> NodeProfile:
        """The N=1 view: the bare intra-node profile.  Single-node code
        paths run against this — the cluster is its strict superset."""
        return self.node

    @property
    def hierarchical(self) -> bool:
        return self.n_nodes > 1 or self.n_pods > 1

    @property
    def tiers(self) -> Tuple[str, ...]:
        out: Tuple[str, ...] = ("intra",)
        if self.n_nodes > 1:
            out += ("inter",)
        if self.n_pods > 1:
            out += ("pod",)
        return out

    def tier_profile(self, tier: str) -> NodeProfile:
        if tier == "intra":
            return self.node
        if tier == "inter":
            return self.nic_tier
        if tier == "pod":
            if self.pod_tier is None:
                raise KeyError(
                    f"cluster {self.name!r} has no pod tier (n_pods=1)")
            return self.pod_tier
        raise KeyError(f"unknown tier {tier!r} (intra|inter|pod)")

    def rail_rings(self) -> Dict[int, List[Tuple[int, int]]]:
        """Rail-aligned NIC pairing: for each rail, the directed ring
        edges (node a -> node b) that rail's NICs form across nodes.
        Rail ``i`` of every node talks only to rail ``i`` of the next —
        the pairing that keeps rail traffic off the spine switch.  With
        ``rail_aligned=False`` every rail's edges are the same flat ring
        (all traffic crosses the spine)."""
        n = self.n_nodes
        ring = [(a, (a + 1) % n) for a in range(n)] if n > 1 else []
        return {rail: list(ring) for rail in range(self.nics_per_node)}

    def describe(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "name": self.name,
            "node_profile": self.node.name,
            "n_nodes": self.n_nodes,
            "nic_tier": self.nic_tier.name,
            "nics_per_node": self.nics_per_node,
            "nic_gbit": self.nic_gbit,
            "rail_aligned": self.rail_aligned,
            "tiers": list(self.tiers),
        }
        # pod keys are additive-only: a pods=1 topology describes itself
        # byte-identically to the pre-pod 2-tier view (parity contract).
        if self.n_pods > 1:
            out.update({
                "n_pods": self.n_pods,
                "pod_tier": self.pod_tier.name,
                "pod_uplinks": self.pod_uplinks,
                "pod_gbit": self.pod_gbit,
                "oversubscription": self.oversubscription,
            })
        return out


def _gbits(gbps: float) -> float:
    return gbps / 8.0


def nic_tier_name(node_name: str, nics_per_node: int, nic_gbit: float,
                  rail_aligned: bool = True) -> str:
    """Deterministic tier-profile name: a pure function of EVERY parameter
    the tier's constants derive from, shared by every process that builds
    the same cluster (the TuningProfile and communicator memo keys depend
    on it).  Non-rail-aligned tiers get their own name — their rail
    bandwidth differs, so sharing a name would either collide at
    registration or silently warm-start from the wrong fabric's shares."""
    base = f"{node_name}:nic{nics_per_node}x{nic_gbit:g}"
    return base if rail_aligned else base + ":spine"


def make_nic_tier(node: NodeProfile, *, nics_per_node: int = 4,
                  nic_gbit: float = 400.0,
                  rail_aligned: bool = True) -> NodeProfile:
    """Synthesize the inter-node tier profile for one NIC configuration.

    Three aggregatable inter-node routes, mapping onto the same
    (primary, staged, ortho) route slots the intra tier uses:

      rail     : rail-aligned RDMA over all NICs in parallel — the tier's
                 primary (no spine crossing when rail-aligned);
      xrail    : cross-rail RDMA through the spine switch — extra hop
                 latency, congestion-discounted bandwidth;
      host_tcp : frontend-NIC TCP — slow, but idle during collectives.
    """
    raw = nics_per_node * _gbits(nic_gbit) * 2.0   # bidirectional GB/s
    rail_eff = RAIL_EFFICIENCY if rail_aligned else XRAIL_EFFICIENCY
    # the rail class carries an explicit instance per physical NIC: the
    # per-rail LinkMembers Stage 2 drains individually when one rail
    # degrades (DESIGN.md §10).  Uniform healthy members are guaranteed
    # (by canonicalization + the simulator's uniform fast path) to behave
    # bit-identically to the old memberless aggregate.
    links = (
        LinkSpec("rail", LinkKind.NIC_RAIL, raw_GBps=raw,
                 effective_GBps=rail_eff * raw,
                 step_latency_us=RAIL_STEP_US,
                 fixed_overhead_us=RAIL_FIXED_US).with_members(
                     [f"rail{i}" for i in range(nics_per_node)]),
        LinkSpec("xrail", LinkKind.RDMA, raw_GBps=raw,
                 effective_GBps=XRAIL_EFFICIENCY * raw,
                 step_latency_us=XRAIL_STEP_US,
                 fixed_overhead_us=XRAIL_FIXED_US),
        LinkSpec("host_tcp", LinkKind.DCN, raw_GBps=TCP_RAW_GBPS,
                 effective_GBps=TCP_EFFECTIVE_GBPS,
                 step_latency_us=TCP_STEP_US,
                 fixed_overhead_us=TCP_FIXED_US),
    )
    return NodeProfile(name=nic_tier_name(node.name, nics_per_node,
                                          nic_gbit, rail_aligned),
                       links=links, tier="inter",
                       inter_hop_us=INTER_HOP_US)


def pod_tier_name(node_name: str, pod_uplinks: int, pod_gbit: float,
                  oversubscription: float) -> str:
    """Deterministic pod-tier profile name — like :func:`nic_tier_name`,
    a pure function of EVERY parameter the tier's constants derive from
    (and of nothing else: not the pod count, not the node count — so
    elastic node loss and resume at a different scale hit the same
    TuningProfile entries, the ``drop_node`` contract one tier up)."""
    return (f"{node_name}:pod{pod_uplinks}x{pod_gbit:g}"
            f"os{oversubscription:g}")


def make_pod_tier(node: NodeProfile, *, pod_uplinks: int = 4,
                  pod_gbit: float = 400.0,
                  oversubscription: float = DEFAULT_OVERSUBSCRIPTION
                  ) -> NodeProfile:
    """Synthesize the pod/DCN tier profile (DESIGN.md §15).

    Three aggregatable cross-pod routes, mapping onto the same
    (primary, staged, ortho) route slots every tier uses:

      spine   : the pod's spine uplinks in parallel — the tier's primary.
                Oversubscription divides the *provisioned* (raw)
                bandwidth: the spine admits 1/oversubscription of the
                uplink line rate as cross-pod bisection.  One explicit
                LinkMember per uplink, so member drains, fault timelines
                and Stage-2 balancing apply to the pod tier unchanged;
      xspine  : the detour through a neighboring spine block — more
                switch hops, congestion-discounted bandwidth;
      pod_tcp : the frontend/WAN path — slow, but idle during
                collectives.
    """
    if pod_uplinks < 1:
        raise ValueError("pod_uplinks must be >= 1")
    if oversubscription < 1.0:
        raise ValueError(
            f"oversubscription must be >= 1, got {oversubscription}")
    raw = pod_uplinks * _gbits(pod_gbit) * 2.0 / oversubscription
    links = (
        LinkSpec("spine", LinkKind.DCN_SPINE, raw_GBps=raw,
                 effective_GBps=SPINE_EFFICIENCY * raw,
                 step_latency_us=SPINE_STEP_US,
                 fixed_overhead_us=SPINE_FIXED_US).with_members(
                     [f"spine{i}" for i in range(pod_uplinks)]),
        LinkSpec("xspine", LinkKind.RDMA, raw_GBps=raw,
                 effective_GBps=XSPINE_EFFICIENCY * raw,
                 step_latency_us=XSPINE_STEP_US,
                 fixed_overhead_us=XSPINE_FIXED_US),
        LinkSpec("pod_tcp", LinkKind.DCN, raw_GBps=POD_TCP_RAW_GBPS,
                 effective_GBps=POD_TCP_EFFECTIVE_GBPS,
                 step_latency_us=POD_TCP_STEP_US,
                 fixed_overhead_us=POD_TCP_FIXED_US),
    )
    return NodeProfile(name=pod_tier_name(node.name, pod_uplinks, pod_gbit,
                                          oversubscription),
                       links=links, tier="pod",
                       inter_hop_us=POD_HOP_US)


def make_cluster(node: Union[str, NodeProfile], n_nodes: int, *,
                 nics_per_node: int = 4, nic_gbit: float = 400.0,
                 rail_aligned: bool = True,
                 pods: int = 1, pod_uplinks: int = 0,
                 pod_gbit: float = 0.0,
                 oversubscription: float = DEFAULT_OVERSUBSCRIPTION,
                 name: str = "") -> ClusterTopology:
    """Build (and register the tier profiles of) one cluster topology.

    ``node`` is a profile name from ``links.PROFILES`` or a NodeProfile.
    The tier profiles are registered under deterministic names so
    ``CommConfig(profile=<tier>.name)`` resolves in any process that
    built the same cluster.  ``pods=1`` (the default) builds exactly the
    2-tier topology this function always built — no pod profile is
    synthesized or registered, and the default cluster name is
    unchanged.  ``pods>1`` adds the pod tier: ``pod_uplinks`` spine
    uplinks of ``pod_gbit`` Gb/s per pod (defaulting to the NIC-tier
    figures), divided by ``oversubscription``.
    """
    prof = PROFILES[node] if isinstance(node, str) else node
    register_profile(prof)
    nic = register_profile(make_nic_tier(prof, nics_per_node=nics_per_node,
                                         nic_gbit=nic_gbit,
                                         rail_aligned=rail_aligned))
    if pods <= 1:
        return ClusterTopology(
            name=name or f"{n_nodes}x{prof.name}",
            node=prof, n_nodes=n_nodes, nic_tier=nic,
            nics_per_node=nics_per_node, nic_gbit=nic_gbit,
            rail_aligned=rail_aligned)
    pod_uplinks = pod_uplinks or nics_per_node
    pod_gbit = pod_gbit or nic_gbit
    pod = register_profile(make_pod_tier(prof, pod_uplinks=pod_uplinks,
                                         pod_gbit=pod_gbit,
                                         oversubscription=oversubscription))
    return ClusterTopology(
        name=name or f"{pods}pod{n_nodes}x{prof.name}",
        node=prof, n_nodes=n_nodes, nic_tier=nic,
        nics_per_node=nics_per_node, nic_gbit=nic_gbit,
        rail_aligned=rail_aligned,
        n_pods=pods, pod_tier=pod, pod_uplinks=pod_uplinks,
        pod_gbit=pod_gbit, oversubscription=oversubscription)


def degrade_cluster(cluster: ClusterTopology, spec: str) -> ClusterTopology:
    """Apply one ``name[:member]=factor`` fault to whichever tier owns the
    target — the NIC tier first (``rail3=0.25`` drains one rail), then the
    intra-node profile (``pcie=0.5`` throttles the host path of every
    box).  Both the degraded tier profile and the returned topology carry
    deterministic fault-suffixed names, so CommConfig memoization and
    TuningProfile entries of the degraded fabric can never collide with —
    or warm-start from — the healthy one.
    """
    parse_degrade(spec)                  # fail fast on a malformed spec
    try:
        nic = degrade_profile(cluster.nic_tier, spec)
        return dataclasses.replace(cluster, name=f"{cluster.name}!{spec}",
                                   nic_tier=nic)
    except KeyError:
        pass
    if cluster.pod_tier is not None:
        try:
            pod = degrade_profile(cluster.pod_tier, spec)
            return dataclasses.replace(cluster,
                                       name=f"{cluster.name}!{spec}",
                                       pod_tier=pod)
        except KeyError:
            pass
    node = degrade_profile(cluster.node, spec)   # KeyError if absent there too
    return dataclasses.replace(cluster, name=f"{cluster.name}!{spec}",
                               node=node)


def drop_node(cluster: ClusterTopology, node_index: int) -> ClusterTopology:
    """The post-loss topology after an elastic ``node<i>@step=down`` event
    (repro_torch.faults, DESIGN.md §14): the same homogeneous fabric with one
    fewer node.  The tier PROFILES are untouched — ``nic_tier_name`` is a
    pure function of the node type and NIC parameters, not the node count
    — so TuningProfile entries and communicator memo keys of the
    surviving fabric line up with a fresh launch at N-1 nodes, which is
    exactly the bit-identity contract elastic resume is tested against.
    Only the topology NAME records the loss."""
    if not 0 <= node_index < cluster.n_nodes:
        raise ValueError(
            f"node index {node_index} out of range for "
            f"{cluster.name!r} (n_nodes={cluster.n_nodes})")
    if cluster.n_nodes < 2:
        raise ValueError(
            f"cannot drop a node from single-node cluster {cluster.name!r}")
    return dataclasses.replace(cluster,
                               name=f"{cluster.name}-drop{node_index}",
                               n_nodes=cluster.n_nodes - 1)


def cluster_for(profile: str, n_nodes: int,
                pods: int = 1) -> ClusterTopology:
    """Default cluster for one intra-node profile — what the launchers
    synthesize for ``--nodes N`` (and ``--pods P``) when no named cluster
    is given.  GPU boxes get the 4x400Gb rail config; the TPU profile
    gets a 2x200Gb DCN-class tier.  ``pods>1`` adds the default pod tier
    (uplinks/Gb mirroring the NIC tier, 4:1 oversubscription)."""
    if profile.startswith("tpu"):
        return make_cluster(profile, n_nodes, nics_per_node=2,
                            nic_gbit=200.0, pods=pods)
    return make_cluster(profile, n_nodes, nics_per_node=4, nic_gbit=400.0,
                        pods=pods)
