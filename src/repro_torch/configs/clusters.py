# Copied from src/repro/configs/clusters.py; only the imports are renamed.
"""Named cluster topologies — the fabric-side registry (DESIGN.md §9).

The arch configs in this package describe the *model*; these describe the
*machine room*: N nodes of one ``links.NodeProfile`` plus their inter-node
NIC tier (``repro_torch.cluster.topology``).  Every entry is built through
``make_cluster``, which registers the synthesized NIC-tier profile in
``links.PROFILES`` — so selecting a cluster by name (``--cluster`` on the
launchers) is all a process needs for the tier's CommConfig, simulator
constants and TuningProfile keys to line up with any other process using
the same cluster.

Building an entry lazily (function, not module constant) keeps import
side effects to the registrations actually requested.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.cluster.topology import ClusterTopology, make_cluster

#: name -> builder.  The reference config is the paper's box scaled out:
#: 2x/4x H800 nodes with 4 rail-aligned 400Gb NICs each; the TPU entry is
#: the v5e profile behind a 2x200Gb DCN-class tier.
_BUILDERS: Dict[str, Callable[[], ClusterTopology]] = {
    "2xh800_rail4": lambda: make_cluster(
        "h800", 2, nics_per_node=4, nic_gbit=400.0, name="2xh800_rail4"),
    "4xh800_rail4": lambda: make_cluster(
        "h800", 4, nics_per_node=4, nic_gbit=400.0, name="4xh800_rail4"),
    "2xgb200_rail8": lambda: make_cluster(
        "gb200", 2, nics_per_node=8, nic_gbit=400.0, name="2xgb200_rail8"),
    "2xtpu_v5e_dcn": lambda: make_cluster(
        "tpu_v5e", 2, nics_per_node=2, nic_gbit=200.0,
        name="2xtpu_v5e_dcn"),
    "4xtpu_v5e_dcn": lambda: make_cluster(
        "tpu_v5e", 4, nics_per_node=2, nic_gbit=200.0,
        name="4xtpu_v5e_dcn"),
    # 3-tier entries (DESIGN.md §15): pods of rail-aligned H800 nodes
    # joined by an oversubscribed DCN spine.  The CI pod-smoke target:
    "2pod2xh800_rail4": lambda: make_cluster(
        "h800", 2, nics_per_node=4, nic_gbit=400.0, pods=2,
        name="2pod2xh800_rail4"),
    # the kimi_k2_1t_a32b expert-parallel multi-pod scenario: 4 pods x
    # 4 nodes of H800 with 4x400Gb rails per node, 8x400Gb spine uplinks
    # per pod at 4:1 oversubscription — the simulated fabric the
    # pod_a2a benchmark prices rail-local dispatch against
    "4pod4xh800_ep": lambda: make_cluster(
        "h800", 4, nics_per_node=4, nic_gbit=400.0, pods=4,
        pod_uplinks=8, pod_gbit=400.0, oversubscription=4.0,
        name="4pod4xh800_ep"),
}

CLUSTER_IDS: List[str] = sorted(_BUILDERS)

_CACHE: Dict[str, ClusterTopology] = {}


def get_cluster(name: str) -> ClusterTopology:
    """Resolve one named cluster (building + registering it on first use)."""
    if name not in _BUILDERS:
        raise KeyError(
            f"unknown cluster {name!r}; known: {', '.join(CLUSTER_IDS)}")
    if name not in _CACHE:
        _CACHE[name] = _BUILDERS[name]()
    return _CACHE[name]


def all_clusters() -> Dict[str, ClusterTopology]:
    return {n: get_cluster(n) for n in CLUSTER_IDS}


def resolve_cluster(cluster_name: str, nodes: int, pods: int = 0):
    """Shared launcher logic:
    ``(ClusterTopology | None, effective nodes, effective pods)``.

    ``nodes <= 0`` / ``pods <= 0`` mean the flag was not given (launchers
    default ``--nodes``/``--pods`` to 0): a named cluster then implies
    its node AND pod counts — silently running a 3-tier cluster without
    its pod axis would report a hierarchy that never lowered.  An
    EXPLICIT flag always wins: ``--nodes 1`` with a cluster is a
    deliberate flat run on the cluster's node type, and an explicit
    multi-node/multi-pod count must match the topology (the ParallelCtx
    validation enforces it)."""
    if not cluster_name:
        return None, max(nodes, 1), max(pods, 1)
    cluster = get_cluster(cluster_name)
    return (cluster, (nodes if nodes > 0 else cluster.n_nodes),
            (pods if pods > 0 else cluster.n_pods))


def resolve_degrade(cluster, nodes: int, profile: str, spec: str):
    """``--degrade`` resolution: sugar for a step-0 fault schedule, routed
    through the one shared parser (:func:`resolve_faults`) so train,
    serve and dryrun agree on what a fault spec means.  Returns
    ``(cluster, profile)``."""
    cluster, profile, timeline = resolve_faults(cluster, nodes, profile,
                                                degrade=spec)
    assert timeline is None     # step-0 degrades always fold statically
    return cluster, profile


def resolve_faults(cluster, nodes: int, profile: str, *,
                   degrade: str = "", fault: str = "", pods: int = 1):
    """Shared launcher logic for ``--degrade``/``--fault``: returns
    ``(cluster, profile, timeline)`` where ``timeline`` is the
    :class:`~repro_torch.faults.HealthTimeline` of the DYNAMIC events (None
    when the schedule has none).

    * ``--degrade x=f`` parses through the same DSL as ``--fault`` — it
      IS ``--fault x@step0=f`` — but may only contain step-0 degrade
      events (it froze health at launch; anything time-varying belongs
      on ``--fault``).
    * Step-0 degrade events fold STATICALLY, exactly as ``--degrade``
      always did: with a cluster in play (given, or implied by a
      multi-node run — the one ``ParallelCtx`` would synthesize is
      materialized first so the fault lands on the run's actual NIC
      tier) they resolve via ``degrade_cluster``, else they degrade the
      flat node profile, either way yielding a deterministic
      ``!``-suffixed fabric name (DESIGN.md §10).  This keeps degraded
      *launches* — Stage-1 tuned against the faulted fabric from step 0
      — byte-identical to the pre-timeline behavior.
    * Step>0 events (and node losses) become the timeline; every target
      is resolved against the run's tiers HERE, at parse time, so a
      schedule cannot fail hundreds of steps into a run.  Dynamic
      factors are set-points relative to the LAUNCH fabric, so a target
      may not appear both statically and dynamically (restoring "to
      1.0" would be ambiguous — reject rather than guess).
    """
    from repro_torch.faults.schedule import (HealthTimeline,
                                             parse_fault_schedule,
                                             validate_schedule)
    events = []
    for ev in parse_fault_schedule(degrade):
        if ev.kind == "node" or ev.step > 0:
            raise ValueError(
                f"--degrade is launch-time only: {ev.spec!r} is a "
                f"dynamic event — schedule it with --fault")
        events.append(ev)
    events.extend(parse_fault_schedule(fault))
    if not events:
        return cluster, profile, None
    from repro_torch.cluster.topology import cluster_for, degrade_cluster
    from repro_torch.core.links import PROFILES, degrade_profile
    if cluster is None and nodes > 1:
        cluster = cluster_for(profile, nodes, pods=max(pods, 1))
    if cluster is not None:
        tiers = [cluster.nic_tier]
        if cluster.pod_tier is not None:
            tiers.append(cluster.pod_tier)
        tiers.append(cluster.node)
    else:
        tiers = [PROFILES[profile]]
    n_nodes = cluster.n_nodes if cluster is not None else max(nodes, 1)
    canonical = validate_schedule(events, profiles=tiers, n_nodes=n_nodes)
    static = [ev for ev, can in zip(events, canonical)
              if can.kind == "degrade" and can.step == 0]
    dynamic = [can for can in canonical
               if can.kind == "node" or can.step > 0]
    static_targets = {(c.target, c.member) for c in canonical
                      if c.kind == "degrade" and c.step == 0}
    clash = [d for d in dynamic if d.kind == "degrade"
             and (d.target, d.member) in static_targets]
    if clash:
        raise ValueError(
            f"fault target(s) {sorted(c.spec for c in clash)} also "
            f"degraded at launch: dynamic factors are set-points "
            f"relative to the launch fabric, so restoring such a target "
            f"is ambiguous — start its schedule at step >= 1 instead")
    # static fold — applied with the ORIGINAL spelling so degraded-launch
    # fabric names stay exactly historical
    for ev in static:
        if cluster is not None:
            cluster = degrade_cluster(cluster, ev.degrade_spec)
            profile = cluster.node.name
        else:
            profile = degrade_profile(PROFILES[profile],
                                      ev.degrade_spec).name
    return cluster, profile, (HealthTimeline(dynamic) if dynamic else None)
