# Copied from src/repro/cluster/simulator.py; only the imports are renamed.
"""Analytic tier timing — hierarchical vs flat inter-node ring.

Extends the intra-node ``PathTimingModel`` to the cluster: one model per
tier (the inter tier's profile carries its ``inter_hop_us`` switch cost),
plus the composition arithmetic for the hierarchical schedules of
``cluster/communicator.py`` and the flat single-ring baseline they are
measured against (``benchmarks/hierarchy_crossover.py``).  A 3-tier
topology (DESIGN.md §15) adds the pod/DCN tier as a third
``PathTimingModel`` and the rail-local vs flat vs naive pricing of the
expert-parallel all_to_all (``benchmarks/pod_a2a.py``).

Cost model (per-rank payload B, m ranks/node, n nodes, N = m*n):

* hierarchical all_reduce = t_intra(RS, m, B) + t_inter(AR, n, B_node)
  + t_intra(AG, m, B/m) + 2 phase barriers, where B_node = B is the
  *node-aggregate* payload crossing the NIC tier (m ranks each move a
  B/m shard concurrently over the shared rails);
* flat ring = one ring over all N ranks.  Every synchronized step
  includes the node-cut edge, and that edge rides ONE rail (a rank's
  egress is one NIC), so the flat ring pays per-rail bandwidth and
  NIC-paced latency on all its steps — exactly why a flat ring spanning
  nodes dies at scale (Meta 100k-GPU, PAPERS.md) and why the crossover
  to hierarchical arrives as soon as bandwidth matters.

Phase barriers are real: each tier hand-off is a full synchronization +
kernel launch (``PHASE_SYNC_US``), which is what lets the flat ring win
at small message sizes — the crossover the benchmark reports.

Per-tier shares come from running Algorithm 1 against each tier's own
model (``flex=True``) — the full FlexLink treatment per tier — or
primary-only (``flex=False``) for the plain NCCL-shaped baselines.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.cluster.topology import ClusterTopology
from repro_torch.core.simulator import PathTimingModel
from repro_torch.core.topology import Collective
from repro_torch.core.tuner import initial_tune, measure_fn

#: per tier hand-off: full-cluster synchronization + next-phase launch.
PHASE_SYNC_US = 50.0


class ClusterTimingModel:
    """MeasurePathTimings oracle for one (topology, ranks-per-node)."""

    def __init__(self, topology: ClusterTopology, ranks_per_node: int, *,
                 secondary_algo: str = "ring"):
        self.topology = topology
        self.m = int(ranks_per_node)
        self.intra = PathTimingModel(topology.node,
                                     secondary_algo=secondary_algo)
        self.inter = PathTimingModel(topology.nic_tier,
                                     secondary_algo=secondary_algo)
        #: pod/DCN tier model — None on a 2-tier topology (DESIGN.md §15)
        self.pod = (PathTimingModel(topology.pod_tier,
                                    secondary_algo=secondary_algo)
                    if topology.pod_tier is not None else None)
        self._shares: Dict[Tuple[str, Collective, int, int],
                           Dict[str, float]] = {}

    # -- per-tier costs --------------------------------------------------------

    def _model(self, tier: str) -> PathTimingModel:
        if tier == "pod":
            if self.pod is None:
                raise ValueError("topology has no pod tier")
            return self.pod
        return self.intra if tier == "intra" else self.inter

    def _fractions(self, tier: str, op: Collective, n: int,
                   payload: float, flex: bool) -> Dict[str, float]:
        model = self._model(tier)
        if not flex or n <= 1:
            return {model.profile.primary.name: 1.0}
        key = (tier, op, n, int(payload))
        if key not in self._shares:
            paths = [l.name for l in model.profile.links]
            res = initial_tune(paths, model.profile.primary.name,
                               measure_fn(model, op, n, payload))
            self._shares[key] = res.fractions()
        return self._shares[key]

    def tier_time(self, tier: str, op: Collective, n: int,
                  payload: float, *, flex: bool = True) -> float:
        """One tier-local collective's completion time (s)."""
        if n <= 1 or payload <= 0:
            return 0.0
        model = self._model(tier)
        fr = self._fractions(tier, op, n, payload, flex)
        return model.total_time(op, n, payload, fr)

    # -- composed schedules ----------------------------------------------------

    def hierarchical_time(self, op: Collective, payload_bytes: float, *,
                          flex: bool = True) -> float:
        """Completion time of the tier-chained schedule for per-rank
        payload ``payload_bytes`` (the compositions of
        cluster/communicator.py).  A 2-tier topology takes exactly the
        historical arithmetic; a pod tier chains the third level."""
        if self.topology.n_pods > 1:
            return self._three_tier_time(op, payload_bytes, flex=flex)
        m, n = self.m, self.topology.n_nodes
        if n <= 1:
            return self.tier_time("intra", op, m, payload_bytes, flex=flex)
        if m <= 1:
            return self.tier_time("inter", op, n, payload_bytes, flex=flex)
        B = payload_bytes
        sync = PHASE_SYNC_US * 1e-6
        if op is Collective.ALL_REDUCE:
            return (self.tier_time("intra", Collective.REDUCE_SCATTER, m, B,
                                   flex=flex)
                    + self.tier_time("inter", Collective.ALL_REDUCE, n, B,
                                     flex=flex)
                    + self.tier_time("intra", Collective.ALL_GATHER, m,
                                     B / m, flex=flex)
                    + 2.0 * sync)
        if op is Collective.ALL_GATHER:
            # intra gather of the B shard, then the m*B node block crosses
            # the NIC tier once per remote node
            return (self.tier_time("intra", Collective.ALL_GATHER, m, B,
                                   flex=flex)
                    + self.tier_time("inter", Collective.ALL_GATHER, n,
                                     m * B, flex=flex)
                    + sync)
        if op is Collective.REDUCE_SCATTER:
            return (self.tier_time("intra", Collective.REDUCE_SCATTER, m, B,
                                   flex=flex)
                    + self.tier_time("inter", Collective.REDUCE_SCATTER, n,
                                     B, flex=flex)
                    + sync)
        raise ValueError(f"no hierarchical schedule for {op}")

    def _three_tier_time(self, op: Collective, payload_bytes: float, *,
                         flex: bool = True) -> float:
        """The 3-level chains of cluster/communicator.py (DESIGN.md §15).

        Payload conventions follow the 2-tier forms: B is the per-rank
        payload, each inter leg prices the *aggregate* payload its tier
        moves.  Dead tiers (size 1) cost 0 via tier_time, and only live
        hand-offs pay a phase barrier — so the formulas degrade to the
        live-tier chain, never charging phantom syncs."""
        m, n, p = self.m, self.topology.n_nodes, self.topology.n_pods
        B = payload_bytes
        sync = PHASE_SYNC_US * 1e-6
        live = sum(1 for s in (m, n, p) if s > 1)
        handoffs = max(live - 1, 0)
        if op is Collective.ALL_REDUCE:
            # down-chain RS per tier, AR on the 1/(m*n) shard at the pod
            # tier, then AG back up — 2 barriers per live hand-off
            return (self.tier_time("intra", Collective.REDUCE_SCATTER, m,
                                   B, flex=flex)
                    + self.tier_time("inter", Collective.REDUCE_SCATTER, n,
                                     B, flex=flex)
                    + self.tier_time("pod", Collective.ALL_REDUCE, p, B,
                                     flex=flex)
                    + self.tier_time("inter", Collective.ALL_GATHER, n,
                                     B / n, flex=flex)
                    + self.tier_time("intra", Collective.ALL_GATHER, m,
                                     B / m, flex=flex)
                    + 2.0 * handoffs * sync)
        if op is Collective.ALL_GATHER:
            return (self.tier_time("intra", Collective.ALL_GATHER, m, B,
                                   flex=flex)
                    + self.tier_time("inter", Collective.ALL_GATHER, n,
                                     m * B, flex=flex)
                    + self.tier_time("pod", Collective.ALL_GATHER, p,
                                     m * n * B, flex=flex)
                    + handoffs * sync)
        if op is Collective.REDUCE_SCATTER:
            return (self.tier_time("intra", Collective.REDUCE_SCATTER, m,
                                   B, flex=flex)
                    + self.tier_time("inter", Collective.REDUCE_SCATTER, n,
                                     B, flex=flex)
                    + self.tier_time("pod", Collective.REDUCE_SCATTER, p,
                                     B, flex=flex)
                    + handoffs * sync)
        raise ValueError(f"no hierarchical schedule for {op}")

    def flat_time(self, op: Collective, payload_bytes: float) -> float:
        """The flat single-ring baseline spanning every rank.

        All N ranks form one ring whose node-cut edges ride ONE rail
        each; every synchronized step is paced by that edge, so the ring
        runs at per-rail bandwidth with NIC step latency + switch hop on
        each of its steps.  On a 3-tier topology the ring also spans
        pods, so the pacing edge is the pod-cut spine uplink — strictly
        worse than a rail (oversubscribed DCN) — which is exactly why a
        flat ring dies at pod scale."""
        m, n, p = self.m, self.topology.n_nodes, self.topology.n_pods
        N = m * n * p
        if N <= 1:
            return 0.0
        if n <= 1 and p <= 1:
            return self.tier_time("intra", op, N, payload_bytes, flex=False)
        from repro_torch.core.topology import RingSchedule
        if p > 1:
            return self._flat_edge_time(
                op, N, payload_bytes, self.topology.pod_tier.link("spine"),
                self.topology.pod_uplinks, self.topology.pod_tier)
        rail = self.topology.nic_tier.link("rail")
        sched = RingSchedule(op, N)
        # one rail's slice of the class bandwidth, paced by the SICKEST
        # member: the flat ring is lockstep (every synchronized step waits
        # for its slowest node-cut edge) and cannot steer around a sick
        # rail — every rank's egress is pinned to its NIC — so a single
        # degraded member caps the whole ring, the same lockstep rule the
        # intra model applies to uniform member weights.  The hierarchical
        # schedule's NIC tier reroutes per instance instead.
        worst = min(m.health for m in rail.instances)
        per_rail_bw = (rail.effective_GBps * worst
                       / self.topology.nics_per_node)
        if per_rail_bw <= 0.0:
            # a dead rail pins the lockstep ring outright (member_time's
            # bw<=0 convention): flat is unusable, not a crash
            return float("inf")
        step_us = rail.step_latency_us + self.topology.nic_tier.inter_hop_us
        return (rail.fixed_overhead_us * 1e-6
                + sched.steps * step_us * 1e-6
                + sched.wire_bytes(payload_bytes) / (per_rail_bw * 1e9))

    def _flat_edge_time(self, op: Collective, N: int, payload_bytes: float,
                        link, uplinks: int, tier_profile) -> float:
        """Flat lockstep ring over N ranks paced by ONE instance of the
        given cut link — the same arithmetic flat_time applies to a rail,
        parameterized by the pacing edge (rail vs pod spine)."""
        from repro_torch.core.topology import RingSchedule
        sched = RingSchedule(op, N)
        worst = min(m.health for m in link.instances)
        per_edge_bw = link.effective_GBps * worst / max(uplinks, 1)
        if per_edge_bw <= 0.0:
            return float("inf")
        step_us = link.step_latency_us + tier_profile.inter_hop_us
        return (link.fixed_overhead_us * 1e-6
                + sched.steps * step_us * 1e-6
                + sched.wire_bytes(payload_bytes) / (per_edge_bw * 1e9))

    # -- expert-parallel all_to_all (DESIGN.md §15) ----------------------------

    def a2a_time(self, payload_bytes: float, *,
                 schedule: str = "rail_local", flex: bool = True) -> float:
        """MoE-dispatch all_to_all pricing for per-rank buffer
        ``payload_bytes``:

        * ``rail_local`` — the ep_all_to_all decomposition of
          cluster/communicator.py: intra shuffle (m ranks, B), then the
          rail-aligned NIC leg (n nodes, node-aggregate m*B), then the
          spine leg (p pods, pod-aggregate m*n*B), one phase barrier per
          live hand-off.  Each leg Stage-1 tunes its own tier
          (``flex=True``), so NIC traffic stays rail-aligned.
        * ``naive`` — same decomposition, but the cross-node legs are
          NOT rail-aligned: the NIC leg rides the cross-rail spine path
          (xrail) and the pod leg the cross-spine path, full payload.
        * ``flat`` — direct pairwise sends over the unscheduled fabric
          (what a flat device-mesh all_to_all lowers to): every rank
          ships its B/N slices straight to each peer, so each fabric
          level carries only its OWN cut's bytes and the levels overlap
          — completion is the max, not the sum, with no phase barriers.
          But nothing is rail-aligned: a remote rank usually lives on a
          DIFFERENT rail, so cross-node bytes take the cross-rail path
          and cross-pod bytes the cross-spine path.  Flat wins the
          latency-bound small-buffer regime on launch count alone; at
          bandwidth the unaligned cut paths lose to the rail-local
          decomposition's tuned tiers.
        """
        m, n, p = self.m, self.topology.n_nodes, self.topology.n_pods
        op = Collective.ALL_TO_ALL
        N = m * n * p
        if N <= 1 or payload_bytes <= 0:
            return 0.0
        B = payload_bytes
        if schedule == "flat":
            # per-tier payloads chosen so each tier's (k-1)/k ring egress
            # equals that cut's direct-send bytes: same-node slices are
            # B*m/N per rank, same-pod cross-node node-aggregates m*B/p,
            # cross-pod pod-aggregates m*n*B
            legs = [self.tier_time("intra", op, m, B * m / N, flex=False)]
            if n > 1:
                legs.append(self.inter.total_time(op, n, m * B / p,
                                                  {"xrail": 1.0}))
            if p > 1:
                legs.append(self.pod.total_time(op, p, m * n * B,
                                                {"xspine": 1.0}))
            return max(legs)
        sync = PHASE_SYNC_US * 1e-6
        handoffs = max(sum(1 for s in (m, n, p) if s > 1) - 1, 0)
        t = self.tier_time("intra", op, m, B, flex=flex)
        if schedule == "rail_local":
            t += self.tier_time("inter", op, n, m * B, flex=flex)
            if p > 1:
                t += self.tier_time("pod", op, p, m * n * B, flex=flex)
        elif schedule == "naive":
            if n > 1:
                t += self.inter.total_time(op, n, m * B, {"xrail": 1.0})
            if p > 1:
                t += self.pod.total_time(op, p, m * n * B, {"xspine": 1.0})
        else:
            raise ValueError(f"unknown a2a schedule {schedule!r}")
        return t + handoffs * sync

    def a2a_crossover_bytes(self, *, lo: int = 1 << 12, hi: int = 1 << 30,
                            flex: bool = True):
        """Smallest per-rank buffer (bytes, log2 grid) where the
        rail-local decomposition beats the flat all_to_all ring; None if
        it never does in [lo, hi]."""
        b = lo
        while b <= hi:
            if (self.a2a_time(b, schedule="rail_local", flex=flex)
                    < self.a2a_time(b, schedule="flat")):
                return b
            b *= 2
        return None

    # -- derived ---------------------------------------------------------------

    def algbw_GBps(self, op: Collective, payload_bytes: float, *,
                   schedule: str = "hierarchical",
                   flex: bool = True) -> float:
        t = (self.hierarchical_time(op, payload_bytes, flex=flex)
             if schedule == "hierarchical"
             else self.flat_time(op, payload_bytes))
        return (payload_bytes / t) / 1e9 if t > 0 else float("inf")

    def crossover_bytes(self, op: Collective, *,
                        lo: int = 1 << 12, hi: int = 1 << 30,
                        flex: bool = True) -> Optional[int]:
        """Smallest payload (bytes, log2 grid) where the hierarchical
        schedule beats the flat ring; None if it never does in [lo, hi];
        ``lo`` itself if it always does."""
        b = lo
        while b <= hi:
            if (self.hierarchical_time(op, b, flex=flex)
                    < self.flat_time(op, b)):
                return b
            b *= 2
        return None
