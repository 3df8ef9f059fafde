"""ClusterCommunicator — hierarchical collectives over the fabric's tiers
(DESIGN.md §9).

Port of ``src/repro/cluster/communicator.py``.  One
:class:`~repro_torch.core.communicator.FlexCommunicator` per fabric tier:
the *intra* tier on the in-node mesh axis (the paper's FlexLink pool) and
the *inter* tier on the node axis (the NIC pool of ``cluster/topology.py``).
A cluster collective is a composition of ordinary flex collectives, one
RoutePlan per tier, each run by that tier's ``routing.execute`` on this
rank's process groups of its axis, so the PlanCache, ``plan_signature()``
and the per-tier SlotControllers apply unchanged, and each tier's staged
ring runs the accumulate kernel (K1) on sub-32-bit float payloads.

Compositions (m ranks a node, n nodes), on this rank's plain tensors:

  all_reduce     : pad the flat payload to a multiple of m, reduce_scatter
                   it as [m, L / m] on the intra tier (the reference's
                   blocks; its 1-D form would give the routes one padded
                   column), all_reduce the 1/m shard on the inter tier,
                   all_gather back on the intra tier, unpad.
  all_gather     : each tier's all_gather with ``tiled=False`` inward-out,
                   then reshaped outermost-major: the flat gather over
                   (node, intra).
  reduce_scatter : chained per-tier reduce_scatter; rank (node, i) ends
                   with global segment ``i * n + node``.

With a single live tier every call IS that communicator's call: same
plans, same signatures.  The constructor takes the pod tier's
communicator and validates it as the reference does, but nothing builds
one until the pod tier (ROADMAP queue 1 item 14), which also brings the
rail-local ``ep_all_to_all`` decomposition.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.cluster.topology import ClusterTopology
from repro_torch.control.slots import SlotController
from repro_torch.core.communicator import FlexCommunicator
from repro_torch.core.topology import Collective


class ClusterCommunicator:
    """Hierarchical collectives over (intra_axis × node_axis).

    Not itself a FlexCommunicator: it owns one per tier and composes
    them.  ``comms()`` exposes the live tier communicators innermost
    first so ctx-level plumbing (program recorders, tuning profiles,
    reports) treats the cluster as ordinary communicators.
    """

    def __init__(self, topology: ClusterTopology,
                 intra: Optional[FlexCommunicator],
                 inter: Optional[FlexCommunicator],
                 pod: Optional[FlexCommunicator] = None):
        if intra is None and inter is None and pod is None:
            raise ValueError("cluster needs at least one live tier")
        if inter is not None and inter.n_ranks != topology.n_nodes:
            raise ValueError(
                f"inter tier spans {inter.n_ranks} ranks but topology has "
                f"{topology.n_nodes} nodes")
        if pod is not None and pod.n_ranks != topology.n_pods:
            raise ValueError(
                f"pod tier spans {pod.n_ranks} ranks but topology has "
                f"{topology.n_pods} pods")
        self.topology = topology
        self.intra = intra
        self.inter = inter
        self.pod = pod

    # -- structure -------------------------------------------------------------

    @property
    def hierarchical(self) -> bool:
        """True when a collective actually decomposes across tiers."""
        return len(self.comms()) > 1

    @property
    def n_ranks(self) -> int:
        r = 1
        for c in self.comms():
            r *= c.n_ranks
        return r

    def comms(self) -> Tuple[FlexCommunicator, ...]:
        """Live tier communicators, innermost (fastest fabric) first."""
        return tuple(c for c in (self.intra, self.inter, self.pod)
                     if c is not None)

    # -- collectives (every rank of every live tier calls them alike) ----------

    def all_reduce(self, x: torch.Tensor, accumulate=None) -> torch.Tensor:
        tiers = self.comms()
        if len(tiers) == 1:
            return tiers[0].all_reduce(x, accumulate)
        down, top = tiers[:-1], tiers[-1]
        k = 1
        for c in down:
            k *= c.n_ranks
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % k
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        # [k, L / k]: the same blocks as the reference's 1-D payload, but a
        # reduce-scatter splits its columns over the routes; a 1-D payload
        # is one column, which the column partition pads to the plan grain
        # (CHUNK_GRID x the bytes) with every real element on the primary
        shard = flat.reshape(k, -1)
        for c in down:
            shard = c.reduce_scatter(shard, accumulate)   # [k / prod, L / k]
        red = top.all_reduce(shard, accumulate)
        for c in reversed(down):
            red = c.all_gather(red, tiled=True)           # back to [k, L / k]
        red = red.reshape(-1)
        if pad:
            red = red[:-pad]
        return red.reshape(x.shape)

    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        tiers = self.comms()
        if len(tiers) == 1:
            return tiers[0].all_gather(x, tiled=tiled)
        g = x
        for c in tiers:
            g = c.all_gather(g, tiled=False)   # prepend that tier's axis
        stacked = g.reshape((self.n_ranks,) + tuple(x.shape))
        if not tiled:
            return stacked
        if x.ndim:
            return stacked.reshape((self.n_ranks * x.shape[0],)
                                   + tuple(x.shape[1:]))
        return stacked.reshape(-1)

    def reduce_scatter(self, x: torch.Tensor,
                       accumulate=None) -> torch.Tensor:
        """Leading dim must divide the cluster rank count.  Rank (node, i)
        receives global segment ``i * n + node`` of the flat reduction."""
        tiers = self.comms()
        if len(tiers) == 1:
            return tiers[0].reduce_scatter(x, accumulate)
        if x.shape[0] % self.n_ranks != 0:
            raise ValueError(
                f"leading dim {x.shape[0]} must divide the cluster rank "
                f"count {self.n_ranks}")
        out = x
        for c in tiers:
            out = c.reduce_scatter(out, accumulate)
        return out

    def ep_all_to_all(self, x: torch.Tensor, split_axis: int = 0,
                      concat_axis: int = 0) -> torch.Tensor:
        """Expert all_to_all over the tiers.  With one live tier it is
        that tier's flex all_to_all; the rail-local decomposition across
        tiers comes with the pod tier."""
        tiers = self.comms()
        if len(tiers) == 1:
            return tiers[0].all_to_all(x, split_axis, concat_axis)
        raise NotImplementedError(
            "the rail-local ep_all_to_all across cluster tiers is not "
            "ported yet (ROADMAP queue 1 item 14)")

    # -- control-plane plumbing ------------------------------------------------

    def plan_signature(self) -> Tuple:
        return tuple((c.axis_name, c.plan_signature()) for c in self.comms())

    def a2a_report(self) -> Dict[str, object]:
        """The ``a2a`` block of the cluster report: where expert-dispatch
        bytes actually went.  Rail-local bytes are the node leg's
        rail-share of its logged all_to_all payload; spine bytes are the
        rest of the node leg plus everything the pod leg moved.  When no
        replay log exists the slot footprint prices one bucket-sized call
        per touched slot instead, flagged ``"estimated"``."""
        out: Dict[str, object] = {
            "rail_local_bytes": 0, "spine_bytes": 0, "intra_bytes": 0,
            "rail_balance": None, "source": "replay",
        }
        legs = [("intra", self.intra), ("inter", self.inter),
                ("pod", self.pod)]
        estimated = False
        for tier, comm in legs:
            if comm is None:
                continue
            total = comm.replayed_bytes(Collective.ALL_TO_ALL)
            if total == 0:
                buckets = comm.touched_buckets(Collective.ALL_TO_ALL)
                if buckets:
                    total = sum(buckets)
                    estimated = True
            if total == 0:
                continue
            if tier == "intra":
                out["intra_bytes"] += total
                continue
            if tier == "pod":
                # every cross-pod byte rides the spine by definition
                out["spine_bytes"] += total
                continue
            # the node leg: split by the tuned rail-vs-spine fractions,
            # bucket by bucket, and report the rail member balance
            rail_frac_total = 0.0
            weight = 0
            primary = comm.profile.primary.name
            for (op, bucket), sc in comm._slots.items():
                if op is not Collective.ALL_TO_ALL:
                    continue
                fr = sc.fractions().get(primary, 0.0)
                rail_frac_total += fr * bucket
                weight += bucket
                weights = sc.member_weights().get(primary)
                if weights:
                    w = list(weights.values())
                    hi = max(w)
                    out["rail_balance"] = (min(w) / hi) if hi else None
            frac = (rail_frac_total / weight) if weight else 1.0
            rail = int(total * frac)
            out["rail_local_bytes"] += rail
            out["spine_bytes"] += total - rail
        if estimated:
            out["source"] = "estimated"
        return out

    def summary(self) -> Dict[str, object]:
        """Topology + cross-tier rollup + a2a accounting — what
        ``ctx.comm_report()`` embeds (each tier communicator's full report
        already sits under its axis key there)."""
        return {
            "topology": self.topology.describe(),
            "rollup": SlotController.rollup(
                sc for c in self.comms() for sc in c.slot_controllers()),
            "a2a": self.a2a_report(),
        }

    def report(self) -> Dict[str, object]:
        """Standalone full report: per-tier blocks plus the summary."""
        out = self.summary()
        out["tiers"] = {c.profile.tier: c.report() for c in self.comms()}
        return out
