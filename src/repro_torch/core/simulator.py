# Copied from src/repro/core/simulator.py; only the imports are renamed.
"""Analytic path-timing simulator.

On real hardware, FlexLink's Stage-1 tuner drives a ~10 s profiling loop that
*measures* per-path completion times (Algorithm 1 line 11,
``MeasurePathTimings``).  This container has no H800 and no TPU, so the
measurement oracle is an analytic ring-timing model:

    t_path(share) = fixed_overhead
                  + steps(op, N) * step_latency(path, op)
                  + wire_bytes(op, N, share * B) / effective_bw(path, op, N)

and a collective's completion time is ``max`` over active paths, because the
paths run concurrently and the operation finishes when the slowest share
lands (paper §3.2: "the overall communication time is dictated by the
slowest link").

Calibration discipline (this is what makes the reproduction honest):

* The **primary-path** (NVLink) constants are least-squares fitted to the
  *NCCL baseline column only* of the paper's Table 2 — the numbers FlexLink
  itself is compared against.
* The **secondary-path** (PCIe / RDMA) constants come from the hardware DB
  (``links.py``) plus two physically-motivated op modifiers; they are never
  fitted to FlexLink's own results.
* FlexLink's improvements and load splits are then *predicted* by running
  Algorithm 1 against this model and compared to Table 2 in
  ``benchmarks/table2_bandwidth.py``.

Secondary-path op modifiers (both argued in the paper):
  - ring all_reduce serializes recv→reduce→send per step, which the
    double-buffered host pipeline cannot hide (paper §6 plans "increasing the
    pipeline depth for the ReduceScatter part to reduce potential bubbles
    caused by reduce sum computation") → step latency is multiplied by
    ``AR_STEP_PENALTY`` on non-primary paths;
  - reduce_scatter pays half of that (one reduce per step, no second phase).

Concurrency (DESIGN.md §11): every timing entry point takes a ``contention``
factor — the number of plans in flight on the fabric when the call runs.
Overlapping transfers on a shared link split its bandwidth by active-plan
demand, so every wire term is priced at ``bw / contention`` while latency
terms (launch overhead, ring-step sync) are unchanged: latency is per-plan
state machinery, not a shared resource.  The member-aware path prices each
instance at its 1/n_members slice of the *contended* class bandwidth.  The
serial case ``contention=1.0`` divides by exactly 1.0 — bitwise identity,
same rng stream — which is what keeps all pre-overlap plan signatures,
Stage-1 trajectories and tuning caches byte-identical (the §10 parity
discipline, extended to time).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.codecs import PayloadCodec
from repro_torch.core.links import LinkMember, LinkSpec, NodeProfile, PROFILES
from repro_torch.core.topology import Collective, RingSchedule

MiB = 1024 * 1024

# ---------------------------------------------------------------------------
# Paper Table 2 — NCCL baseline algorithm bandwidth (GB/s).  Keys:
# (collective, n_gpus, message_MiB).  Used (a) to calibrate the primary path,
# (b) by benchmarks to report prediction error.
# ---------------------------------------------------------------------------
NCCL_BASELINE_GBPS: Dict[Tuple[Collective, int, int], float] = {
    (Collective.ALL_REDUCE, 2, 32): 112.0,
    (Collective.ALL_REDUCE, 2, 64): 128.0,
    (Collective.ALL_REDUCE, 2, 128): 132.0,
    (Collective.ALL_REDUCE, 2, 256): 139.0,
    (Collective.ALL_REDUCE, 4, 32): 87.0,
    (Collective.ALL_REDUCE, 4, 64): 90.0,
    (Collective.ALL_REDUCE, 4, 128): 94.0,
    (Collective.ALL_REDUCE, 4, 256): 98.0,
    (Collective.ALL_REDUCE, 8, 256): 107.0,
    (Collective.ALL_GATHER, 2, 32): 103.0,
    (Collective.ALL_GATHER, 2, 64): 117.0,
    (Collective.ALL_GATHER, 2, 128): 129.0,
    (Collective.ALL_GATHER, 2, 256): 132.0,
    (Collective.ALL_GATHER, 4, 32): 43.0,
    (Collective.ALL_GATHER, 4, 64): 46.0,
    (Collective.ALL_GATHER, 4, 128): 48.0,
    (Collective.ALL_GATHER, 4, 256): 49.0,
    (Collective.ALL_GATHER, 8, 32): 20.0,
    (Collective.ALL_GATHER, 8, 64): 21.0,
    (Collective.ALL_GATHER, 8, 128): 21.0,
    (Collective.ALL_GATHER, 8, 256): 21.0,
}

# Paper Table 2 — FlexLink (PCIe+RDMA) improvement % — the *target* our
# predictions are validated against (never used for calibration).
FLEXLINK_IMPROVEMENT_PCT: Dict[Tuple[Collective, int, int], float] = {
    (Collective.ALL_REDUCE, 2, 32): 20.0,
    (Collective.ALL_REDUCE, 2, 64): 17.0,
    (Collective.ALL_REDUCE, 2, 128): 25.0,
    (Collective.ALL_REDUCE, 2, 256): 26.0,
    (Collective.ALL_REDUCE, 4, 32): 2.0,
    (Collective.ALL_REDUCE, 4, 64): 10.0,
    (Collective.ALL_REDUCE, 4, 128): 17.0,
    (Collective.ALL_REDUCE, 4, 256): 20.0,
    (Collective.ALL_REDUCE, 8, 256): 2.0,
    (Collective.ALL_GATHER, 2, 32): 22.0,
    (Collective.ALL_GATHER, 2, 64): 21.0,
    (Collective.ALL_GATHER, 2, 128): 19.0,
    (Collective.ALL_GATHER, 2, 256): 22.0,
    (Collective.ALL_GATHER, 4, 32): 21.0,
    (Collective.ALL_GATHER, 4, 64): 24.0,
    (Collective.ALL_GATHER, 4, 128): 25.0,
    (Collective.ALL_GATHER, 4, 256): 27.0,
    (Collective.ALL_GATHER, 8, 32): 20.0,
    (Collective.ALL_GATHER, 8, 64): 24.0,
    (Collective.ALL_GATHER, 8, 128): 19.0,
    (Collective.ALL_GATHER, 8, 256): 24.0,
}

#: step-latency multiplier on non-primary paths for ring all_reduce (the
#: recv→reduce→send serialization the double buffer can't hide).
AR_STEP_PENALTY = 2.0
RS_STEP_PENALTY = 1.5


@dataclasses.dataclass(frozen=True)
class CalibratedPrimary:
    """Fitted primary-path model for one (collective, n_ranks)."""

    effective_GBps: float
    per_op_latency_s: float  # total latency term (steps folded in)


def _fit_primary(op: Collective, n: int) -> Optional[CalibratedPrimary]:
    """Least-squares fit of t = lat + wire_bytes/bw to the baseline column."""
    pts = [(mib, bw) for (c, nn, mib), bw in NCCL_BASELINE_GBPS.items()
           if c is op and nn == n]
    if not pts:
        return None
    sched = RingSchedule(op, n)
    rows, ts = [], []
    for mib, algbw in pts:
        payload = mib * MiB
        t = payload / (algbw * 1e9)
        rows.append([1.0, sched.wire_bytes(payload)])
        ts.append(t)
    a = np.asarray(rows)
    t = np.asarray(ts)
    if len(pts) == 1:
        # Single point (8-GPU AllReduce row): assume the 4-GPU latency,
        # solve bandwidth.
        base = _fit_primary(op, 4)
        lat = base.per_op_latency_s if base else 0.0
        bw = a[0, 1] / max(t[0] - lat, 1e-9)
        return CalibratedPrimary(bw / 1e9, lat)
    sol, *_ = np.linalg.lstsq(a, t, rcond=None)
    lat, inv_bw = float(sol[0]), float(sol[1])
    lat = max(lat, 0.0)
    bw = 1.0 / max(inv_bw, 1e-15)
    return CalibratedPrimary(bw / 1e9, lat)


class PathTimingModel:
    """MeasurePathTimings oracle for a node profile.

    ``shares`` map path-name -> fraction of the payload (sum <= 1; the
    communicator guarantees sum == 1 over active paths).
    """

    def __init__(self, profile: NodeProfile | str = "h800",
                 noise: float = 0.0, seed: int = 0,
                 secondary_algo: str = "ring"):
        self.profile = PROFILES[profile] if isinstance(profile, str) else profile
        self.noise = noise
        self.secondary_algo = secondary_algo
        self._rng = np.random.default_rng(seed)
        self._primary_fit: Dict[Tuple[Collective, int], CalibratedPrimary] = {}

    # -- primary calibration ------------------------------------------------
    def _primary(self, op: Collective, n: int) -> CalibratedPrimary:
        key = (op, n)
        if key not in self._primary_fit:
            # Table-2 calibration only applies to the machine it came from.
            fit = _fit_primary(op, n) if self.profile.name == "h800" else None
            if fit is None:
                # No baseline row (e.g. reduce_scatter, or TPU profile, or
                # a cluster NIC tier): fall back to hardware-DB constants.
                # Inter-node profiles pay the switch-traversal hop on every
                # ring step (links.NodeProfile.inter_hop_us).
                link = self.profile.primary
                sched = RingSchedule(op, n)
                step_us = link.step_latency_us + self.profile.inter_hop_us
                fit = CalibratedPrimary(
                    link.effective_GBps,
                    sched.steps * step_us * 1e-6
                    + link.fixed_overhead_us * 1e-6)
            self._primary_fit[key] = fit
        return self._primary_fit[key]

    def secondary_algo_cost(self, op: Collective, n: int):
        """(steps, wire_factor(payload)) for the secondary-path algorithm.

        "ring" is the paper's design; "tree" (recursive doubling, paper §6
        future work) costs log2(N) steps but ships the full payload each
        step — it wins exactly where ring AllReduce dies of latency."""
        import math as _m
        if self.secondary_algo == "tree" and op is Collective.ALL_REDUCE \
                and n & (n - 1) == 0 and n > 1:
            steps = int(_m.log2(n))
            return steps, lambda b: b * steps
        sched = RingSchedule(op, n)
        return sched.steps, sched.wire_bytes

    def _secondary_step_latency(self, link: LinkSpec, op: Collective,
                                n_ranks: int) -> float:
        # Per-rank sync cost scales with the ring size: a host-mediated step
        # completes when the slowest of N chunk handoffs lands (see
        # LinkSpec.step_latency_us).
        lat = link.step_latency_us * 1e-6 * n_ranks
        if op is Collective.ALL_REDUCE:
            lat *= AR_STEP_PENALTY
        elif op is Collective.REDUCE_SCATTER:
            lat *= RS_STEP_PENALTY
        # inter-node tiers add a fixed switch-traversal hop per step — it
        # does not scale with the ring size (one spine crossing per step,
        # regardless of how many NIC handoffs synchronize behind it).
        return lat + self.profile.inter_hop_us * 1e-6

    # -- per-path timing -----------------------------------------------------
    def path_time(self, link_name: str, op: Collective, n_ranks: int,
                  payload_bytes: float, share: float,
                  contention: float = 1.0,
                  codec: Optional[PayloadCodec] = None) -> float:
        """Completion time (s) for `share` of the payload on one path.
        ``contention`` divides the link bandwidth by the in-flight plan
        demand; 1.0 is the bitwise-identical serial case.  ``codec``
        (secondary paths only; DESIGN.md §12) prices the transfer at WIRE
        bytes — logical bytes scaled by the codec's ratio — plus the
        codec's setup + throughput term; the primary path ignores it (the
        lossless NVLink contract).  ``codec=None`` runs the exact
        historical arithmetic."""
        if share <= 0.0:
            return 0.0
        link = self.profile.link(link_name)
        sched = RingSchedule(op, n_ranks)
        wire = sched.wire_bytes(share * payload_bytes)
        if link.is_primary:
            fit = self._primary(op, n_ranks)
            bw = fit.effective_GBps / contention
            return fit.per_op_latency_s + wire / (bw * 1e9)
        steps, wire_fn = self.secondary_algo_cost(op, n_ranks)
        wire = wire_fn(share * payload_bytes)
        lat = self._secondary_step_latency(link, op, n_ranks)
        if self.secondary_algo == "tree" and op is Collective.ALL_REDUCE:
            lat = lat / AR_STEP_PENALTY  # butterfly has no serialized
            # recv->reduce->forward chain; each step is a paired exchange
        bw = link.effective_GBps / contention
        t_codec = 0.0
        if codec is not None:
            t_codec = codec.codec_time_s(wire)   # process the logical bytes
            wire = codec.wire_bytes(wire)        # ...but ship wire bytes
        t = (link.fixed_overhead_us * 1e-6 + steps * lat
             + wire / (bw * 1e9) + t_codec)
        return t

    # -- per-instance timing ---------------------------------------------------

    def _member_split(self, link: LinkSpec,
                      member_weights: Optional[Mapping[str, Mapping[str, float]]]
                      ) -> Optional[Dict[str, float]]:
        """The member weight vector a link's class share subdivides by, or
        None for a link whose instances need no individual pricing.

        A link is *member-treated* when its instances can diverge: some
        member is unhealthy, or the caller supplied a non-uniform weight
        vector (a Stage-2 drain in progress).  Uniform healthy members are
        deliberately NOT treated — the class computation below then runs
        the exact pre-member code path (same float ops, same noise draws),
        which is what makes the parity contract of DESIGN.md §10 bitwise
        rather than approximate: equal members finish simultaneously, so
        the class aggregate IS the member timing.
        """
        if link.n_members <= 1 and link.healthy:
            return None
        given = (member_weights or {}).get(link.name)
        if given is not None:
            w = {m: float(given.get(m, 0.0)) for m in link.member_names}
        else:
            # health-proportional default: the subdivision the control
            # plane itself initializes (split_by_health), fraction-exact
            w = {m.name: m.health for m in link.instances}
        if sum(w.values()) <= 0.0:
            return None
        vals = list(w.values())
        if link.healthy and all(v == vals[0] for v in vals):
            return None
        return w

    def member_time(self, link: LinkSpec, member: LinkMember, op: Collective,
                    n_ranks: int, payload_bytes: float, member_share: float,
                    bw_scale: float = 1.0,
                    contention: float = 1.0,
                    codec: Optional[PayloadCodec] = None) -> float:
        """Completion time (s) for ``member_share`` of the payload on ONE
        instance: the class's latency structure at a 1/n_members slice of
        the class bandwidth, scaled by the instance's health (and by the
        PCIe-switch ``bw_scale`` when the class sits behind the switch).
        ``contention`` divides the instance's slice by the in-flight plan
        demand — concurrent plans contend per member, not just per class.
        ``codec`` prices secondary-path wire bytes at the codec's ratio
        plus its encode/decode term (primary instances ignore it)."""
        if member_share <= 0.0:
            return 0.0
        if link.is_primary:
            fit = self._primary(op, n_ranks)
            sched = RingSchedule(op, n_ranks)
            wire = sched.wire_bytes(member_share * payload_bytes)
            bw = (fit.effective_GBps / link.n_members * member.health
                  * bw_scale) / contention
            if bw <= 0.0:
                return float("inf")
            return fit.per_op_latency_s + wire / (bw * 1e9)
        steps, wire_fn = self.secondary_algo_cost(op, n_ranks)
        wire = wire_fn(member_share * payload_bytes)
        lat = self._secondary_step_latency(link, op, n_ranks)
        if self.secondary_algo == "tree" and op is Collective.ALL_REDUCE:
            lat = lat / AR_STEP_PENALTY
        bw = (link.effective_GBps / link.n_members * member.health
              * bw_scale) / contention
        if bw <= 0.0:
            return float("inf")
        t_codec = 0.0
        if codec is not None:
            t_codec = codec.codec_time_s(wire)
            wire = codec.wire_bytes(wire)
        return (link.fixed_overhead_us * 1e-6 + steps * lat
                + wire / (bw * 1e9) + t_codec)

    def measure(self, op: Collective, n_ranks: int, payload_bytes: float,
                shares: Mapping[str, float],
                member_weights: Optional[Mapping[str, Mapping[str, float]]]
                = None, contention: float = 1.0,
                codecs: Optional[Mapping[str, PayloadCodec]] = None
                ) -> Dict[str, float]:
        """Algorithm 1's MeasurePathTimings: per-path completion times (s).

        ``shares`` are keyed by link (class) name.  ``member_weights``
        optionally subdivides a class share across its instances (integer
        or float weights; defaults to health-proportional for unhealthy
        links).  Member-treated links (see :meth:`_member_split`) report
        the class completion as the max over instances and add one entry
        per member name, which is what the control plane's per-instance
        balancers consume.  Uniform healthy fabrics take the historical
        class-only path — bit-identical output, same rng stream.

        ``contention`` is the in-flight plan demand (DESIGN.md §11): every
        wire term is priced at ``bw / contention`` (the PCIe-switch ceiling
        is NOT re-scaled — k plans at 1/k bandwidth present the same
        instantaneous switch demand as one).  The default 1.0 divides by
        exactly one: bitwise-identical to the serial pricing.

        ``codecs`` optionally maps link name -> PayloadCodec (DESIGN.md
        §12): that link's wire term is priced at codec-scaled bytes plus
        the codec's setup/throughput cost.  Primary links never receive a
        codec (``codecs_for_pricing`` excludes them), and the switch-demand
        computation is deliberately NOT codec-scaled — the instantaneous
        GBps a link presents to the switch is its line rate regardless of
        how few bytes the codec ships.  ``codecs=None`` (and ``{}``) runs
        the exact historical arithmetic.
        """
        out: Dict[str, float] = {}
        splits: Dict[str, Dict[str, float]] = {}
        for name, share in shares.items():
            if share > 0.0:
                w = self._member_split(self.profile.link(name),
                                       member_weights)
                if w is not None:
                    splits[name] = w
        # PCIe-switch contention: contending paths jointly capped (Table 1).
        ceiling = self.profile.pcie_switch_ceiling_GBps
        contended = {l.name for l in self.profile.links if l.shares_pcie_switch}
        demand = 0.0
        if ceiling is not None:
            for name in contended:
                if shares.get(name, 0.0) > 0.0:
                    link = self.profile.link(name)
                    if name in splits:
                        # the class's deliverable bandwidth is the sum over
                        # its ACTIVE instances (a drained-to-zero member
                        # stops contending; a degraded one contends at its
                        # reduced rate)
                        demand += sum(
                            link.effective_GBps / link.n_members * m.health
                            for m in link.instances
                            if splits[name].get(m.name, 0.0) > 0.0)
                    else:
                        demand += link.effective_GBps
        scale = 1.0
        if ceiling is not None and demand > ceiling:
            scale = ceiling / demand
        for name, share in shares.items():
            codec = (codecs or {}).get(name)
            if name in splits and share > 0.0:
                link = self.profile.link(name)
                w = splits[name]
                wsum = sum(w.values())
                bw_scale = scale if name in contended else 1.0
                times = {
                    m.name: self.member_time(
                        link, m, op, n_ranks, payload_bytes,
                        share * w.get(m.name, 0.0) / wsum, bw_scale,
                        contention=contention, codec=codec)
                    for m in link.instances}
                t = max(times.values())
                mult = 1.0
                if self.noise > 0.0:
                    mult = float(1.0 + self._rng.normal(0.0, self.noise))
                if link.n_members > 1:
                    for mn, mt in times.items():
                        out[mn] = max(mt * mult, 0.0)
                out[name] = max(t * mult, 0.0)
                continue
            t = self.path_time(name, op, n_ranks, payload_bytes, share,
                               contention=contention, codec=codec)
            if name in contended and scale < 1.0 and share > 0.0:
                link = self.profile.link(name)
                steps, wire_fn = self.secondary_algo_cost(op, n_ranks)
                wire = wire_fn(share * payload_bytes)
                bw = link.effective_GBps * scale / contention
                lat = self._secondary_step_latency(link, op, n_ranks)
                if self.secondary_algo == "tree" \
                        and op is Collective.ALL_REDUCE:
                    # same butterfly discount path_time (and member_time)
                    # apply — the contended recompute must price the
                    # identical algorithm, just at the capped bandwidth
                    lat = lat / AR_STEP_PENALTY
                t_codec = 0.0
                if codec is not None:
                    t_codec = codec.codec_time_s(wire)
                    wire = codec.wire_bytes(wire)
                t = (link.fixed_overhead_us * 1e-6 + steps * lat
                     + wire / (bw * 1e9) + t_codec)
            if self.noise > 0.0 and share > 0.0:
                t *= float(1.0 + self._rng.normal(0.0, self.noise))
            out[name] = max(t, 0.0)
        return out

    # -- collective-level results --------------------------------------------
    def total_time(self, op: Collective, n_ranks: int, payload_bytes: float,
                   shares: Mapping[str, float],
                   member_weights: Optional[Mapping[str, Mapping[str, float]]]
                   = None, contention: float = 1.0,
                   codecs: Optional[Mapping[str, PayloadCodec]] = None
                   ) -> float:
        times = self.measure(op, n_ranks, payload_bytes, shares,
                             member_weights=member_weights,
                             contention=contention, codecs=codecs)
        active = [t for name, t in times.items() if shares.get(name, 0.0) > 0]
        return max(active) if active else 0.0

    def algbw_GBps(self, op: Collective, n_ranks: int, payload_bytes: float,
                   shares: Mapping[str, float],
                   member_weights: Optional[Mapping[str, Mapping[str, float]]]
                   = None, contention: float = 1.0,
                   codecs: Optional[Mapping[str, PayloadCodec]] = None
                   ) -> float:
        t = self.total_time(op, n_ranks, payload_bytes, shares,
                            member_weights=member_weights,
                            contention=contention, codecs=codecs)
        return (payload_bytes / t) / 1e9 if t > 0 else float("inf")

    # -- codec selection ------------------------------------------------------
    def choose_codecs(self, op: Collective, n_ranks: int,
                      payload_bytes: float,
                      candidates: Mapping[str, PayloadCodec],
                      fracs: Optional[Mapping[str, float]] = None
                      ) -> Dict[str, str]:
        """Pick, per secondary link, whether the candidate codec PAYS.

        A codec is kept only when the path finishes strictly faster with it
        than without — wire-byte savings vs the codec's setup + throughput
        cost (DESIGN.md §12).  Tiny messages lose to setup_s and never
        compress; the primary path never appears (``candidates`` comes
        from codecs_for_pricing, which excludes it).  Returns
        {link_name: codec_name} for the winners only.

        ``fracs`` evaluates each path at its actual share instead of the
        full payload — the post-tune refinement pass: a codec that pays on
        the whole message can lose on the slice the tuner actually routed
        there (the setup term grows relative to the transfer), so the
        caller re-chooses at the converged fractions and re-tunes until
        the set is stable.
        """
        chosen: Dict[str, str] = {}
        for name, codec in candidates.items():
            if codec is None or self.profile.link(name).is_primary:
                continue
            frac = fracs.get(name, 1.0) if fracs is not None else 1.0
            plain = self.path_time(name, op, n_ranks, payload_bytes, frac)
            coded = self.path_time(name, op, n_ranks, payload_bytes, frac,
                                   codec=codec)
            if coded < plain:
                chosen[name] = codec.name
        return chosen

    def nccl_baseline_GBps(self, op: Collective, n_ranks: int,
                           payload_bytes: float) -> float:
        """Single-path (primary-only) algorithm bandwidth."""
        shares = {self.profile.primary.name: 1.0}
        return self.algbw_GBps(op, n_ranks, payload_bytes, shares)
