# Copied from src/repro/core/links.py; only the imports are renamed.
"""Link specifications and the hardware database.

A *link class* is one physically (or logically) distinct route that a collective
can push payload over.  On the paper's H800 node these are NVLink, the
host-staged PCIe path and the intra-node RDMA NIC path; on our TPU v5e target
they are the primary-axis ICI ring, the orthogonal-axis ICI detour, the host
PCIe DMA path and the DCN (pod-axis) NICs.

All bandwidth numbers are *bidirectional* GB/s at the hardware level, matching
Table 1 of the paper; ``effective_GBps`` is the achievable unidirectional
collective-payload bandwidth used by the timing simulator (calibrated once
against the paper's NCCL baseline column, never against FlexLink's results —
see ``simulator.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class LinkKind(enum.Enum):
    """Physical class of a communication route."""

    NVLINK = "nvlink"          # GPU primary fabric
    PCIE = "pcie"              # host-staged PCIe path
    RDMA = "rdma"              # intra-node NIC path (NVSHMEM in the paper)
    ICI_PRIMARY = "ici"        # TPU: torus links along the collective's axis
    ICI_ORTHO = "ici_ortho"    # TPU: idle orthogonal-axis torus links
    HOST_PCIE = "host_pcie"    # TPU: chip<->host DMA
    DCN = "dcn"                # TPU: pod-axis data-center network
    NIC_RAIL = "nic_rail"      # inter-node tier: rail-aligned RDMA NICs —
    #                            the primary fabric of the NIC tier
    #                            (repro.cluster, DESIGN.md §9)
    DCN_SPINE = "dcn_spine"    # pod tier: the cross-pod spine uplinks —
    #                            the primary fabric of the pod/DCN tier
    #                            (repro.cluster, DESIGN.md §15)


#: Link kinds that count as the "primary" path (NVLink-centric logic in
#: Algorithm 1 favors these).  NIC_RAIL is the primary of the *inter-node*
#: tier, DCN_SPINE of the *pod* tier: within each tier the tier's fast
#: fabric plays the role NVLink plays inside the box.
PRIMARY_KINDS = frozenset({LinkKind.NVLINK, LinkKind.ICI_PRIMARY,
                           LinkKind.NIC_RAIL, LinkKind.DCN_SPINE})


@dataclasses.dataclass(frozen=True)
class LinkMember:
    """One physical *instance* of a link class — one NIC rail, one PCIe leg.

    ``health`` scales this instance's share of the class's effective (and
    raw) bandwidth: 1.0 is nominal, 0.25 is a rail degraded to a quarter of
    its lane rate (flapping optics, a mis-trained SerDes, a congested leaf).
    The class-level numbers of :class:`LinkSpec` stay the *aggregate over
    healthy members*; a member's bandwidth is ``effective_GBps / n_members
    * health``.
    """

    name: str
    health: float = 1.0


def split_by_health(members: Sequence[LinkMember], total: int) -> Dict[str, int]:
    """Largest-remainder split of ``total`` integer units across members,
    proportional to their health factors.

    This is the deterministic member subdivision of a class share: uniform
    healthy members get an exactly equal split (the parity case — with
    ``total`` divisible by the member count there is no remainder at all),
    a degraded member gets proportionally less — the Stage-1-level drain.
    """
    weights = [max(m.health, 0.0) for m in members]
    denom = sum(weights)
    if denom <= 0.0:
        weights = [1.0] * len(members)
        denom = float(len(members))
    exact = [total * w / denom for w in weights]
    units = [int(e) for e in exact]
    rem = total - sum(units)
    order = sorted(range(len(members)),
                   key=lambda i: (-(exact[i] - units[i]), i))
    for i in order[:rem]:
        units[i] += 1
    return {m.name: u for m, u in zip(members, units)}


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One aggregatable route.

    Attributes:
      name: unique route name within a node profile.
      kind: physical class.
      raw_GBps: bidirectional hardware bandwidth (Table-1 style).
      effective_GBps: achievable unidirectional collective payload bandwidth.
      step_latency_us: per-ring-step *per-rank* latency (sync + launch +
        first-byte).  The simulator scales it by the ring size N — each
        host-mediated step completes when the slowest of N chunk handoffs
        lands, and that straggler tail grows with N.  This N-scaling is what
        kills secondary paths for 8-GPU AllReduce (2(N-1)=14 sequential
        steps × 8-rank sync each) in the paper's Table 2 while leaving 2-GPU
        AllReduce with +20%.
      fixed_overhead_us: one-time per-collective setup cost.
      shares_pcie_switch: True when the route contends with the host PCIe path
        (H800-generation "path contention" in Table 1); the simulator caps the
        *sum* of contending routes at the PCIe interface bandwidth.
      members: the link's physical *instances* (per-rail NICs, PCIe legs).
        Empty = one implicit instance named after the link — every
        pre-member profile is expressible unchanged, and the class-level
        aggregate numbers keep their meaning (``effective_GBps`` is the
        healthy-members total).  Member names must be unique across a
        profile: they are the instance-addressable path ids the control
        plane drains individually (DESIGN.md §10).
    """

    name: str
    kind: LinkKind
    raw_GBps: float
    effective_GBps: float
    step_latency_us: float
    fixed_overhead_us: float = 0.0
    shares_pcie_switch: bool = False
    members: Tuple[LinkMember, ...] = ()

    @property
    def is_primary(self) -> bool:
        return self.kind in PRIMARY_KINDS

    # -- instance dimension ---------------------------------------------------

    @property
    def n_members(self) -> int:
        return len(self.members) or 1

    @property
    def member_names(self) -> Tuple[str, ...]:
        """The instance path ids; a memberless link IS its single member."""
        return tuple(m.name for m in self.members) or (self.name,)

    @property
    def instances(self) -> Tuple[LinkMember, ...]:
        """Explicit members, or the implicit single healthy instance."""
        return self.members or (LinkMember(self.name),)

    def member(self, name: str) -> LinkMember:
        for m in self.instances:
            if m.name == name:
                return m
        raise KeyError(f"no member {name!r} in link {self.name!r}")

    @property
    def healthy(self) -> bool:
        """True when every instance runs at nominal rate — the parity case."""
        return all(m.health == 1.0 for m in self.members)

    @property
    def health_factor(self) -> float:
        """Mean member health: scales the class aggregate bandwidth (1.0
        for every healthy or memberless link)."""
        if not self.members:
            return 1.0
        return sum(m.health for m in self.members) / len(self.members)

    def member_effective_GBps(self, name: str) -> float:
        """One instance's achievable payload bandwidth: an equal slice of
        the class aggregate, scaled by the instance's health."""
        return self.effective_GBps / self.n_members * self.member(name).health

    def with_members(self, names: Sequence[str]) -> "LinkSpec":
        """Uniform healthy instances — the default per-rail synthesis."""
        return dataclasses.replace(
            self, members=tuple(LinkMember(n) for n in names))

    def degraded(self, member_name: Optional[str], factor: float) -> "LinkSpec":
        """Scale one member's (or, with ``member_name=None``, every
        member's) health by ``factor``.  A memberless link materializes its
        implicit single instance so the degradation is visible."""
        if factor < 0.0:
            raise ValueError(f"degrade factor must be >= 0, got {factor}")
        members = self.instances
        if member_name is None:
            new = tuple(dataclasses.replace(m, health=m.health * factor)
                        for m in members)
        else:
            if member_name not in self.member_names:
                raise KeyError(
                    f"no member {member_name!r} in link {self.name!r}")
            new = tuple(dataclasses.replace(m, health=m.health * factor)
                        if m.name == member_name else m for m in members)
        return dataclasses.replace(self, members=new)


@dataclasses.dataclass(frozen=True)
class NodeProfile:
    """A machine profile: the set of aggregatable links + contention rule.

    A profile can describe any fabric *tier* of a cluster
    (``repro.cluster``, DESIGN.md §9, §15): ``tier="intra"`` is one box's
    link pool (the seed meaning — every pre-cluster profile),
    ``tier="inter"`` is the NIC tier between boxes, whose "primary" is
    the rail-aligned NIC path, and ``tier="pod"`` is the cross-pod
    DCN tier whose primary is the oversubscribed spine uplink pool.
    ``inter_hop_us`` is the extra per-ring-step latency an inter-node
    (or cross-pod) hop pays for switch traversal — zero inside a box.
    """

    name: str
    links: Tuple[LinkSpec, ...]
    #: bandwidth ceiling (GB/s, unidirectional payload) for all routes with
    #: ``shares_pcie_switch=True`` together; None = no contention.
    pcie_switch_ceiling_GBps: Optional[float] = None
    #: which cluster tier this profile describes: "intra" | "inter" | "pod".
    tier: str = "intra"
    #: per-ring-step switch-traversal latency (us) added by the timing
    #: model on every step — the inter-node hop cost (simulator.py).
    inter_hop_us: float = 0.0

    def link(self, name: str) -> LinkSpec:
        for l in self.links:
            if l.name == name:
                return l
        raise KeyError(f"no link {name!r} in profile {self.name!r}")

    def link_of_member(self, member_name: str) -> LinkSpec:
        """The link class owning one instance path id.  A memberless
        link owns the member carrying its own name."""
        owners = [l for l in self.links if member_name in l.member_names]
        if not owners:
            raise KeyError(
                f"no link member {member_name!r} in profile {self.name!r}")
        if len(owners) > 1:
            raise ValueError(
                f"member name {member_name!r} is ambiguous in profile "
                f"{self.name!r} (links "
                f"{[l.name for l in owners]!r})")
        return owners[0]

    def multi_member_links(self) -> Dict[str, Tuple[LinkMember, ...]]:
        """link name -> explicit members, for links with an instance
        dimension worth balancing (>= 2 members)."""
        return {l.name: l.members for l in self.links if len(l.members) > 1}

    @property
    def healthy(self) -> bool:
        return all(l.healthy for l in self.links)

    @property
    def primary(self) -> LinkSpec:
        for l in self.links:
            if l.is_primary:
                return l
        raise ValueError(f"profile {self.name!r} has no primary link")

    @property
    def secondary(self) -> Tuple[LinkSpec, ...]:
        return tuple(l for l in self.links if not l.is_primary)


# ---------------------------------------------------------------------------
# Hardware database.
#
# GPU rows mirror Table 1 of the paper (bidirectional GB/s; RDMA NIC figures
# converted from Gb/s).  ``effective_GBps`` for H800 is calibrated in
# simulator.py from the NCCL baseline column of Table 2; other GPU rows scale
# by their raw ratios.  TPU v5e constants follow the brief: 197 TFLOP/s bf16,
# 819 GB/s HBM, ~50 GB/s per ICI link.
# ---------------------------------------------------------------------------

def _gbits(gbps: float) -> float:
    return gbps / 8.0


# Paper §5.1: per-GPU ConnectX-6 "50 GB/s" NICs (400 Gb/s class), PCIe Gen5
# x16 = 64 GB/s unidirectional.  The effective numbers below are the
# calibration targets explained in simulator.py.
H800 = NodeProfile(
    name="h800",
    links=(
        LinkSpec("nvlink", LinkKind.NVLINK, raw_GBps=400.0,
                 effective_GBps=139.0, step_latency_us=4.0),
        LinkSpec("pcie", LinkKind.PCIE, raw_GBps=128.0,
                 effective_GBps=26.0, step_latency_us=10.0,
                 fixed_overhead_us=20.0, shares_pcie_switch=True),
        LinkSpec("rdma", LinkKind.RDMA, raw_GBps=_gbits(800.0),
                 effective_GBps=14.0, step_latency_us=14.0,
                 fixed_overhead_us=30.0, shares_pcie_switch=True),
    ),
    pcie_switch_ceiling_GBps=64.0,
)

H100 = NodeProfile(
    name="h100",
    links=(
        LinkSpec("nvlink", LinkKind.NVLINK, raw_GBps=900.0,
                 effective_GBps=139.0 * 900.0 / 400.0, step_latency_us=4.0),
        LinkSpec("pcie", LinkKind.PCIE, raw_GBps=128.0,
                 effective_GBps=26.0, step_latency_us=10.0,
                 fixed_overhead_us=20.0, shares_pcie_switch=True),
        LinkSpec("rdma", LinkKind.RDMA, raw_GBps=_gbits(800.0),
                 effective_GBps=14.0, step_latency_us=14.0,
                 fixed_overhead_us=30.0, shares_pcie_switch=True),
    ),
    pcie_switch_ceiling_GBps=64.0,
)

A800 = NodeProfile(
    name="a800",
    links=(
        LinkSpec("nvlink", LinkKind.NVLINK, raw_GBps=400.0,
                 effective_GBps=139.0, step_latency_us=5.0),
        LinkSpec("pcie", LinkKind.PCIE, raw_GBps=64.0,
                 effective_GBps=13.0, step_latency_us=12.0,
                 fixed_overhead_us=25.0, shares_pcie_switch=True),
        LinkSpec("rdma", LinkKind.RDMA, raw_GBps=_gbits(400.0),
                 effective_GBps=7.0, step_latency_us=18.0,
                 fixed_overhead_us=35.0, shares_pcie_switch=True),
    ),
    pcie_switch_ceiling_GBps=32.0,
)

GB200 = NodeProfile(
    name="gb200",
    links=(
        LinkSpec("nvlink", LinkKind.NVLINK, raw_GBps=1800.0,
                 effective_GBps=139.0 * 1800.0 / 400.0, step_latency_us=3.0),
        LinkSpec("pcie", LinkKind.PCIE, raw_GBps=400.0,
                 effective_GBps=80.0, step_latency_us=8.0,
                 fixed_overhead_us=15.0, shares_pcie_switch=True),
        LinkSpec("rdma", LinkKind.RDMA, raw_GBps=_gbits(1600.0),
                 effective_GBps=28.0, step_latency_us=11.0,
                 fixed_overhead_us=25.0, shares_pcie_switch=True),
    ),
    pcie_switch_ceiling_GBps=200.0,
)

GB300 = NodeProfile(
    name="gb300",
    links=(
        LinkSpec("nvlink", LinkKind.NVLINK, raw_GBps=1800.0,
                 effective_GBps=139.0 * 1800.0 / 400.0, step_latency_us=3.0),
        # GB300 decouples the IO paths -> no contention (Table 1 last row).
        LinkSpec("pcie", LinkKind.PCIE, raw_GBps=400.0,
                 effective_GBps=80.0, step_latency_us=8.0,
                 fixed_overhead_us=15.0, shares_pcie_switch=False),
        LinkSpec("rdma", LinkKind.RDMA, raw_GBps=_gbits(1600.0),
                 effective_GBps=28.0, step_latency_us=11.0,
                 fixed_overhead_us=25.0, shares_pcie_switch=False),
    ),
    pcie_switch_ceiling_GBps=None,
)


# --- TPU v5e target ---------------------------------------------------------
# Hardware constants from the brief: ~50 GB/s per ICI link, 819 GB/s HBM.
# A (16,16) mesh axis collective rides the links of one torus dimension; the
# orthogonal dimension's links are idle, as is the host PCIe DMA engine and
# the per-host DCN NIC.  Effective numbers assume a bidirectional ring per
# axis (2 links engaged per chip per axis).
TPU_V5E = NodeProfile(
    name="tpu_v5e",
    links=(
        LinkSpec("ici", LinkKind.ICI_PRIMARY, raw_GBps=100.0,
                 effective_GBps=90.0, step_latency_us=1.0),
        LinkSpec("ici_ortho", LinkKind.ICI_ORTHO, raw_GBps=100.0,
                 effective_GBps=45.0, step_latency_us=2.5,
                 fixed_overhead_us=3.0),
        LinkSpec("host_pcie", LinkKind.HOST_PCIE, raw_GBps=32.0,
                 effective_GBps=8.0, step_latency_us=6.0,
                 fixed_overhead_us=25.0, shares_pcie_switch=True),
        LinkSpec("dcn", LinkKind.DCN, raw_GBps=25.0,
                 effective_GBps=6.0, step_latency_us=4.0,
                 fixed_overhead_us=20.0, shares_pcie_switch=True),
    ),
    pcie_switch_ceiling_GBps=16.0,
)


PROFILES: Dict[str, NodeProfile] = {
    p.name: p for p in (H800, H100, A800, GB200, GB300, TPU_V5E)
}


def validate_member_names(profile: NodeProfile) -> None:
    """Enforce the instance-addressing invariant: every explicit member
    name is unique across the profile — against other members AND against
    every link name.  Member names are bare keys in timing dicts,
    balancer paths and ``--degrade`` targets, so a collision (a member
    named after a sibling link, two links sharing a member name) would
    silently cross-wire one link's timings into another's drain loop.
    Raises ValueError; called at registration, the one gate every profile
    a communicator can name passes through.
    """
    link_names = {l.name for l in profile.links}
    seen: Dict[str, str] = {}
    for l in profile.links:
        for m in l.members:
            # the one allowed shadowing: a SINGLE materialized member
            # carrying its own link's name (what degrading a memberless
            # link produces) — it IS the class, no ambiguity
            if m.name in link_names and (m.name != l.name
                                         or len(l.members) > 1):
                raise ValueError(
                    f"profile {profile.name!r}: member {m.name!r} of link "
                    f"{l.name!r} collides with a link name")
            if m.name in seen:
                where = (f"links {seen[m.name]!r} and {l.name!r}"
                         if seen[m.name] != l.name
                         else f"link {l.name!r} twice")
                raise ValueError(
                    f"profile {profile.name!r}: member name {m.name!r} "
                    f"appears in {where}")
            seen[m.name] = l.name


def register_profile(profile: NodeProfile) -> NodeProfile:
    """Add a (possibly synthesized) profile to the DB under its name.

    Idempotent for an equal re-registration — cluster tier profiles are
    synthesized deterministically from their parameters (repro.cluster),
    so re-building the same cluster must resolve to the same entry; a
    *conflicting* re-use of a name is an error, because ``CommConfig``
    refers to profiles by name and silent replacement would re-key
    memoized communicators.
    """
    validate_member_names(profile)
    existing = PROFILES.get(profile.name)
    if existing is not None:
        if existing != profile:
            raise ValueError(
                f"profile name {profile.name!r} already registered with "
                f"different parameters")
        return existing
    PROFILES[profile.name] = profile
    return profile


def idle_bw_opportunity(profile: NodeProfile,
                        codecs: Optional[Dict[str, object]] = None) -> float:
    """Table-1 'Idle BW Opportunity': idle bandwidth / primary bandwidth.

    With path contention the idle bandwidth is capped by the shared PCIe
    interface; without contention it is the sum of the secondary raw links.
    Per-member health scales each link's contribution — a rail at 25%
    health offers a quarter of its raw bandwidth as opportunity (and a
    degraded primary shrinks the denominator the same way), so the ratio
    describes the fabric as it actually runs, not as it was sold.  The
    contention ceiling itself is NOT health-scaled: it is the shared PCIe
    interface's limit, which a sick NIC behind it does nothing to raise.

    ``codecs`` (link name -> :class:`~repro.core.codecs.PayloadCodec`)
    scales each compressed secondary link's EFFECTIVE bandwidth by
    1/wire_ratio: a 4:1 codec moves four logical bytes per wire byte, so
    the link offers that much more opportunity (DESIGN.md §12).  The
    primary is never codec-scaled (codecs only attach to secondary
    paths), and neither is the PCIe ceiling — compression changes what a
    byte carries, not how many bytes the switch can move.
    """
    codecs = codecs or {}

    def eff(l) -> float:
        bw = l.raw_GBps * l.health_factor
        codec = codecs.get(l.name)
        if codec is not None and codec.wire_ratio > 0:
            bw /= codec.wire_ratio
        return bw

    primary = profile.primary.raw_GBps * profile.primary.health_factor
    contended = [l for l in profile.secondary if l.shares_pcie_switch]
    free = [l for l in profile.secondary if not l.shares_pcie_switch]
    idle = sum(eff(l) for l in free)
    if contended:
        cap = profile.pcie_switch_ceiling_GBps
        total = sum(eff(l) for l in contended)
        # The contended routes can jointly move at most the PCIe interface BW
        # (bidirectional = 2x the unidirectional ceiling).  The ceiling is
        # on WIRE bytes: a codec raises the logical throughput the switch
        # admits by the same 1/wire_ratio, so scale the admitted total by
        # the bandwidth-weighted ratio of the contended links.
        if cap is not None:
            raw = sum(l.raw_GBps * l.health_factor for l in contended)
            boost = total / raw if raw > 0 else 1.0
            idle += min(total, cap * 2.0 * boost)
        else:
            idle += total
    if primary <= 0.0:
        # a dead primary (--degrade nvlink=0): every idle byte/s is
        # infinite relative opportunity — same convention as the timing
        # model's bw<=0 guard
        return float("inf") if idle > 0.0 else 0.0
    return idle / primary


# ---------------------------------------------------------------------------
# Fault injection — the ``--degrade`` flag's model half (DESIGN.md §10).
# ---------------------------------------------------------------------------

def parse_degrade(spec: str) -> Tuple[str, Optional[str], float]:
    """Parse one ``name[:member]=factor`` fault-injection spec.

    Returns ``(target, member, factor)`` where ``member`` is None when the
    spec names a single token — resolved against a profile by
    :func:`degrade_profile` as a link (all instances) or a unique member.
    """
    if "=" not in spec:
        raise ValueError(
            f"degrade spec {spec!r} must be name[:member]=factor")
    lhs, _, rhs = spec.partition("=")
    if rhs.strip() == "down":
        # full-link (or full-member) loss: health 0 — the factor spelling
        # the fault-schedule DSL shares with --degrade (repro.faults)
        factor = 0.0
    else:
        try:
            factor = float(rhs)
        except ValueError:
            raise ValueError(
                f"degrade spec {spec!r}: factor {rhs!r} is neither a "
                f"number nor 'down'")
    if factor < 0.0:
        raise ValueError(f"degrade spec {spec!r}: factor must be >= 0")
    lhs = lhs.strip()
    if not lhs:
        raise ValueError(f"degrade spec {spec!r}: empty target")
    if ":" in lhs:
        link, _, member = lhs.partition(":")
        if not link or not member:
            raise ValueError(f"degrade spec {spec!r}: bad link:member")
        return link, member, factor
    return lhs, None, factor


def resolve_degrade_target(profile: NodeProfile, target: str,
                           member: Optional[str]
                           ) -> Optional[Tuple[str, Optional[str]]]:
    """Resolve a parsed degrade/fault target against ONE profile.

    Returns the canonical ``(link, member)`` pair — the same resolution
    order :func:`degrade_profile` applies (link name first, then unique
    member name) — or None when this profile does not own the target, so
    multi-tier callers (a cluster's NIC tier + node profile) can try the
    next tier.  An ambiguous bare member name still raises ValueError via
    ``link_of_member``: silence there would pick a tier arbitrarily.
    """
    link_names = {l.name for l in profile.links}
    if member is not None:
        if target not in link_names:
            return None
        try:
            profile.link(target).member(member)
        except KeyError:
            return None
        return target, member
    if target in link_names:
        return target, None
    try:
        owner = profile.link_of_member(target)
    except KeyError:
        return None
    return owner.name, target


def degraded_profile_name(base: str, link: str, member: Optional[str],
                          factor: float) -> str:
    """Deterministic name for a degraded profile variant.  The name is the
    CommConfig / TuningProfile / communicator-memo key, so a degraded run
    can never warm-start from (or collide with) the healthy fabric's
    entries."""
    target = f"{link}:{member}" if member else link
    return f"{base}!{target}={factor:g}"


def degrade_profile(profile: NodeProfile, spec: str,
                    register: bool = True) -> NodeProfile:
    """Apply one ``name[:member]=factor`` spec to a profile.

    The single-token form resolves first as a link name (degrading every
    instance), then as a unique member name across the profile's links —
    so ``--degrade rail3=0.25`` drains one rail of the NIC tier without
    spelling out its class.  Raises KeyError when the target matches
    nothing.  The variant is registered under its deterministic name (see
    :func:`degraded_profile_name`) so every process modelling the same
    fault resolves the same entry.
    """
    target, member, factor = parse_degrade(spec)
    link_names = {l.name for l in profile.links}
    if member is None and target not in link_names:
        # single token that is not a link: resolve as a unique member
        owner = profile.link_of_member(target)   # KeyError if absent
        target, member = owner.name, target
    if target not in link_names:
        raise KeyError(f"no link {target!r} in profile {profile.name!r}")
    links = tuple(l.degraded(member, factor) if l.name == target else l
                  for l in profile.links)
    out = dataclasses.replace(
        profile, name=degraded_profile_name(profile.name, target, member,
                                            factor),
        links=links)
    return register_profile(out) if register else out


# TPU v5e roofline constants (per chip) — used by repro.roofline.
TPU_V5E_PEAK_BF16_FLOPS = 197e12      # FLOP/s
TPU_V5E_HBM_BW = 819e9                # bytes/s
TPU_V5E_ICI_BW_PER_LINK = 50e9        # bytes/s per link (brief's constant)
