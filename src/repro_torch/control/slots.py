# Copied from src/repro/control/slots.py; only the imports are renamed.
"""SlotController — all control state for one (collective, size-bucket).

Before the control plane existed, ``FlexCommunicator`` spread each slot's
state across parallel dicts (``_tuned`` for the Stage-1 result,
``_balancers`` for the Stage-2 state) plus ad-hoc plan-construction
arithmetic.  A SlotController owns one slot end to end:

* how its shares came to be (cold Algorithm-1 run vs. TuningProfile
  warm-start — ``warm`` + ``tuned.iterations`` record the provenance);
* the live Stage-2 balancer;
* a single measurement-ingest method, :meth:`report`, through which every
  per-call timing flows — whatever TimingSource produced it;
* measured-mode *probe* moves: from a converged Stage-1 split the
  per-path estimates are near-equal, so a wall-clock-fed balancer would
  never see a gap and never learn.  After ``probe_period`` gap-free calls
  the controller moves share from a rotating active secondary to the
  primary (the paper's NVLink-first rule); the resulting share delta
  gives MeasuredTimingSource the finite-difference sample it needs, and a
  wrong probe decays harmlessly (the drained path's rate estimate falls,
  the balancer routes share back).  Probes are recorded as ``kind="probe"``
  adjustments so reports can tell exploration from reaction.

  Probes are **quantization-aware** when the owner supplies a
  ``plan_quantizer`` (the communicator does): SHARE_GRID is finer than
  the RoutePlan chunk grid, so a 1-unit probe usually rounds away — the
  executed plan never changes and the wall-clock loop measures nothing.
  The probe is therefore *snapped to the plan grain*: promoted to the
  smallest move that flips the quantized plan, or skipped entirely when
  the source path cannot afford a whole grain step (a sub-grain probe
  would burn an adjustment without producing a sample).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

from repro_torch.core.balancer import Adjustment, LoadBalancer
from repro_torch.core.links import LinkMember, split_by_health
from repro_torch.core.tuner import MeasureFn, SHARE_GRID, TuneResult, initial_tune
from repro_torch.core.topology import Collective

#: maps grid-unit shares -> the quantized plan identity (any hashable);
#: two share vectors with equal quantizations execute the same RoutePlan.
PlanQuantizer = Callable[[Mapping[str, int]], object]

#: measured-mode exploration cadence: gap-free calls before a probe move.
PROBE_PERIOD = 40

#: adjustments kept in the per-slot report history.
HISTORY_K = 8

#: per-member weight resolution: each healthy instance starts with this
#: many weight units, so a drain can address a member in 1/MEMBER_BASE
#: steps of its equal slice.  8 keeps the member grid fine enough that a
#: sibling's share moves by well under one plan grain per drain step.
MEMBER_BASE = 8

#: explicit instance dimension of a slot: link name -> member tuple.
MemberMap = Mapping[str, Sequence[LinkMember]]


def _member_balancers(members: Optional[MemberMap],
                      weights: Optional[Mapping[str, Mapping[str, int]]] = None
                      ) -> Dict[str, LoadBalancer]:
    """One intra-class balancer per multi-member link.

    The balancer's paths are the link's INSTANCES and its grid is the
    member weight total; ``primary=""`` disables the NVLink-first rule —
    within one class there is no privileged sibling, so weight moves go
    slowest→fastest member.  Initial weights are health-proportional
    (``split_by_health``): uniform healthy members start exactly equal
    (the parity case), a degraded member starts pre-drained — Algorithm 1
    on hardware would have measured the sick rail the same way.  Saved
    weights (a TuningProfile warm-start) override the initialization when
    their member names still match the link's layout.
    """
    out: Dict[str, LoadBalancer] = {}
    for link, mems in (members or {}).items():
        if len(mems) < 2:
            continue
        names = [m.name for m in mems]
        w = None
        if weights is not None and weights.get(link):
            saved = {str(k): int(v) for k, v in weights[link].items()}
            if set(saved) == set(names) and sum(saved.values()) > 0:
                w = {n: saved[n] for n in names}
        if w is None:
            w = split_by_health(mems, MEMBER_BASE * len(mems))
        out[link] = LoadBalancer(w, primary="", grid=sum(w.values()))
    return out


@dataclasses.dataclass
class SlotController:
    """Control state for one ``(collective, size-bucket)`` slot."""

    op: Collective
    bucket: int
    tuned: TuneResult
    balancer: LoadBalancer
    warm: bool = False
    probe_period: Optional[int] = None
    #: which cluster fabric tier this slot balances ("intra" | "inter") —
    #: reporting rolls slots up per tier (DESIGN.md §9).
    tier: str = "intra"
    #: share-vector -> quantized-plan identity; when set, probe moves are
    #: snapped to the plan grain (see module docstring).
    plan_quantizer: Optional[PlanQuantizer] = None
    #: the slot's instance dimension: link name -> explicit LinkMember
    #: tuple (multi-member links only) — the profile's per-rail layout.
    link_members: Dict[str, Sequence[LinkMember]] = dataclasses.field(
        default_factory=dict)
    #: chosen wire codec per LINK name (DESIGN.md §12) — empty means every
    #: path carries raw bytes (the byte-identical default).  Set at cold
    #: tune from the timing model's choose_codecs verdict, restored verbatim
    #: by a TuningProfile warm start: the codec choice is part of the slot's
    #: tuned identity, exactly like the shares it was tuned against.
    codecs: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: where this slot's shares came from when a fault transition rebuilt
    #: it (repro.faults, DESIGN.md §14): ``"transition:exact"`` (saved
    #: entry for the new fabric), ``"transition:<profile>"`` (nearest
    #: degraded neighbor), ``"transition:carry"`` (live shares carried
    #: forward).  Empty for slots born at launch.
    origin: str = ""
    #: per-link intra-class balancers over member weights — the machinery
    #: that drains ONE degraded instance while its siblings (and the
    #: class-level share vector) hold (DESIGN.md §10).
    member_balancers: Dict[str, LoadBalancer] = dataclasses.field(
        default_factory=dict)
    _since_gap: int = 0
    _probe_idx: int = 0
    #: the member weights the PLAN sees — refreshed from the live
    #: balancers only when no intra-class gap is live, so a drain episode
    #: re-keys the RoutePlan (and the executable cache behind it) ONCE at
    #: its settled endpoint instead of once per unit move.  member_layout
    #: never changes the lowered HLO, so executing the stale-uniform plan
    #: mid-drain is harmless; re-jitting byte-identical programs per move
    #: would not be (the member-level analogue of PR 4's
    #: quantization-aware probe snapping).
    _plan_weights: Optional[Dict[str, Dict[str, int]]] = None
    #: memo for _probe_units: (source, target, shares-state) -> units.
    #: The snapping search rebuilds plans per candidate move; shares only
    #: change on an adjustment, so recomputing every probe_period calls
    #: of a steady slot would be pure waste.
    _probe_memo: Optional[tuple] = None

    # -- construction ---------------------------------------------------------

    @classmethod
    def tune_cold(cls, op: Collective, bucket: int, paths: Sequence[str],
                  primary: str, measure: MeasureFn, *,
                  probe_period: Optional[int] = None,
                  tier: str = "intra",
                  plan_quantizer: Optional[PlanQuantizer] = None,
                  members: Optional[MemberMap] = None,
                  codecs: Optional[Mapping[str, str]] = None
                  ) -> "SlotController":
        """Run Algorithm 1 for the slot — the paper's profiling phase.

        Stage 1 tunes at CLASS granularity (the classes are what have
        heterogeneous latency/bandwidth characters; this is also what
        keeps its trajectory bit-identical to the pre-member model); the
        converged class shares are then subdivided across each link's
        instances health-proportionally (``_member_balancers``).
        ``codecs`` is the per-link wire-codec choice the ``measure``
        oracle was already pricing — it rides along so plans and reports
        agree with the tuning."""
        res = initial_tune(list(paths), primary, measure)
        return cls(op, bucket, res, LoadBalancer(res.shares, primary),
                   warm=False, probe_period=probe_period, tier=tier,
                   plan_quantizer=plan_quantizer,
                   link_members=dict(members or {}),
                   member_balancers=_member_balancers(members),
                   codecs=dict(codecs or {}))

    @classmethod
    def warm_start(cls, op: Collective, bucket: int,
                   shares: Mapping[str, int], primary: str, *,
                   probe_period: Optional[int] = None,
                   tier: str = "intra",
                   plan_quantizer: Optional[PlanQuantizer] = None,
                   members: Optional[MemberMap] = None,
                   member_weights: Optional[Mapping[str, Mapping[str, int]]]
                   = None,
                   codecs: Optional[Mapping[str, str]] = None
                   ) -> "SlotController":
        """Adopt converged shares from a TuningProfile: zero Algorithm-1
        iterations, identical downstream RoutePlans (plans are a pure
        function of the shares, member weights and codec choice — all
        restored)."""
        shares = dict(shares)
        res = TuneResult(shares=shares,
                         active=[p for p, s in shares.items() if s > 0],
                         iterations=0, converged=True, trace=[])
        return cls(op, bucket, res, LoadBalancer(res.shares, primary),
                   warm=True, probe_period=probe_period, tier=tier,
                   plan_quantizer=plan_quantizer,
                   link_members=dict(members or {}),
                   member_balancers=_member_balancers(members,
                                                      member_weights),
                   codecs=dict(codecs or {}))

    # -- control-state views --------------------------------------------------

    @property
    def shares(self) -> Dict[str, int]:
        return self.balancer.shares

    def fractions(self) -> Dict[str, float]:
        return self.balancer.fractions()

    def member_weights(self) -> Dict[str, Dict[str, int]]:
        """LIVE instance weight vectors per multi-member link — what the
        timing model prices and the TuningProfile persists (mid-drain
        state included)."""
        return {link: dict(b.shares)
                for link, b in self.member_balancers.items()}

    def plan_member_weights(self) -> Dict[str, Dict[str, int]]:
        """The instance weights the ROUTE PLAN quantizes by: the last
        settled snapshot of the live weights (see ``_plan_weights``)."""
        if self._plan_weights is None:
            self._plan_weights = self.member_weights()
        return {link: dict(w) for link, w in self._plan_weights.items()}

    def control_state(self) -> object:
        """Hashable-comparable snapshot of EVERYTHING that re-keys the
        slot's RoutePlan: class shares AND the plan-visible member
        weights.  A settled member drain changes the executed plan
        exactly like a class move does, so callers diffing control state
        before/after an observed step (``observe_executed_step``) must
        see both."""
        return (dict(self.balancer.shares), self.plan_member_weights())

    # -- Stage-2 ingest --------------------------------------------------------

    def report(self, timings: Mapping[str, float]) -> Optional[Adjustment]:
        """Feed one call's per-path timings (from whichever TimingSource)
        into the Stage-2 machinery; returns the adjustment made, if any.

        Timings may carry CLASS entries (link names — the historical
        contract) and INSTANCE entries (member names, emitted by the
        simulator for links whose members can diverge).  Instance entries
        feed the per-link member balancers, whose gap rule drains weight
        from a persistently slow member to its fastest sibling; while any
        member balancer has an unresolved intra-class gap, class-level
        moves and probes are held — the class aggregate is transient
        until the sick instance is rebalanced, and reacting to it would
        drain the WHOLE class (the failure mode this refactor removes).

        In measured mode a long gap-free stretch triggers a probe move so
        the wall-clock loop keeps receiving share-sensitivity samples."""
        member_adj: Optional[Adjustment] = None
        for link, bal in self.member_balancers.items():
            mt = {m: timings[m] for m in bal.shares if m in timings}
            if not mt:
                continue
            a = bal.observe(mt)
            if a is not None:
                member_adj = a
        unsettled = member_adj is not None or self._members_unsettled()
        if not unsettled and self.member_balancers:
            # the drain (if any) has settled: publish its endpoint to the
            # plan — at most one executable re-key per episode
            self._plan_weights = self.member_weights()
        adj = self.balancer.observe(timings, allow_adjust=not unsettled)
        if adj is not None or member_adj is not None:
            self._since_gap = 0
            return adj if adj is not None else member_adj
        if self.probe_period is None:
            return None
        self._since_gap += 1
        if self._since_gap < self.probe_period or unsettled:
            return None
        self._since_gap = 0
        return self._probe()

    def _members_unsettled(self) -> bool:
        """True while some link's instances show a live intra-class gap —
        the hold condition for class-level moves."""
        return any(b.current_gap() > b.gap_threshold
                   for b in self.member_balancers.values())

    def _probe(self) -> Optional[Adjustment]:
        bal = self.balancer
        candidates = sorted(p for p in bal.active if p != bal.primary)
        if not candidates or bal.primary not in bal.shares:
            return None
        source = candidates[self._probe_idx % len(candidates)]
        self._probe_idx += 1
        units = self._probe_units(source, bal.primary)
        if units <= 0:
            return None   # sub-grain probe: would round away — skip
        # the balancer validates the move (tracked paths, non-negativity,
        # the primary-reactivation pin) — probes get no special rights
        return bal.move(source, bal.primary, units, kind="probe")

    def _probe_units(self, source: str, target: str) -> int:
        """Snap the probe delta to the RoutePlan quantization grain.

        Without a quantizer: the historical 1-unit move.  With one: the
        smallest move that CHANGES the quantized plan (so the executed
        RoutePlan flips and the measured loop gets its finite-difference
        sample), or 0 when even draining the source entirely would not —
        the regression contract: a sub-grain probe is either skipped or
        promoted to one grain step, never executed as a no-op."""
        if self.plan_quantizer is None:
            return 1
        shares = dict(self.balancer.shares)
        key = (source, target, tuple(sorted(shares.items())))
        if self._probe_memo is not None and self._probe_memo[0] == key:
            return self._probe_memo[1]
        base = self.plan_quantizer(shares)
        units = 0
        for k in range(1, shares.get(source, 0) + 1):
            cand = dict(shares)
            cand[source] -= k
            cand[target] = cand.get(target, 0) + k
            if self.plan_quantizer(cand) != base:
                units = k
                break
        self._probe_memo = (key, units)
        return units

    # -- reporting -------------------------------------------------------------

    def history(self, k: int = HISTORY_K) -> List[Dict[str, object]]:
        """Last-k Stage-2 adjustments, JSON-ready (satellite: report()
        surfaces the balancer's actual trajectory)."""
        return [{"call": a.call_index, "source": a.source,
                 "target": a.target, "moved": a.moved,
                 "gap": round(a.gap, 4), "kind": a.kind}
                for a in self.balancer.last_adjustments(k)]

    def members_report(self) -> Dict[str, Dict[str, object]]:
        """Per-instance breakout for one multi-member slot: weight, share
        of the class, health, and intra-class drain moves."""
        out: Dict[str, Dict[str, object]] = {}
        for link, bal in self.member_balancers.items():
            total = sum(bal.shares.values()) or 1
            healths = {m.name: m.health
                       for m in self.link_members.get(link, ())}
            out[link] = {
                "weights": dict(bal.shares),
                "class_fraction": {m: round(w / total, 4)
                                   for m, w in bal.shares.items()},
                "health": healths,
                "member_moves": len(bal.adjustments),
            }
        return out

    def codec_objects(self) -> Optional[Dict[str, object]]:
        """{link: PayloadCodec} for the slot's chosen codecs, or None —
        the shape every pricing call (timings_for, algbw) consumes."""
        if not self.codecs:
            return None
        from repro_torch.core.codecs import get_codec
        return {link: get_codec(c) for link, c in self.codecs.items()}

    def wire_report(self, model, n_ranks: int) -> Dict[str, object]:
        """Per-path wire-vs-logical byte accounting at the slot's bucket
        payload (the §12 report satellite).  ``logical_bytes`` is what the
        path's algorithm ships uncompressed; ``wire_bytes`` is after the
        chosen codec; ``bytes_saved`` rolls up what the codecs took off
        the slow links."""
        from repro_torch.core.codecs import get_codec
        from repro_torch.core.topology import RingSchedule
        paths: Dict[str, Dict[str, object]] = {}
        total_logical = total_wire = 0.0
        for p, frac in sorted(self.balancer.fractions().items()):
            if frac <= 0.0:
                continue
            link = model.profile.link(p)
            if link.is_primary:
                logical = RingSchedule(self.op, n_ranks).wire_bytes(
                    frac * self.bucket)
            else:
                _steps, wire_fn = model.secondary_algo_cost(self.op, n_ranks)
                logical = wire_fn(frac * self.bucket)
            cname = self.codecs.get(p, "")
            wire = get_codec(cname).wire_bytes(logical) if cname else logical
            paths[p] = {"codec": cname or "off",
                        "logical_bytes": int(logical),
                        "wire_bytes": int(wire)}
            total_logical += logical
            total_wire += wire
        return {"paths": paths,
                "logical_bytes": int(total_logical),
                "wire_bytes": int(total_wire),
                "bytes_saved": int(total_logical - total_wire)}

    def describe(self, model, n_ranks: int) -> Dict[str, object]:
        """The per-slot block of ``FlexCommunicator.report()``."""
        out = {
            "tier": self.tier,
            "stage1_shares": self.tuned.shares,
            "stage1_iters": self.tuned.iterations,
            "converged": self.tuned.converged,
            "warm": self.warm,
            "current_shares": dict(self.balancer.shares),
            "stage2_adjustments": len(self.balancer.adjustments),
            "stage2_history": self.history(),
            "evaluator": self.balancer.evaluator.describe(),
            "predicted_algbw_GBps": model.algbw_GBps(
                self.op, n_ranks, self.bucket, self.balancer.fractions(),
                member_weights=self.member_weights() or None,
                codecs=self.codec_objects()),
            "nccl_algbw_GBps": model.nccl_baseline_GBps(
                self.op, n_ranks, self.bucket),
            "wire": self.wire_report(model, n_ranks),
        }
        if self.codecs:
            out["codecs"] = dict(self.codecs)
        if self.member_balancers:
            out["members"] = self.members_report()
        return out

    def status(self) -> Dict[str, object]:
        """Warm/cold provenance (+ instance weights) for dry-run
        reporting — the member table the degraded-smoke CI asserts on."""
        out: Dict[str, object] = {
            "warm": self.warm, "stage1_iters": self.tuned.iterations,
            "converged": self.tuned.converged}
        if self.origin:
            out["origin"] = self.origin
        if self.codecs:
            out["codecs"] = dict(self.codecs)
        if self.member_balancers:
            out["members"] = self.member_weights()
        return out

    @staticmethod
    def rollup(slots: Iterable["SlotController"]) -> Dict[str, Dict[str, int]]:
        """Per-tier summary of many slots — the compact block that keeps
        ``report()`` readable once a cluster runs 2 tiers x N slots: one
        row per tier instead of a wall of per-slot dicts (the per-slot
        detail stays available underneath)."""
        out: Dict[str, Dict[str, int]] = {}
        for sc in slots:
            row = out.setdefault(sc.tier, {
                "slots": 0, "warm": 0, "converged": 0,
                "stage2_adjustments": 0, "probes": 0,
                "member_moves": 0, "drained_members": 0,
                "compressed_slots": 0})
            row["slots"] += 1
            row["warm"] += int(sc.warm)
            row["compressed_slots"] += int(bool(sc.codecs))
            row["converged"] += int(sc.tuned.converged)
            row["stage2_adjustments"] += len(sc.balancer.adjustments)
            row["probes"] += sum(1 for a in sc.balancer.adjustments
                                 if a.kind == "probe")
            for bal in sc.member_balancers.values():
                row["member_moves"] += len(bal.adjustments)
                # an instance holding less than its equal slice has been
                # drained — by Stage 2 or by a health-aware start
                base = sum(bal.shares.values()) / max(len(bal.shares), 1)
                row["drained_members"] += sum(
                    1 for w in bal.shares.values() if w < base)
        return out
