# Copied from src/repro/faults/schedule.py; only the imports are renamed.
"""Fault-schedule DSL + HealthTimeline (DESIGN.md §14).

``--degrade`` froze link health at launch; at 100k+-GPU scale links flap
and hosts straggle *mid-run* (Meta's collective-communication paper,
PAPERS.md).  This module makes health a time-varying input: a schedule is
a comma-joined list of events

    rail3@step200=0.25        degrade one NIC rail to 25% at step 200
    rail:rail3@step200=0.25   same, with the owning link spelled out
    pcie@step100=down         full-link loss (health 0)
    rail3@step600=1.0         restore to construction health
    node1@step400=down        whole-node loss (elastic resize)
    rail3=0.25                bare form: step 0 — exactly ``--degrade``

and :class:`HealthTimeline` folds it into the *active state* at any step:
the latest event at-or-before the step wins per target, restore events
(factor 1.0) drop out entirely, so a timeline that returns to health
yields exactly the construction-time state.  Consumers never apply raw
events — they diff successive states, which is what makes the
FabricClock's hysteresis rule (clock.py) well-defined under flapping.

Events carry health *set-points* relative to the construction profile,
not multipliers on the current state: two events on the same rail replace
each other rather than compound.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.links import NodeProfile, resolve_degrade_target

_STEP_RE = re.compile(r"^(?P<lhs>.+?)@step(?P<step>\d+)$")
_NODE_RE = re.compile(r"^node(?P<idx>\d+)$")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled health transition, firing at the START of ``step``."""

    target: str                 # link / member name, or "node<i>"
    member: Optional[str]       # explicit member of a link:member target
    step: int
    factor: float               # health set-point; 0.0 = down, 1.0 = restore
    kind: str = "degrade"       # "degrade" | "node"

    @property
    def node_index(self) -> int:
        m = _NODE_RE.match(self.target)
        if self.kind != "node" or not m:
            raise ValueError(f"{self.spec!r} is not a node event")
        return int(m.group("idx"))

    @property
    def degrade_spec(self) -> str:
        """The ``name[:member]=factor`` half — what links.degrade_profile
        consumes (and the dedupe key of the active state)."""
        lhs = f"{self.target}:{self.member}" if self.member else self.target
        return f"{lhs}={self.factor:g}"

    @property
    def spec(self) -> str:
        """Canonical full item: round-trips through the parser."""
        if self.kind == "node":
            return f"{self.target}@step{self.step}=down"
        lhs = f"{self.target}:{self.member}" if self.member else self.target
        return f"{lhs}@step{self.step}={self.factor:g}"


def parse_fault_item(item: str) -> FaultEvent:
    """Parse one ``target[:member][@stepN]=factor|down`` item."""
    raw = item.strip()
    if "=" not in raw:
        raise ValueError(
            f"fault spec {raw!r} must be target[:member][@stepN]="
            f"factor|down")
    lhs, _, rhs = raw.partition("=")
    lhs = lhs.strip()
    step = 0
    m = _STEP_RE.match(lhs)
    if m:
        lhs = m.group("lhs")
        step = int(m.group("step"))
    elif "@" in lhs:
        raise ValueError(
            f"fault spec {raw!r}: time qualifier must be '@step<N>' with "
            f"a non-negative integer N")
    rhs = rhs.strip()
    if rhs == "down":
        factor = 0.0
    else:
        try:
            factor = float(rhs)
        except ValueError:
            raise ValueError(
                f"fault spec {raw!r}: factor {rhs!r} is neither a number "
                f"nor 'down'")
    if not 0.0 <= factor <= 1.0:
        raise ValueError(
            f"fault spec {raw!r}: factor is a health SET-POINT relative "
            f"to the construction profile — must be in [0, 1]")
    if not lhs:
        raise ValueError(f"fault spec {raw!r}: empty target")
    node = _NODE_RE.match(lhs)
    if node:
        if rhs != "down":
            raise ValueError(
                f"fault spec {raw!r}: node events support only '=down' "
                f"(elastic loss) — partial node health is a per-link "
                f"degrade on that node's profile")
        if step == 0:
            raise ValueError(
                f"fault spec {raw!r}: a node down at step 0 is not a "
                f"fault — launch with one fewer node instead")
        return FaultEvent(target=lhs, member=None, step=step, factor=0.0,
                          kind="node")
    if ":" in lhs:
        link, _, member = lhs.partition(":")
        if not link or not member:
            raise ValueError(f"fault spec {raw!r}: bad link:member target")
        return FaultEvent(link, member, step, factor)
    return FaultEvent(lhs, None, step, factor)


def parse_fault_schedule(spec: str) -> List[FaultEvent]:
    """Parse a comma-joined schedule into step-sorted events (stable:
    same-step events keep their written order, so the last one wins in
    the active state)."""
    if not spec:
        return []
    events = [parse_fault_item(it) for it in spec.split(",") if it.strip()]
    if not events:
        raise ValueError(f"fault spec {spec!r}: no events")
    return sorted(events, key=lambda e: e.step)


def _target_names(prof: NodeProfile) -> set:
    names = set()
    for link in prof.links:
        names.add(link.name)
        for mem in link.members:
            names.add(mem.name)
    return names


def validate_schedule(events: Sequence[FaultEvent], *,
                      profiles: Sequence[NodeProfile],
                      n_nodes: int = 1) -> List[FaultEvent]:
    """Resolve every event against the fabric it will run on.

    ``profiles`` is the tier search order — for a cluster, (NIC tier,
    node profile), mirroring ``degrade_cluster``'s resolution.  Returns a
    canonicalized copy: bare member targets are rewritten to their
    ``link:member`` form so two spellings of the same rail share one
    dedupe key in the active state.  Unknown targets and out-of-range
    node indices raise ValueError at parse/resolve time — a schedule
    must not be able to fail hundreds of steps into a run.
    """
    out: List[FaultEvent] = []
    for ev in events:
        if ev.kind == "node":
            if n_nodes < 2:
                raise ValueError(
                    f"fault {ev.spec!r}: node loss needs a multi-node run "
                    f"(n_nodes={n_nodes})")
            if not 0 <= ev.node_index < n_nodes:
                raise ValueError(
                    f"fault {ev.spec!r}: node index out of range for "
                    f"n_nodes={n_nodes}")
            out.append(ev)
            continue
        hit = None
        for prof in profiles:
            hit = resolve_degrade_target(prof, ev.target, ev.member)
            if hit is not None:
                break
        if hit is None:
            shown = (f"{ev.target}:{ev.member}" if ev.member else ev.target)
            valid = sorted(set().union(*map(_target_names, profiles)))
            raise ValueError(
                f"fault {ev.spec!r}: unknown link/member {shown!r}; "
                f"valid targets: {', '.join(valid)}")
        out.append(dataclasses.replace(ev, target=hit[0], member=hit[1]))
    return out


class FabricState(NamedTuple):
    """Active fabric health at one step — the committed/raw unit the
    FabricClock's hysteresis compares."""

    degrades: Tuple[str, ...]       # sorted canonical "link[:member]=f"
    down_nodes: Tuple[int, ...]     # sorted lost-node indices

    @property
    def healthy(self) -> bool:
        return not self.degrades and not self.down_nodes


HEALTHY_STATE = FabricState((), ())


class HealthTimeline:
    """The schedule as a step-indexed state function."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.step)
        self.horizon = max((e.step for e in self.events), default=0)

    def __bool__(self) -> bool:
        return bool(self.events)

    def state_at(self, step: int) -> FabricState:
        """Latest event at-or-before ``step`` wins per (target, member);
        factor-1.0 entries drop out (restore = construction health)."""
        active: Dict[Tuple[str, Optional[str]], float] = {}
        down: set = set()
        for ev in self.events:
            if ev.step > step:
                break
            if ev.kind == "node":
                down.add(ev.node_index)
            else:
                active[(ev.target, ev.member)] = ev.factor
        degrades = tuple(sorted(
            (f"{t}:{m}" if m else t) + f"={f:g}"
            for (t, m), f in active.items() if f != 1.0))
        return FabricState(degrades, tuple(sorted(down)))

    def spec(self) -> str:
        """Canonical comma-joined spelling — the CommConfig.fault value,
        so two launches of the same schedule memoize one communicator."""
        return ",".join(e.spec for e in self.events)
