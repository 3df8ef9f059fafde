# Copied from src/repro/faults/clock.py; only the imports are renamed.
"""FabricClock — hysteresis-gated application of the health timeline.

The clock is the ONE place fabric time advances: the train loop calls
``advance(step)`` at the top of every step, the serve engines at every
tick, and the benchmark harness per simulated call round.  Each advance
compares the timeline's *raw* state against the *committed* state the
stack currently runs at:

* a divergence must persist for K consecutive steps (``hysteresis``)
  before it commits — a rail flapping up/down every step never commits,
  so the PlanCache/exec-cache are never re-keyed by it (the transition
  is counted as a *suppressed flap* instead);
* on commit, every communicator's ``apply_health_state`` swaps its
  fabric profile and warm-starts the affected slots from the nearest
  TuningProfile entry (core/communicator.py) — the count of
  communicators that actually changed is the transition's re-key cost;
* node-loss commits are not applied here — they are surfaced as
  transitions for the owner (the train loop's elastic-resume handler,
  or a serve engine that merely records them);
* after any commit the clock watches the Stage-2 adjustment counters and
  records *recovery steps*: how many steps until no balancer makes a
  further move — the per-transition settle time the fault bench reports.

Fabric time is monotone: an elastic resume rewinds the TRAINER to the
checkpoint step, but ``advance`` clamps to the maximum step ever seen —
rewinding the trainer does not heal the fabric, so replayed steps see
the post-fault world and no phantom restore transitions fire.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.faults.schedule import (FabricState, HEALTHY_STATE,
                                         HealthTimeline)

#: steps a divergence must persist before plans/exec-cache re-key.  Big
#: enough that a per-step flap (period 2) and bursty double-flaps never
#: commit; small enough that a real fault costs only a few blind steps.
HYSTERESIS_K = 4

Transition = Dict[str, object]


class FabricClock:
    """Advance the :class:`HealthTimeline` against a set of live
    communicators (``comms``: zero-arg callable returning them — a
    ``ParallelCtx.comms`` bound method, or a lambda over a bare list in
    benchmarks/tests)."""

    def __init__(self, timeline: HealthTimeline, *,
                 hysteresis: int = HYSTERESIS_K,
                 comms: Optional[Callable[[], Sequence[object]]] = None):
        self.timeline = timeline
        self.k = max(int(hysteresis), 1)
        self._comms: Callable[[], Sequence[object]] = comms or (lambda: ())
        self.ctx = None                 # latest attached ParallelCtx
        self._committed: FabricState = HEALTHY_STATE
        self._pending: Optional[Tuple[FabricState, int]] = None
        self._max_step = -1
        self.step = -1
        self.transitions: List[Transition] = []
        self.suppressed_flaps = 0
        self.rekeys = 0
        self._recovering: Optional[int] = None      # transition step
        self._recover_last: Optional[int] = None
        self.recoveries: List[Dict[str, int]] = []

    # -- wiring ----------------------------------------------------------------

    def attach(self, ctx) -> "FabricClock":
        """Bind to a ParallelCtx: advance over its communicators and hang
        the clock on the ctx so ``comm_report`` grows the faults block.
        Re-attachable — an elastic resume binds the SAME clock (with its
        monotone fabric time and transition history) to the rebuilt ctx.
        The latest ctx stays reachable as ``clock.ctx`` so launchers can
        report post-swap state."""
        self._comms = ctx.comms
        ctx.fault_clock = self
        self.ctx = ctx
        return self

    @property
    def state(self) -> FabricState:
        return self._committed

    # -- the per-step hook -----------------------------------------------------

    def advance(self, step: int) -> List[Transition]:
        """Returns the transitions COMMITTED at this step (usually [])."""
        eff = max(int(step), self._max_step)
        self._max_step = eff
        self.step = eff
        self._track_recovery(eff)
        raw = self.timeline.state_at(eff)
        if raw == self._committed:
            if self._pending is not None:
                # the divergence vanished before persisting K steps — the
                # flap the hysteresis rule exists to absorb
                self.suppressed_flaps += 1
                self._pending = None
            return []
        if self._pending is None or self._pending[0] != raw:
            self._pending = (raw, eff)
        if eff - self._pending[1] + 1 < self.k:
            return []
        prev, self._committed = self._committed, raw
        self._pending = None
        out: List[Transition] = []
        if raw.degrades != prev.degrades:
            out.append(self._commit_degrade(prev, raw, eff))
        for idx in raw.down_nodes:
            if idx not in prev.down_nodes:
                out.append(self._commit_node(idx, eff))
        return out

    # -- commits ---------------------------------------------------------------

    def _commit_degrade(self, prev: FabricState, new: FabricState,
                        step: int) -> Transition:
        rekeyed: Dict[str, object] = {}
        for comm in self._comms():
            info = comm.apply_health_state(new.degrades)
            if info:
                rekeyed[getattr(comm, "axis_name", "?")] = info
        self.rekeys += len(rekeyed)
        tr: Transition = {"kind": "degrade", "step": step,
                          "state": list(new.degrades),
                          "was": list(prev.degrades),
                          "rekeyed": rekeyed}
        self.transitions.append(tr)
        self._begin_recovery(step)
        return tr

    def _commit_node(self, idx: int, step: int) -> Transition:
        tr: Transition = {"kind": "node", "node": idx, "step": step}
        self.transitions.append(tr)
        self._begin_recovery(step)
        return tr

    # -- recovery tracking -----------------------------------------------------

    def _adjustment_count(self) -> int:
        n = 0
        for comm in self._comms():
            for sc in comm.slot_controllers():
                n += len(sc.balancer.adjustments)
                for bal in sc.member_balancers.values():
                    n += len(bal.adjustments)
        return n

    def _begin_recovery(self, step: int) -> None:
        self._recovering = step
        self._recover_last = self._adjustment_count()

    def _track_recovery(self, step: int) -> None:
        if self._recovering is None or step <= self._recovering:
            return
        cur = self._adjustment_count()
        if cur == self._recover_last:
            # a full step passed with no Stage-2 move: settled
            self.recoveries.append({
                "transition_step": self._recovering,
                "settled_step": step,
                "recovery_steps": step - self._recovering})
            self._recovering = None
            self._recover_last = None
        else:
            self._recover_last = cur

    # -- reporting -------------------------------------------------------------

    def projection(self) -> List[Dict[str, object]]:
        """Static per-event view (the dryrun fault table): when each
        event fires and when it would commit if it persisted."""
        return [{"event": e.spec, "kind": e.kind, "step": e.step,
                 "commit_step": e.step + self.k - 1}
                for e in self.timeline.events]

    def report(self) -> Dict[str, object]:
        return {
            "hysteresis_k": self.k,
            "fabric_step": self.step,
            "schedule": [e.spec for e in self.timeline.events],
            "state": {"degrades": list(self._committed.degrades),
                      "down_nodes": list(self._committed.down_nodes)},
            "transitions": list(self.transitions),
            "suppressed_flaps": self.suppressed_flaps,
            "rekeys": self.rekeys,
            "recoveries": list(self.recoveries),
        }
