# Copied from src/repro/control/timing.py; only the imports are renamed.
"""TimingSource — where the control plane's numbers come from.

The paper's Stage-2 Evaluator "passively records per-path completion times
for every collective call".  On hardware those are measurements; this repo
historically re-queried the analytic simulator, closing Stage 2 on its own
prophecy.  The TimingSource seam makes the choice explicit:

* :class:`SimTimingSource` — today's behavior, bit-identical: per-call
  per-path timings come from ``PathTimingModel.measure`` at the balancer's
  current fractions.
* :class:`MeasuredTimingSource` — Stage 2 on observation.  The StepProgram
  runtime times each executed step (block-until-ready wall clock) and
  reports the duration; the source apportions it over the step's replay
  multiset and maintains per-slot per-path *rate* estimates (seconds per
  unit of share).  The simulator is consulted exactly once per path — to
  bootstrap the apportionment weights — and never again: rates are
  refined only by finite differences between observed steps whose share
  vectors differ (the SlotController's probe moves guarantee such steps
  exist even from a converged Stage-1 split).

Both stages are covered: ``stage1_measure`` adapts the source into the
``MeasureFn`` Algorithm 1 consumes (Stage 1 is the profiling phase, so it
always runs against the measurement oracle — the simulator stands in for
the hardware profiling round on both sources).

Observability caveat, stated rather than hidden: a collective's completion
time is the *max* over concurrent paths, so one scalar per step cannot
uniquely attribute slowness.  The finite-difference rule attributes a
step-time change to the path whose share just shrank — exact when that
path was the bottleneck, conservatively clamped to zero otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.simulator import PathTimingModel
from repro_torch.core.topology import Collective
from repro_torch.core.tuner import MeasureFn, measure_fn

#: EWMA weight for a fresh finite-difference rate observation.
RATE_EWMA = 0.5

#: one ingested step call: (op, n_ranks, bucket, payload_bytes, fractions).
StepCall = Tuple[Collective, int, int, int, Mapping[str, float]]


class TimingSource:
    """Protocol + shared plumbing for Stage-1/Stage-2 timing providers."""

    kind: str = "abstract"

    def __init__(self, model: PathTimingModel):
        self.model = model

    def stage1_measure(self, op: Collective, n_ranks: int,
                       payload_bytes: int, codecs=None) -> MeasureFn:
        """Algorithm 1's MeasurePathTimings for one slot — the profiling
        phase runs against the measurement oracle on every source.
        ``codecs`` (link -> PayloadCodec) prices compressed secondary
        paths at wire bytes; None is the exact historical oracle."""
        return measure_fn(self.model, op, n_ranks, payload_bytes,
                          codecs=codecs)

    def timings_for(self, op: Collective, n_ranks: int, payload_bytes: int,
                    fractions: Mapping[str, float], *,
                    bucket: Optional[int] = None,
                    member_weights: Optional[Mapping[str, Mapping[str, float]]]
                    = None, contention: float = 1.0,
                    codecs=None) -> Dict[str, float]:
        """Per-call per-path completion times.  ``member_weights`` is the
        slot's live instance subdivision (link -> member -> weight);
        sources that can price instances individually (the simulator) add
        member-keyed entries for diverging links, which feed the slot's
        per-instance drain balancers.  ``contention`` is the in-flight
        plan demand the call ran under (issue/await windows, DESIGN.md
        §11): analytic sources divide link bandwidth by it; measured
        sources ignore it — wall clock already embeds real contention.
        ``codecs`` is the slot's chosen per-link wire codecs (DESIGN.md
        §12): analytic sources price the codec-scaled wire; measured
        sources ignore it for the same reason as contention."""
        raise NotImplementedError

    def ingest_step(self, calls: Sequence[StepCall],
                    elapsed_s: Optional[float]) -> None:
        """Feed one executed step's wall-clock duration (no-op unless the
        source actually consumes measurements)."""

    def report(self) -> Dict[str, object]:
        return {"kind": self.kind}


class SimTimingSource(TimingSource):
    """Stage 2 closed on the analytic simulator — the historical default.

    ``timings_for`` is exactly the pre-control-plane ``record_call`` body:
    one ``measure`` at the call's true payload and the balancer's current
    fractions, including the simulator's noise stream in order."""

    kind = "sim"

    def timings_for(self, op, n_ranks, payload_bytes, fractions, *,
                    bucket=None, member_weights=None, contention=1.0,
                    codecs=None):
        if codecs:
            return self.model.measure(op, n_ranks, payload_bytes, fractions,
                                      member_weights=member_weights,
                                      contention=contention, codecs=codecs)
        # no-codec slots call the exact historical signature — same float
        # ops, same noise stream (the §10 parity discipline)
        return self.model.measure(op, n_ranks, payload_bytes, fractions,
                                  member_weights=member_weights,
                                  contention=contention)


@dataclasses.dataclass
class _SlotRates:
    """Measured-mode state for one (op, bucket) slot."""

    rates: Dict[str, float] = dataclasses.field(default_factory=dict)
    last_fractions: Optional[Dict[str, float]] = None
    last_call_s: Optional[float] = None
    sim_consults: int = 0           # bootstrap weight queries (per path)
    updates: int = 0                # finite-difference rate refinements


class MeasuredTimingSource(TimingSource):
    """Stage 2 closed on wall-clock observation.

    Per slot, each path holds a *rate* r_p (seconds per unit share): the
    estimated per-path completion time at fractions f is ``f_p * r_p``.
    Rates bootstrap from the simulator (so the very first estimates
    reproduce its relative weights) and are thereafter refined ONLY from
    measured step durations:

    * ``ingest_step`` apportions one step's measured duration over the
      replay multiset proportionally to the calls' estimated times, giving
      a per-call measured completion time;
    * when a slot's share vector changed since its previous observation
      (a Stage-2 move or a SlotController probe), the step-time delta is
      attributed to the path whose share decreased:
      ``r_obs = (T_prev - T_now) / Δshare`` — exact if that path was the
      bottleneck, clamped at zero otherwise — and EWMA-folded into r_p.

    The balancer only ever compares *relative* per-path times, so no
    absolute wall-clock calibration is needed; compute time inside the
    measured step cancels out of the gap the same way the simulator's
    fixed overheads do.
    """

    kind = "measured"

    def __init__(self, model: PathTimingModel, ewma: float = RATE_EWMA,
                 event_recorder: Optional["EventRecorder"] = None):
        super().__init__(model)
        self.ewma = ewma
        self._slots: Dict[Tuple[Collective, int], _SlotRates] = {}
        self.steps_ingested = 0
        #: injected per-path event recorder (CUDA-event / TPU-trace shaped;
        #: see :class:`EventRecorder`).  When present, per-call per-path
        #: completion times come from hardware events and the scalar
        #: finite-difference rule below is bypassed entirely.
        self.events = event_recorder
        self.event_updates = 0

    # -- rate bookkeeping ----------------------------------------------------

    def _slot(self, op: Collective, bucket: int) -> _SlotRates:
        return self._slots.setdefault((op, bucket), _SlotRates())

    def _ensure_rates(self, op: Collective, n_ranks: int, bucket: int,
                      payload_bytes: int,
                      fractions: Mapping[str, float]) -> _SlotRates:
        st = self._slot(op, bucket)
        missing = [p for p, f in fractions.items()
                   if f > 0.0 and p not in st.rates]
        if missing:
            # the ONLY simulator consultation in measured mode: bootstrap
            # apportionment weights for paths first seen carrying share
            sim = self.model.measure(op, n_ranks, payload_bytes, fractions)
            for p in missing:
                st.rates[p] = sim[p] / fractions[p]
                st.sim_consults += 1
        return st

    def estimates(self, op: Collective, bucket: int,
                  fractions: Mapping[str, float]) -> Dict[str, float]:
        st = self._slot(op, bucket)
        return {p: (f * st.rates.get(p, 0.0) if f > 0.0 else 0.0)
                for p, f in fractions.items()}

    # -- TimingSource API ----------------------------------------------------

    def timings_for(self, op, n_ranks, payload_bytes, fractions, *,
                    bucket=None, member_weights=None, contention=1.0,
                    codecs=None):
        # contention and codecs accepted but unused: measured wall clock
        # already embeds whatever overlap (and wire compression) actually
        # happened on the fabric.
        # member_weights accepted but unpriced: one scalar step duration
        # cannot attribute slowness to an INSTANCE (the module-docstring
        # observability caveat, one level deeper).  Per-member hardware
        # counters are the ROADMAP's per-path event timing item; until
        # then DegradedTimingSource emulates them for fault injection.
        bucket = bucket if bucket is not None else int(payload_bytes)
        self._ensure_rates(op, n_ranks, bucket, payload_bytes, fractions)
        return self.estimates(op, bucket, fractions)

    def ingest_step(self, calls: Sequence[StepCall],
                    elapsed_s: Optional[float]) -> None:
        if not calls:
            return
        if self.events is not None and self._ingest_events(calls):
            return
        if elapsed_s is None or elapsed_s <= 0.0:
            return
        self.steps_ingested += 1
        # estimated per-call completion times → apportionment weights
        est: List[float] = []
        for op, n_ranks, bucket, nbytes, fractions in calls:
            self._ensure_rates(op, n_ranks, bucket, nbytes, fractions)
            t = self.estimates(op, bucket, fractions)
            est.append(max([v for v in t.values()] or [0.0]))
        total = sum(est)
        if total <= 0.0:
            return
        # per-slot mean measured call time (one slot may replay many calls)
        meas: Dict[Tuple[Collective, int], List[float]] = {}
        fracs_now: Dict[Tuple[Collective, int], Mapping[str, float]] = {}
        for (op, _n, bucket, _b, fractions), t_est in zip(calls, est):
            meas.setdefault((op, bucket), []).append(
                elapsed_s * t_est / total)
            fracs_now[(op, bucket)] = fractions
        for key, samples in meas.items():
            st = self._slots[key]
            t_now = sum(samples) / len(samples)
            fr_now = dict(fracs_now[key])
            if st.last_fractions is not None and st.last_call_s is not None \
                    and fr_now != st.last_fractions:
                self._finite_difference(st, fr_now, t_now)
            st.last_fractions, st.last_call_s = fr_now, t_now

    def _ingest_events(self, calls: Sequence[StepCall]) -> bool:
        """Fold one step's per-path event timings (ROADMAP's per-path
        event timing item).  Each recorded row gives a path's OWN
        completion time directly, so rates update exactly —
        ``r_p = t_p / f_p`` — with no apportionment, no simulator
        bootstrap for event-covered paths, and no drained-path
        attribution guess.  Returns False (fall back to the scalar rule)
        when the recorder produced nothing usable for this step —
        hardware event buffers can drop under load."""
        rows = self.events.record_step(calls)
        if rows is None or len(rows) != len(calls):
            return False
        self.steps_ingested += 1
        for (op, _n, bucket, _b, fractions), row in zip(calls, rows):
            st = self._slot(op, bucket)
            t_max = 0.0
            for path, f in fractions.items():
                if f <= 0.0 or path not in row:
                    continue
                r_obs = max(float(row[path]), 0.0) / f
                prev = st.rates.get(path)
                st.rates[path] = (r_obs if prev is None else
                                  (1.0 - self.ewma) * prev
                                  + self.ewma * r_obs)
                st.updates += 1
                self.event_updates += 1
                t_max = max(t_max, float(row[path]))
            st.last_fractions, st.last_call_s = dict(fractions), t_max
        return True

    def _finite_difference(self, st: _SlotRates, fr_now: Dict[str, float],
                           t_now: float) -> None:
        """Attribute the step-time delta to the drained path (see module
        docstring for why this is the honest scalar-observation rule)."""
        deltas = {p: fr_now.get(p, 0.0) - st.last_fractions.get(p, 0.0)
                  for p in set(fr_now) | set(st.last_fractions)}
        source = min(deltas, key=deltas.get)
        shrink = -deltas[source]
        if shrink <= 0.0:
            return
        r_obs = max((st.last_call_s - t_now) / shrink, 0.0)
        prev = st.rates.get(source, r_obs)
        st.rates[source] = (1.0 - self.ewma) * prev + self.ewma * r_obs
        st.updates += 1

    def report(self) -> Dict[str, object]:
        return {
            "kind": self.kind,
            "steps_ingested": self.steps_ingested,
            "event_recorder": self.events is not None,
            "event_updates": self.event_updates,
            "slots": {
                f"{op.value}@{bucket}": {
                    "rates_s_per_share": {p: float(r)
                                          for p, r in st.rates.items()},
                    "sim_consults": st.sim_consults,
                    "updates": st.updates,
                }
                for (op, bucket), st in sorted(
                    self._slots.items(), key=lambda kv: (kv[0][0].value,
                                                         kv[0][1]))},
        }


class DegradedTimingSource(TimingSource):
    """Per-instance fault-injection overlay for measured mode.

    A scalar wall-clock step duration cannot attribute slowness to one
    NIC rail (the observability caveat above), so a measured-mode run has
    no native per-instance signal — on hardware that signal would come
    from per-NIC counters / CUDA events (the ROADMAP's per-path event
    timing item).  This wrapper emulates those counters: class-level
    timings still come from the wrapped source (wall-clock apportionment,
    probes, finite differences — all unchanged), while member-level
    entries for diverging links are overlaid from the degraded analytic
    model, which is where the injected fault lives
    (``links.degrade_profile``).  The slot's member balancers then drain
    the sick instance exactly as they do under ``SimTimingSource``.

    ``kind`` mirrors the wrapped source: a degraded measured run is still
    a measured run everywhere the control plane branches on the kind.
    """

    def __init__(self, inner: TimingSource):
        super().__init__(inner.model)
        self.inner = inner
        self.kind = inner.kind          # shadow the class attribute

    def stage1_measure(self, op: Collective, n_ranks: int,
                       payload_bytes: int, codecs=None) -> MeasureFn:
        return self.inner.stage1_measure(op, n_ranks, payload_bytes,
                                         codecs=codecs)

    def timings_for(self, op, n_ranks, payload_bytes, fractions, *,
                    bucket=None, member_weights=None, contention=1.0,
                    codecs=None):
        out = dict(self.inner.timings_for(
            op, n_ranks, payload_bytes, fractions, bucket=bucket,
            member_weights=member_weights, contention=contention,
            codecs=codecs))
        if codecs:
            sim = self.model.measure(op, n_ranks, payload_bytes, fractions,
                                     member_weights=member_weights,
                                     contention=contention, codecs=codecs)
        else:
            sim = self.model.measure(op, n_ranks, payload_bytes, fractions,
                                     member_weights=member_weights,
                                     contention=contention)
        # overlay ONLY instance entries (keys the class-level source does
        # not produce): the emulated per-rail counters
        for key, t in sim.items():
            if key not in fractions:
                out[key] = t
        return out

    def ingest_step(self, calls: Sequence[StepCall],
                    elapsed_s: Optional[float]) -> None:
        self.inner.ingest_step(calls, elapsed_s)

    def report(self) -> Dict[str, object]:
        return {"kind": self.kind, "degraded_overlay": True,
                "wraps": self.inner.report()}


class EventRecorder:
    """Per-path event timing interface (ROADMAP: per-path event timing).

    On hardware this is a ring of CUDA events (or a TPU trace window)
    bracketing each path's chunk stream, drained once per step.  The
    contract is deliberately minimal so either backend fits behind it:
    ``record_step`` takes the step's replay multiset and returns one
    mapping per call — ``path -> seconds``, that path's OWN completion
    time — or None when the step produced no usable events (dropped
    buffer, disabled tracing), in which case MeasuredTimingSource falls
    back to its scalar finite-difference rule for that step.
    """

    def record_step(self, calls: Sequence[StepCall]) \
            -> Optional[List[Mapping[str, float]]]:
        raise NotImplementedError


class SimEventRecorder(EventRecorder):
    """Event recorder backed by the analytic simulator — the test double
    the fault suite injects.  Rows come from ``PathTimingModel.measure``
    at each call's true payload and fractions, i.e. exactly the per-path
    times a hardware event ring would report on the modeled fabric."""

    def __init__(self, model: PathTimingModel):
        self.model = model
        self.steps_recorded = 0

    def record_step(self, calls: Sequence[StepCall]) \
            -> Optional[List[Mapping[str, float]]]:
        rows: List[Mapping[str, float]] = []
        for op, n_ranks, _bucket, nbytes, fractions in calls:
            t = self.model.measure(op, n_ranks, nbytes, fractions)
            rows.append({p: t[p] for p, f in fractions.items()
                         if f > 0.0 and p in t})
        self.steps_recorded += 1
        return rows


def attach_event_recorder(timing: TimingSource,
                          recorder: EventRecorder) -> bool:
    """Attach ``recorder`` to the MeasuredTimingSource inside ``timing``
    (unwrapping any DegradedTimingSource overlay).  Returns False when
    the chain bottoms out on a source that cannot consume events (the
    simulator source IS its own oracle) — callers treat that as
    "recorder ignored", not an error, so launchers can request event
    timing unconditionally."""
    src = timing
    while isinstance(src, DegradedTimingSource):
        src = src.inner
    if isinstance(src, MeasuredTimingSource):
        src.events = recorder
        return True
    return False
