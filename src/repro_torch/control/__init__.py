# Copied from src/repro/control/__init__.py; only the imports are renamed.
"""Control plane for the FlexLink two-stage load balancer (DESIGN.md §8).

The paper's Communicator is really two machines glued together: a *data
plane* (RoutePlan construction + the collective executors) and a *control
plane* (Algorithm 1 + the §3.2.2 Evaluator/LoadBalancer) that decides the
shares the data plane quantizes.  This package is the control plane as its
own layer:

* :class:`SlotController` — all per-``(collective, size-bucket)`` control
  state (Stage-1 result, Stage-2 balancer, warm/cold provenance) behind
  one object with a single measurement-ingest ``report()``;
* :class:`TimingSource` — where the numbers come from.
  :class:`SimTimingSource` closes the loop on the analytic simulator
  (bit-identical to the pre-control-plane behavior);
  :class:`MeasuredTimingSource` closes it on wall-clock step durations
  observed by the StepProgram runtime, consulting the simulator only for
  bootstrap/apportionment weights;
* :class:`TuningProfile` — persistent store of converged Stage-1 shares,
  so a fresh process warm-starts instead of repaying the paper's "~10 s
  profiling phase" (Blink's precompiled per-topology programs and Meta's
  runtime/transport split argue for exactly this seam — PAPERS.md).
"""

from repro_torch.control.profile import TuningProfile
from repro_torch.control.slots import MEMBER_BASE, PROBE_PERIOD, SlotController
from repro_torch.control.timing import (DegradedTimingSource, EventRecorder,
                                  MeasuredTimingSource, SimEventRecorder,
                                  SimTimingSource, TimingSource,
                                  attach_event_recorder)

__all__ = [
    "DegradedTimingSource",
    "EventRecorder",
    "MEMBER_BASE",
    "MeasuredTimingSource",
    "PROBE_PERIOD",
    "SimEventRecorder",
    "SimTimingSource",
    "SlotController",
    "TimingSource",
    "TuningProfile",
    "attach_event_recorder",
]
