"""repro_torch.faults — live fabric dynamics (DESIGN.md §14).

Port of ``src/repro/faults/``: link/member health as a *time-varying*
input to the whole stack — a fault-schedule DSL (schedule.py, a copy), a
hysteresis-gated clock that applies committed transitions to the live
communicators (clock.py, a copy), and the elastic node-loss resume
(elastic.py), which rebuilds the process groups over the surviving ranks.
Fault-free runs never construct any of this: no ``--fault`` means
byte-identical plans, Stage-1 trajectories and tuning caches.
"""

from repro_torch.faults.clock import FabricClock, HYSTERESIS_K
from repro_torch.faults.elastic import (NodeLeft, make_train_resume,
                                        restore_templates)
from repro_torch.faults.schedule import (FabricState, FaultEvent,
                                         HealthTimeline, parse_fault_item,
                                         parse_fault_schedule,
                                         validate_schedule)

__all__ = [
    "FabricClock",
    "FabricState",
    "FaultEvent",
    "HYSTERESIS_K",
    "HealthTimeline",
    "NodeLeft",
    "make_train_resume",
    "parse_fault_item",
    "parse_fault_schedule",
    "restore_templates",
    "validate_schedule",
]
