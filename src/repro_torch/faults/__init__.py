"""repro_torch.faults — live fabric dynamics (DESIGN.md §14).

Port of ``src/repro/faults/``.  Only the fault-schedule DSL
(``schedule.py``, a copy) is here: ``configs/clusters.resolve_faults``
parses ``--degrade`` through it.  The hysteresis-gated clock
(``clock.py``) and the elastic node-loss resume (``elastic.py``) come
with ROADMAP queue 1 item 13.
"""

from repro_torch.faults.schedule import (FabricState, FaultEvent,
                                         HealthTimeline, parse_fault_item,
                                         parse_fault_schedule,
                                         validate_schedule)

__all__ = [
    "FabricState",
    "FaultEvent",
    "HealthTimeline",
    "parse_fault_item",
    "parse_fault_schedule",
    "validate_schedule",
]
