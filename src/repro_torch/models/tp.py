"""Parallelism context — how model code reaches the communication backend.

Port of ``src/repro/models/tp.py`` for one device (tp = dp = node = pod
= 1).  Model layers call collectives only through a ``ParallelCtx``; on
one device every collective is the identity and there are no
communicators, so the program API (``register_program``, ``recording``,
``observe_program``, ``plan_signature``, ``await_all``, ``comms``,
``comm_report``, ``tuning_status``) keeps the reference's single-device
behaviour: constant signature, no Stage-2 feedback, empty reports.

An axis wider than 1 needs the process-group mesh, the data plane and the
communicator (ROADMAP queue 1, items 3-5) and raises until they land.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch

_NEEDS_COMMS = ("ParallelCtx with an axis wider than 1 needs the "
                "process-group mesh, data plane and communicator "
                "(ROADMAP queue 1, items 3-5), not ported yet")


@dataclasses.dataclass
class ParallelCtx:
    """Axis names + sizes for one step function (single device only)."""

    tp_axis: Optional[str] = None
    dp_axis: Optional[str] = None
    node_axis: Optional[str] = None
    pod_axis: Optional[str] = None
    tp_size: int = 1
    dp_size: int = 1
    node_size: int = 1
    pod_size: int = 1

    def __post_init__(self):
        if max(self.tp_size, self.dp_size, self.node_size,
               self.pod_size) > 1:
            raise NotImplementedError(_NEEDS_COMMS)

    # -- plan-engine plumbing -------------------------------------------------

    def comms(self) -> Tuple[object, ...]:
        """The live communicators behind this ctx: none on one device."""
        return ()

    # -- StepProgram registration (runtime/program.py, DESIGN.md §7) ----------

    def register_program(self, name: str) -> str:
        return name

    def unregister_program(self, name: str) -> None:
        pass

    @contextlib.contextmanager
    def recording(self, name: str):
        yield

    def await_all(self, tree=None):
        """Barrier for issued plans; with no communicators it returns
        ``tree`` unchanged."""
        return tree

    def observe_program(self, name: str,
                        elapsed_s: Optional[float] = None) -> bool:
        return False

    def timing_kind(self) -> str:
        """"none": a single-device ctx has no timing source."""
        return "none"

    def tuning_status(self) -> Dict[str, Dict[str, object]]:
        return {}

    def plan_signature(self, program: Optional[str] = None) -> Tuple:
        return ()

    def comm_report(self) -> Dict[str, object]:
        return {}

    # -- tensor-parallel collectives (identity on one device) -----------------

    def tp_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_index(self) -> int:
        return 0


def single_device_ctx() -> ParallelCtx:
    return ParallelCtx()
