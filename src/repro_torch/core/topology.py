# Copied from src/repro/core/topology.py; only the imports are renamed.
"""Ring topology model: step counts and wire factors per collective.

FlexLink (§3.1) adopts "a classic yet efficient ring-based model" on every
path.  For a ring over N ranks moving a payload of B bytes per rank:

  all_gather      : N-1 sequential steps, wire bytes per rank = B * (N-1)
  reduce_scatter  : N-1 steps,            wire bytes per rank = B * (N-1)/N
  all_reduce      : 2(N-1) steps (RS+AG), wire bytes per rank = 2B * (N-1)/N
  all_to_all      : N-1 steps,            wire bytes per rank = B * (N-1)/N
  broadcast       : N-1 steps (pipelined),wire bytes per rank = B

The paper's key Table-2 effect — 8-GPU AllReduce barely improves — falls out
of the 2(N-1) step count multiplying secondary-path step latency.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence


class Collective(enum.Enum):
    ALL_REDUCE = "all_reduce"
    ALL_GATHER = "all_gather"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_TO_ALL = "all_to_all"
    BROADCAST = "broadcast"


@dataclasses.dataclass(frozen=True)
class RingSchedule:
    """Sequential step count and payload-to-wire-bytes factor for one ring."""

    collective: Collective
    n_ranks: int

    @property
    def steps(self) -> int:
        n = self.n_ranks
        if n <= 1:
            return 0
        if self.collective is Collective.ALL_REDUCE:
            return 2 * (n - 1)
        return n - 1

    def wire_bytes(self, payload_bytes: float) -> float:
        """Bytes each rank pushes onto its egress link for `payload_bytes`.

        `payload_bytes` is the per-rank *input* payload (message size in the
        nccl-tests sense for all_reduce; per-rank shard for all_gather).
        """
        n = self.n_ranks
        if n <= 1:
            return 0.0
        c = self.collective
        if c is Collective.ALL_REDUCE:
            return 2.0 * payload_bytes * (n - 1) / n
        if c in (Collective.REDUCE_SCATTER, Collective.ALL_TO_ALL):
            return payload_bytes * (n - 1) / n
        if c is Collective.ALL_GATHER:
            return payload_bytes * (n - 1)
        if c is Collective.BROADCAST:
            return payload_bytes
        raise ValueError(c)

    def algbw_factor(self, payload_bytes: float) -> float:
        """nccl-tests algorithm-bandwidth numerator (bytes) for this op."""
        return payload_bytes


def ring_order(n: int, offset: int = 0) -> List[int]:
    """Rank order of a ring over n ranks, rotated by `offset`.

    Distinct offsets give edge-disjoint rings on a fully-connected fabric —
    how multiple paths avoid reusing the same physical wires.
    """
    return [(i + offset) % n for i in range(n)]


def neighbors(rank: int, n: int) -> tuple:
    """(prev, next) of `rank` on the canonical ring."""
    return ((rank - 1) % n, (rank + 1) % n)
