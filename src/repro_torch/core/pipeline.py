# Copied from src/repro/core/pipeline.py; only the imports are renamed.
"""Host-staged path: double-buffered pipeline + monotonic-counter protocol.

Paper §3.1: the PCIe route stages GPU→GPU transfers through pinned host
buffers, split into Producer-Device-to-Host (PD2H) and Host-to-Consumer-
Device (H2CD) stages, double-buffered so the PD2H of chunk k overlaps the
H2CD of chunk k-1.  Synchronization uses *monotonically increasing counters*
(semEmpty/semFull) rather than binary semaphores, because a late write to a
reused binary semaphore can satisfy a future wait and let the consumer read
stale data.

On TPU this path would be host DMA driven by host callbacks — it cannot lower
inside a jitted collective, so FlexLink-on-TPU keeps it at the *model* level:
this module is a discrete-event implementation of the exact protocol, used
(a) to property-test the protocol's correctness claims (no stale reads, no
lost chunks, for any interleaving), and (b) to give the timing simulator its
pipelined-throughput estimate for the staged path.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

N_BUFFERS = 2  # double buffering


@dataclasses.dataclass
class SharedBuffer:
    """One pinned host buffer with the paper's counter pair."""

    sem_empty: int = 0   # producer waits for sem_empty == i
    sem_full: int = 0    # consumer waits for sem_full == i + 1
    data: Optional[np.ndarray] = None
    writer_iter: int = -1  # diagnostic: which iteration last wrote


class MonotonicPipe:
    """The §3.1 protocol over a ring of `n_buffers` shared buffers.

    Iteration i uses buffer i % n_buffers.  Producer protocol for iteration
    i: wait(sem_empty == i) → write → set peer sem_full = i + 1.  Consumer:
    wait(sem_full == i + 1) → read → set sem_empty = i + 1.

    ``try_produce``/``try_consume`` return False instead of blocking, so a
    scheduler (or hypothesis) can drive *any* interleaving; correctness means
    every consumed chunk equals the chunk produced for that iteration.
    """

    def __init__(self, n_buffers: int = N_BUFFERS):
        self.n_buffers = n_buffers
        self.buffers = [SharedBuffer() for _ in range(n_buffers)]
        # per-buffer iteration counters advance by 1 each reuse round
        self._prod_iter = 0
        self._cons_iter = 0

    def _buf(self, i: int) -> SharedBuffer:
        return self.buffers[i % self.n_buffers]

    # producer side -----------------------------------------------------------
    def can_produce(self) -> bool:
        i = self._prod_iter
        return self._buf(i).sem_empty == i // self.n_buffers

    def try_produce(self, chunk: np.ndarray) -> bool:
        if not self.can_produce():
            return False
        i = self._prod_iter
        b = self._buf(i)
        b.data = np.array(chunk, copy=True)
        b.writer_iter = i
        b.sem_full = i // self.n_buffers + 1   # set peer semFull = i+1
        self._prod_iter += 1
        return True

    # consumer side -----------------------------------------------------------
    def can_consume(self) -> bool:
        i = self._cons_iter
        return self._buf(i).sem_full == i // self.n_buffers + 1

    def try_consume(self) -> Optional[np.ndarray]:
        if not self.can_consume():
            return None
        i = self._cons_iter
        b = self._buf(i)
        out = b.data
        assert b.writer_iter == i, (
            f"stale read: consumer iter {i} read data written at iter "
            f"{b.writer_iter}")
        b.sem_empty = i // self.n_buffers + 1  # set semEmpty = i+1
        self._cons_iter += 1
        return out


class BrokenBinaryPipe(MonotonicPipe):
    """The *binary*-semaphore variant the paper rejects.

    Booleans instead of counters: a late/reordered write can satisfy a future
    wait.  Used by tests to demonstrate the failure mode the monotonic
    counters prevent (stale read across reuse rounds).
    """

    def can_produce(self) -> bool:
        return self._buf(self._prod_iter).sem_empty == 0 or \
            self._buf(self._prod_iter).sem_empty >= self._prod_iter // self.n_buffers

    def try_produce(self, chunk: np.ndarray) -> bool:  # over-permissive wait
        i = self._prod_iter
        b = self._buf(i)
        b.data = np.array(chunk, copy=True)
        b.writer_iter = i
        b.sem_full = 1                                  # binary "full"
        self._prod_iter += 1
        return True

    def can_consume(self) -> bool:
        return self._buf(self._cons_iter).sem_full == 1

    def try_consume(self) -> Optional[np.ndarray]:
        if not self.can_consume():
            return None
        i = self._cons_iter
        b = self._buf(i)
        out = b.data
        stale = b.writer_iter != i
        b.sem_empty = 1
        b.sem_full = 0
        self._cons_iter += 1
        # no assert — the caller checks for staleness
        return None if stale else out


# ---------------------------------------------------------------------------
# pipelined-throughput model for the staged path
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageTimes:
    pd2h_GBps: float     # producer device -> host
    h2cd_GBps: float     # host -> consumer device
    per_chunk_us: float  # sync + launch per chunk


def pipeline_time_s(total_bytes: float, chunk_bytes: float,
                    st: StageTimes, n_buffers: int = N_BUFFERS) -> float:
    """Completion time of a double-buffered PD2H/H2CD pipeline.

    With >=2 buffers the steady state is bounded by the slower stage; the
    other stage's first (and last) chunk adds a fill/drain bubble.
    """
    if total_bytes <= 0:
        return 0.0
    chunk_bytes = min(chunk_bytes, total_bytes)
    n_chunks = int(np.ceil(total_bytes / chunk_bytes))
    t_a = chunk_bytes / (st.pd2h_GBps * 1e9) + st.per_chunk_us * 1e-6
    t_b = chunk_bytes / (st.h2cd_GBps * 1e9) + st.per_chunk_us * 1e-6
    if n_buffers >= 2:
        slow, fast = max(t_a, t_b), min(t_a, t_b)
        return n_chunks * slow + fast          # overlap: fill/drain bubble
    return n_chunks * (t_a + t_b)              # no overlap


def optimal_chunk_bytes(total_bytes: float, st: StageTimes,
                        candidates: Sequence[float] = (
                            1 << 20, 2 << 20, 4 << 20, 8 << 20, 16 << 20),
                        ) -> float:
    """Pick the chunk size minimizing pipeline time — the paper lands on 4 MB
    for both PCIe and RDMA buffers (§5.1); this reproduces that trade-off
    (big chunks amortize per-chunk overhead, small chunks reduce bubbles)."""
    return min(candidates,
               key=lambda c: pipeline_time_s(total_bytes, c, st))
