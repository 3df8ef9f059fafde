"""Continuous-batching scheduler (host side, no JAX).

Port of ``src/repro/serving/scheduler.py`` (a copy: it is plain Python).

Request lifecycle (DESIGN.md §13)::

    WAITING --admit--> PREFILL --caught up--> DECODE --EOS/max_new--> FINISHED
       ^                  |                      |
       +---- PREEMPTED <--+----------------------+   (blocks ran out)

Every tick the scheduler packs token rows into a budget of
``max_tokens_in_flight`` rows — the TensorRT-LLM gpt_attention split of
*context phase* (prefill chunks) and *generation phase* (one row per
caught-up request) over one non-padded packed layout:

* **generation rows first**: every request whose cache frontier equals its
  sequence frontier contributes exactly one row (its last token) — decode
  latency is protected from long prefills;
* **context rows fill the rest**: requests still writing their sequence
  into the cache get chunks of the remaining budget, in admission order.

A request's *sequence* is ``prompt + out`` — sampling only ever happens at
the sequence frontier (the packed row feeding ``seq[-1]``), so a request
resumed after preemption re-prefills ``prompt + out`` teacher-forced and
continues its greedy stream bit-identically: re-prefill recomputes the
same K/V the evicted blocks held.

Block accounting delegates to :class:`~repro_torch.serving.paged_kv.PagedKVCache`;
when ``ensure`` raises, the scheduler preempts-by-eviction: the LATEST
admitted active request (that is not already packed this tick) releases
all its blocks and re-queues at the FRONT of the wait queue.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.paged_kv import NoFreeBlocks, PagedKVCache


@dataclasses.dataclass
class PagedRequest:
    rid: int
    prompt: List[int]
    max_new: int = 16
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    #: cache frontier — token positions [0, done) are written to the pool
    done: int = 0
    #: request row (block-table row / logits row) while admitted, else -1
    row: int = -1
    #: admission sequence number — eviction victims are picked newest-first
    adm_seq: int = -1
    preemptions: int = 0

    @property
    def seq(self) -> List[int]:
        return self.prompt + self.out

    @property
    def frontier(self) -> int:
        """Position of the last feedable token (sampling happens here)."""
        return len(self.seq) - 1


@dataclasses.dataclass
class TickPlan:
    """One tick's packed rows: ``rows[i] = (row, position, token)``.

    ``sample_rows`` maps a request row to the packed index of its sequence-
    frontier row — the only rows whose logits are sampled this tick."""
    rows: List[Tuple[int, int, int]]
    sample_rows: Dict[int, int]

    @property
    def n_rows(self) -> int:
        return len(self.rows)


class ContinuousScheduler:
    def __init__(self, cache: PagedKVCache, *, max_requests: int,
                 max_tokens_in_flight: int, eos_id: int = -1):
        assert max_requests <= max_tokens_in_flight, \
            "every decode row must fit one tick"
        self.cache = cache
        self.max_requests = max_requests
        self.max_tokens_in_flight = max_tokens_in_flight
        self.eos_id = eos_id
        self.queue: Deque[PagedRequest] = collections.deque()
        self.active: List[Optional[PagedRequest]] = [None] * max_requests
        self._adm_seq = 0
        # observability (comm_report serving block)
        self.admitted = 0
        self.retired = 0
        self.preemptions = 0

    # -- client ----------------------------------------------------------------

    def submit(self, req: PagedRequest) -> None:
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(self.active)

    def in_flight(self) -> int:
        return sum(1 for r in self.active if r is not None)

    # -- admission / eviction --------------------------------------------------

    def _free_row(self) -> Optional[int]:
        for r, req in enumerate(self.active):
            if req is None:
                return r
        return None

    def _admit(self) -> None:
        """FIFO admission: the queue head is admitted when a request row is
        free and the pool has room for its whole sequence plus one sampled
        token.  No head-of-line skipping — admission order is part of the
        engine's determinism contract."""
        while self.queue:
            row = self._free_row()
            if row is None:
                return
            req = self.queue[0]
            if self.cache.free_tokens < len(req.seq) + 1:
                return
            self.queue.popleft()
            req.row = row
            req.done = 0
            req.adm_seq = self._adm_seq
            self._adm_seq += 1
            self.active[row] = req
            self.admitted += 1

    def _evict_one(self, keep_rows) -> bool:
        """Preempt the latest-admitted active request not in ``keep_rows``:
        release its blocks and re-queue it at the wait-queue FRONT."""
        victim = None
        for req in self.active:
            if req is None or req.row in keep_rows:
                continue
            if victim is None or req.adm_seq > victim.adm_seq:
                victim = req
        if victim is None:
            return False
        self.cache.release(victim.row)
        self.active[victim.row] = None
        victim.row = -1
        victim.done = 0
        victim.preemptions += 1
        self.queue.appendleft(victim)
        self.preemptions += 1
        return True

    def _ensure_with_eviction(self, req: PagedRequest, n_tokens: int,
                              keep_rows) -> bool:
        while True:
            try:
                self.cache.ensure(req.row, n_tokens)
                return True
            except NoFreeBlocks:
                if not self._evict_one(keep_rows | {req.row}):
                    return False

    # -- tick planning ---------------------------------------------------------

    def plan_tick(self) -> TickPlan:
        self._admit()
        budget = self.max_tokens_in_flight
        rows: List[Tuple[int, int, int]] = []
        sample_rows: Dict[int, int] = {}
        packed_rows = set()
        order = sorted((r for r in self.active if r is not None),
                       key=lambda r: r.adm_seq)

        # generation phase: one row per caught-up request
        for req in order:
            if budget <= 0:
                break
            if req.row < 0:                   # evicted earlier this tick
                continue
            if req.done != req.frontier:
                continue
            if not self._ensure_with_eviction(req, req.done + 1,
                                              packed_rows):
                continue                      # stalls this tick
            sample_rows[req.row] = len(rows)
            rows.append((req.row, req.done, req.seq[req.done]))
            packed_rows.add(req.row)
            budget -= 1

        # context phase: chunk the remaining budget over prefilling rows
        for req in order:
            if budget <= 0:
                break
            if req.row < 0 or req.row in packed_rows:
                continue                      # evicted this tick, or packed
            if req.done >= req.frontier:
                continue
            n = min(budget, req.frontier + 1 - req.done)
            if not self._ensure_with_eviction(req, req.done + n,
                                              packed_rows):
                # partial chunk: whatever the already-attached blocks hold
                n = min(n, self.cache.tokens_capacity(req.row) - req.done)
                if n <= 0:
                    continue
            seq = req.seq
            for i in range(n):
                pos = req.done + i
                if pos == req.frontier:
                    sample_rows[req.row] = len(rows)
                rows.append((req.row, pos, seq[pos]))
            packed_rows.add(req.row)
            budget -= n
        return TickPlan(rows, sample_rows)

    # -- commit ----------------------------------------------------------------

    def commit(self, plan: TickPlan,
               sampled: Dict[int, int]) -> List[PagedRequest]:
        """Advance frontiers for the executed plan, append the sampled
        tokens, retire finished requests (returned)."""
        last_pos: Dict[int, int] = {}
        for row, pos, _tok in plan.rows:
            last_pos[row] = max(pos, last_pos.get(row, -1))
        for row, pos in last_pos.items():
            req = self.active[row]
            assert req is not None
            req.done = pos + 1
        finished = []
        for row, tok in sampled.items():
            req = self.active[row]
            assert req is not None and plan.sample_rows.get(row) is not None
            req.out.append(tok)
            if len(req.out) >= req.max_new or tok == self.eos_id:
                self.cache.release(row)
                self.active[row] = None
                req.row = -1
                self.retired += 1
                finished.append(req)
        return finished

    def report(self) -> Dict[str, object]:
        return {
            "admitted": self.admitted,
            "retired": self.retired,
            "preemptions": self.preemptions,
            "waiting": len(self.queue),
            "in_flight": self.in_flight(),
        }
