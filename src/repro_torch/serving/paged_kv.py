"""Paged KV-cache block management (host side).

Port of ``src/repro/serving/paged_kv.py`` (a copy: it is plain numpy).

The device-side KV pool is a dense tensor of fixed-size blocks
(``[L, n_blocks, block_size, kv_w, hd]`` per K and V, models/transformer.py
``init_paged_pool``); this module owns everything about WHICH blocks hold
WHOSE tokens:

* :class:`BlockAllocator` — a LIFO free list over the pool's block ids.
  Freed blocks are reused immediately and verbatim (no zeroing pass):
  stale K/V rows in a reused block are masked out of attention by the
  per-token ``kv_valid`` bound, and masked lanes contribute exact zeros
  (models/layers.py chunked_attention), so reuse is defragmentation-free
  by construction — vLLM's PagedAttention invariant.

* :class:`PagedKVCache` — per-request block tables: row r of ``tables``
  maps request-row r's logical block j (token positions ``j*bs ..
  (j+1)*bs-1``) to a physical pool block.  ``ensure`` grows a row's table
  to cover a token count, ``release`` returns the row's blocks to the
  free list.  Tables are plain numpy — the engine ships them to the
  device as one small int32 array per tick.

Capacity pressure is the CALLER's problem: ``ensure`` raising
:class:`NoFreeBlocks` is the scheduler's signal to preempt-by-eviction
(serving/scheduler.py), not an error state here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


class NoFreeBlocks(Exception):
    """The pool is exhausted — the scheduler must evict or defer."""


@dataclasses.dataclass
class AllocStats:
    allocs: int = 0
    frees: int = 0
    peak_in_use: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class BlockAllocator:
    """LIFO free list over ``n_blocks`` physical block ids."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = n_blocks
        # LIFO: block 0 is handed out first, and the most recently freed
        # block is reused next — keeps the hot working set compact and
        # makes reuse-after-free deterministic for tests.
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.stats = AllocStats()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise NoFreeBlocks(f"all {self.n_blocks} KV blocks in use")
        blk = self._free.pop()
        self.stats.allocs += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return blk

    def free(self, block: int) -> None:
        assert 0 <= block < self.n_blocks, block
        assert block not in self._free, f"double free of block {block}"
        self._free.append(block)
        self.stats.frees += 1

    def report(self) -> Dict[str, int]:
        out = self.stats.as_dict()
        out["total"] = self.n_blocks
        out["in_use"] = self.in_use
        return out


class PagedKVCache:
    """Per-request-row block tables over one :class:`BlockAllocator`.

    ``max_requests`` rows; each row covers at most ``max_blocks_per_req``
    logical blocks (= ceil(cache_len / block_size) for the engine's
    request-length cap).  Unallocated table entries stay 0 — they are
    never read unmasked, because attention masks every position >=
    ``kv_valid`` and the engine only marks positions it has written.
    """

    def __init__(self, n_blocks: int, block_size: int,
                 max_blocks_per_req: int, max_requests: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = BlockAllocator(n_blocks)
        self.block_size = block_size
        self.max_blocks_per_req = max_blocks_per_req
        self.max_requests = max_requests
        self.tables = np.zeros((max_requests, max_blocks_per_req), np.int32)
        self._counts = np.zeros(max_requests, np.int32)  # blocks per row

    # -- queries ---------------------------------------------------------------

    def blocks_of(self, row: int) -> List[int]:
        return self.tables[row, : self._counts[row]].tolist()

    def n_blocks_of(self, row: int) -> int:
        return int(self._counts[row])

    def tokens_capacity(self, row: int) -> int:
        """Token positions row ``row`` can hold without a new alloc."""
        return int(self._counts[row]) * self.block_size

    @property
    def free_tokens(self) -> int:
        return self.allocator.free_blocks * self.block_size

    def utilization(self) -> float:
        return self.allocator.in_use / self.allocator.n_blocks

    # -- mutation --------------------------------------------------------------

    def ensure(self, row: int, n_tokens: int) -> None:
        """Grow row ``row``'s table to cover ``n_tokens`` positions.

        Raises :class:`NoFreeBlocks` when the pool runs dry — blocks
        allocated before the failure stay attached to the row (they hold
        no tokens yet; a later retry continues from them)."""
        need = -(-n_tokens // self.block_size)
        if need > self.max_blocks_per_req:
            raise ValueError(
                f"request needs {need} blocks > per-request cap "
                f"{self.max_blocks_per_req} (cache_len too small?)")
        while self._counts[row] < need:
            blk = self.allocator.alloc()       # may raise NoFreeBlocks
            self.tables[row, self._counts[row]] = blk
            self._counts[row] += 1

    def release(self, row: int) -> int:
        """Free every block of row ``row``; returns the count freed."""
        n = int(self._counts[row])
        for j in range(n):
            self.allocator.free(int(self.tables[row, j]))
        self.tables[row, :n] = 0
        self._counts[row] = 0
        return n

    def report(self) -> Dict[str, object]:
        rep: Dict[str, object] = dict(self.allocator.report())
        rep["block_size"] = self.block_size
        rep["utilization"] = round(self.utilization(), 4)
        return rep
