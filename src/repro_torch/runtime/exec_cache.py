"""Executable cache — the missing half of the jit-variant plan cache.

Port of ``src/repro/runtime/exec_cache.py`` (a copy: it is plain Python).

The PlanCache (DESIGN.md §2) proves that Stage 2 oscillates between a tiny
set of quantized RoutePlans; this module makes the host loop exploit that:
jitted step callables are cached keyed by the frozen tuple of every
communicator's current quantized plans (``plan_signature()``), so a Stage-2
move BACK to a previously-seen signature returns the already-compiled
executable instead of re-tracing.  Blink compiles one program per topology
and reuses it; Meta's CCL stack owns compiled collectives in a runtime
layer for the same reason (PAPERS.md) — this cache is that layer's storage.

Counters mirror the plan cache's so the two halves read side by side:

* **hit**     — signature seen before: the cached executable runs, no trace;
* **rebuild** — first time this signature is seen: a fresh trace/compile;
* **evict**   — LRU entry dropped to stay within ``capacity`` (Stage 2
  moves one grid unit at a time, so a small capacity suffices; evictions
  signal pathological oscillation amplitude, worth surfacing).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Hashable, Optional

#: default number of compiled step variants kept live.  Stage 2 moves one
#: grid unit per adjustment and shares quantize onto 16 chunk units, so a
#: real workload oscillates among a handful of plans (DESIGN.md §2).
DEFAULT_CAPACITY = 8


@dataclasses.dataclass
class ExecCacheStats:
    hits: int = 0
    rebuilds: int = 0
    evictions: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ExecutableCache:
    """LRU cache of jitted step callables keyed by plan signature."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self.stats = ExecCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, signature: Hashable) -> bool:
        return signature in self._entries

    def get(self, signature: Hashable) -> Optional[Any]:
        """The cached executable for ``signature`` (refreshed to MRU), or
        None.  A miss records NO stat — the caller must trace and then
        :meth:`put` under the post-trace signature, which is where the
        rebuild is counted."""
        fn = self._entries.get(signature)
        if fn is not None:
            self._entries.move_to_end(signature)
            self.stats.hits += 1
        return fn

    def put(self, signature: Hashable, executable: Any) -> Any:
        """Install a freshly traced executable (counts one rebuild) and
        evict LRU entries beyond capacity."""
        self.stats.rebuilds += 1
        self._entries[signature] = executable
        self._entries.move_to_end(signature)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return executable

    def lookup(self, signature: Hashable,
               builder: Callable[[], Any]) -> Any:
        """get-or-build convenience for keys that are stable across the
        build (StepProgram uses get/put directly because the FIRST trace
        tunes buckets and therefore changes the signature under it)."""
        fn = self.get(signature)
        if fn is None:
            fn = self.put(signature, builder())
        return fn

    def clear(self) -> None:
        self._entries.clear()

    def report(self) -> Dict[str, int]:
        out = self.stats.as_dict()
        out["size"] = len(self)
        out["capacity"] = self.capacity
        return out
