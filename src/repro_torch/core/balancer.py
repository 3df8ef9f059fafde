# Copied from src/repro/core/balancer.py; only the imports are renamed.
"""Stage 2 — runtime fine-grained adjustment (paper §3.2.2).

An *Evaluator* passively records per-path completion times for every
collective call; a *Load Balancer* is invoked only periodically, analyses the
most recent window (default 10 calls) for a persistent trend, and — if the
slow/fast gap exceeds a threshold — moves one small fixed share from the
slowest to the fastest path, prioritizing the primary link.  Gradualism is
the point: it must not react to transient spikes (paper Fig. 5).
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.tuner import SHARE_GRID

RUNTIME_WINDOW = 10            # paper: "the last 10 collective calls"
RUNTIME_GAP_THRESHOLD = 0.15   # relative slow/fast gap that triggers a move
RUNTIME_STEP = 1               # grid units moved per adjustment (small+fixed)
INVOKE_PERIOD = 10             # balancer runs every N calls (periodic)


@dataclasses.dataclass
class Adjustment:
    call_index: int
    source: str
    target: str
    moved: int
    gap: float
    shares_after: Dict[str, int]
    #: "balance" = the §3.2.2 gap rule fired; "probe" = a measured-mode
    #: exploration move (control/slots.py) — reports tell them apart.
    kind: str = "balance"


class Evaluator:
    """Passively monitors path completion times over a sliding window."""

    def __init__(self, window: int = RUNTIME_WINDOW):
        self.window = window
        self._history: Deque[Dict[str, float]] = collections.deque(maxlen=window)

    def record(self, timings: Mapping[str, float]) -> None:
        self._history.append(dict(timings))

    def __len__(self) -> int:
        return len(self._history)

    def trend(self, active: Sequence[str]) -> Optional[Dict[str, float]]:
        """Median per-path time over the window; None until window is full.

        The median (not mean) is what makes the balancer ignore transient
        spikes: a single slow call cannot shift the median of a full window.

        A path with NO samples in the window — typically one the balancer
        just re-activated from share 0, whose timings the caller has not
        started reporting yet — is skipped rather than stalling the whole
        trend: returning None here would freeze Stage 2 for a full window
        every time a path comes back (regression in tests/test_balancer.py).
        """
        if len(self._history) < self.window:
            return None
        out: Dict[str, float] = {}
        for p in active:
            vals = [h[p] for h in self._history if p in h]
            if vals:
                out[p] = statistics.median(vals)
        return out

    def describe(self) -> Dict[str, int]:
        """Window occupancy for reporting (SlotController.describe)."""
        return {"window": self.window, "samples": len(self._history)}


class LoadBalancer:
    """Periodically rebalances shares based on the Evaluator's trend."""

    def __init__(self, shares: Mapping[str, int], primary: str, *,
                 window: int = RUNTIME_WINDOW,
                 gap_threshold: float = RUNTIME_GAP_THRESHOLD,
                 step: int = RUNTIME_STEP,
                 invoke_period: int = INVOKE_PERIOD,
                 grid: int = SHARE_GRID,
                 allow_primary_reactivation: bool = True):
        self.shares: Dict[str, int] = dict(shares)
        assert sum(self.shares.values()) == grid
        self.primary = primary
        self.grid = grid
        self.gap_threshold = gap_threshold
        self.step = step
        self.invoke_period = invoke_period
        #: whether a primary that Stage 1 deactivated (share 0) may be
        #: re-activated by runtime moves.  The paper's §3.2.2 NVLink-first
        #: rule implies yes: the primary is the best-effective link, so
        #: share freed from a degraded secondary should return to it even
        #: from zero.  Set False to pin deactivated paths off.
        self.allow_primary_reactivation = allow_primary_reactivation
        self.evaluator = Evaluator(window)
        self.calls = 0
        self.adjustments: List[Adjustment] = []

    @property
    def active(self) -> List[str]:
        return [p for p, s in self.shares.items() if s > 0]

    def fractions(self) -> Dict[str, float]:
        return {p: s / self.grid for p, s in self.shares.items()}

    def last_adjustments(self, k: int = 8) -> List[Adjustment]:
        """The most recent <=k adjustments, oldest first — the trajectory
        slice reports surface."""
        return list(self.adjustments[-k:]) if k > 0 else []

    def move(self, source: str, target: str, units: int = 1, *,
             gap: float = 0.0, kind: str = "balance") -> Optional[Adjustment]:
        """Apply one validated share move and record it.  The single place
        shares change: enforces tracked paths, non-negativity, and the
        primary-reactivation pin for every caller (the periodic gap rule
        below and the control plane's probe moves alike)."""
        if source == target or source not in self.shares \
                or target not in self.shares:
            return None
        if (target == self.primary and self.shares[self.primary] == 0
                and not self.allow_primary_reactivation):
            return None
        moved = min(units, self.shares[source])
        if moved <= 0:
            return None
        self.shares[source] -= moved
        self.shares[target] += moved
        adj = Adjustment(self.calls, source, target, moved, gap,
                         dict(self.shares), kind=kind)
        self.adjustments.append(adj)
        return adj

    def observe(self, timings: Mapping[str, float], *,
                allow_adjust: bool = True) -> Optional[Adjustment]:
        """Record one collective call; maybe rebalance (periodic).

        ``allow_adjust=False`` records the sample but suppresses the gap
        rule for this call — the SlotController holds class-level moves
        while one of its member balancers has an unresolved intra-class
        imbalance (a drain in progress): the class's aggregate time is
        transient until the sick instance is rebalanced, so reacting to it
        would thrash share across classes (DESIGN.md §10).

        Returns the adjustment made, if any.
        """
        self.calls += 1
        self.evaluator.record({p: timings[p] for p in self.active
                               if p in timings})
        if not allow_adjust or self.calls % self.invoke_period != 0:
            return None
        return self._maybe_adjust()

    def _trend_gap(self) -> Optional[Tuple[str, str, float]]:
        """(slowest, fastest, relative gap) of the current trend, or None
        while the window/sampled-path count cannot support a comparison."""
        active = self.active
        if len(active) < 2:
            return None
        trend = self.evaluator.trend(active)
        if trend is None or len(trend) < 2:
            return None             # <2 sampled paths: no gap to compare
        slow = max(trend, key=trend.get)
        fast = min(trend, key=trend.get)
        t_fast = trend[fast]
        gap = (trend[slow] - t_fast) / t_fast if t_fast > 0 else 0.0
        return slow, fast, gap

    def current_gap(self) -> float:
        """The live trend gap (0.0 when not computable) — what the slot's
        hold rule inspects without consuming an adjustment."""
        tg = self._trend_gap()
        return tg[2] if tg is not None else 0.0

    def _maybe_adjust(self) -> Optional[Adjustment]:
        tg = self._trend_gap()
        if tg is None:
            return None
        slow, fast, gap = tg
        if gap <= self.gap_threshold:
            return None
        # Move a small fixed share from the slowest to the fastest path,
        # prioritizing the primary link (paper §3.2.2).  The primary is a
        # valid target only if this balancer actually tracks it (guards
        # against conjuring shares for an unknown path) and either still
        # holds share or may be re-activated.
        target = fast
        if slow != self.primary and self.primary in self.shares:
            if (self.shares[self.primary] > 0
                    or self.allow_primary_reactivation):
                target = self.primary
        return self.move(slow, target, self.step, gap=gap)
