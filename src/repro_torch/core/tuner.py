# Copied from src/repro/core/tuner.py; only the imports are renamed.
"""Stage 1 — initial coarse-grained load tuning (paper Algorithm 1).

Faithful transcription.  Shares are integer "grid units" out of
``SHARE_GRID`` (the jit-variant quantization described in DESIGN.md §2) so a
"share" move is always a whole number of payload chunks; the paper moves
percentage points, which is the SHARE_GRID=100 special case.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.links import NodeProfile
from repro_torch.core.topology import Collective

# Algorithm-1 constants (paper names kept).
INITIAL_ADJUSTMENT_STEP = 8          # grid units (== 8% at grid 100)
CONVERGENCE_THRESHOLD = 0.05         # relative slow/fast imbalance
STABILITY_REQUIRED = 3
MAX_ITERS = 100
SHARE_GRID = 100                     # shares are units out of this grid

#: heuristic initial split: primary gets the dominant share (Alg.1 line 5).
INITIAL_PRIMARY_UNITS = 80

MeasureFn = Callable[[Mapping[str, float]], Mapping[str, float]]


def measure_fn(provider, op: Collective, n_ranks: int,
               payload_bytes: float, codecs=None) -> MeasureFn:
    """Adapt any timing provider exposing ``measure(op, n_ranks, payload,
    fracs)`` — the analytic simulator, a hardware profiler, a replayed
    trace — into the MeasureFn Algorithm 1 consumes.  The tuner is
    source-agnostic: it sees completion times, never where they came from
    (the TimingSource seam of ``repro.control.timing`` builds on this).

    ``codecs`` (link name -> PayloadCodec, DESIGN.md §12) makes the oracle
    price compressed secondary paths at wire bytes + codec cost, so
    Algorithm 1 *chooses* splits that exploit the cheaper wire.  None (the
    default) calls the provider with the exact historical signature —
    byte-identical trajectories for uncompressed slots."""

    def measure(fracs: Mapping[str, float]) -> Mapping[str, float]:
        if codecs:
            return provider.measure(op, n_ranks, payload_bytes, fracs,
                                    codecs=codecs)
        return provider.measure(op, n_ranks, payload_bytes, fracs)

    return measure


@dataclasses.dataclass
class TuneTrace:
    """One Algorithm-1 iteration, for Fig-5-style reporting and tests."""

    iteration: int
    shares: Dict[str, int]
    timings: Dict[str, float]
    slowest: str
    fastest: str
    imbalance: float
    step: int
    moved: int
    deactivated: Optional[str] = None


@dataclasses.dataclass
class TuneResult:
    shares: Dict[str, int]                 # grid units per path (sum == grid)
    active: List[str]
    iterations: int
    converged: bool
    trace: List[TuneTrace]

    def fractions(self) -> Dict[str, float]:
        return {k: v / SHARE_GRID for k, v in self.shares.items()}


def initialize_shares(paths: Sequence[str], primary: str,
                      grid: int = SHARE_GRID) -> Dict[str, int]:
    """Heuristic: primary gets the dominant share, rest split the remainder."""
    shares = {p: 0 for p in paths}
    others = [p for p in paths if p != primary]
    if not others:
        shares[primary] = grid
        return shares
    prim = min(INITIAL_PRIMARY_UNITS * grid // SHARE_GRID, grid)
    shares[primary] = prim
    rest, rem = divmod(grid - prim, len(others))
    for i, p in enumerate(others):
        shares[p] = rest + (1 if i < rem else 0)
    return shares


def initial_tune(paths: Sequence[str], primary: str, measure: MeasureFn,
                 *, grid: int = SHARE_GRID,
                 initial_step: int = INITIAL_ADJUSTMENT_STEP,
                 convergence_threshold: float = CONVERGENCE_THRESHOLD,
                 stability_required: int = STABILITY_REQUIRED,
                 max_iters: int = MAX_ITERS) -> TuneResult:
    """Algorithm 1: InitialTune(C).

    `measure(shares)` returns per-path completion times for the *fractional*
    shares (grid units / grid) — on hardware this is a timed profiling round,
    here it is `PathTimingModel.measure`.
    """
    if primary not in paths:
        raise ValueError(f"primary {primary!r} not in paths {paths!r}")
    active: List[str] = list(paths)
    shares = initialize_shares(paths, primary, grid)
    step = initial_step
    stability_count = 0
    prev_slowest: Optional[str] = None
    trace: List[TuneTrace] = []
    converged = False
    it = 0

    for it in range(1, max_iters + 1):
        if len(active) == 1 and primary in active:
            converged = True          # only the primary remains (Alg.1 l.10)
            break
        fracs = {p: shares[p] / grid for p in active}
        timings = dict(measure(fracs))
        act_t = {p: timings[p] for p in active}
        c_slow = max(act_t, key=act_t.get)
        c_fast = min(act_t, key=act_t.get)
        t_fast = act_t[c_fast]
        imbalance = (act_t[c_slow] - t_fast) / t_fast if t_fast > 0 else 0.0

        if imbalance < convergence_threshold:
            stability_count += 1
            trace.append(TuneTrace(it, dict(shares), dict(timings), c_slow,
                                   c_fast, imbalance, step, 0))
            if stability_count >= stability_required:
                converged = True
                break
            continue
        stability_count = 0

        # Damping: halve step when the bottleneck shifts (Alg.1 l.21-22).
        if prev_slowest is not None and c_slow != prev_slowest:
            step = max(step // 2, 1)

        # NVLink-centric move (Alg.1 l.23-27).
        c_source = c_slow
        if c_slow != primary and primary in active:
            c_target = primary
        else:
            c_target = c_fast
        move = min(step, shares[c_source])
        shares[c_source] -= move
        shares[c_target] += move

        deactivated = None
        if shares[c_source] <= 0:
            active.remove(c_source)   # Alg.1 l.31-32
            deactivated = c_source
        prev_slowest = c_slow
        trace.append(TuneTrace(it, dict(shares), dict(timings), c_slow,
                               c_fast, imbalance, step, move, deactivated))

    assert sum(shares.values()) == grid, "shares must always sum to the grid"
    return TuneResult(shares=shares, active=active, iterations=it,
                      converged=converged, trace=trace)
