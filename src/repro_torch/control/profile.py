# Copied from src/repro/control/profile.py; only the imports are renamed.
"""TuningProfile — persistent Stage-1 warm-start store.

Every fresh process used to repay the paper's "~10 s profiling phase"
because converged Stage-1 shares lived only in process memory.  The
profile serializes them to JSON keyed by everything the tuning outcome is
a function of — ``(profile, secondary_algo, op, n_ranks, bucket, grid)``
— so a later launch on the same topology adopts the shares with ZERO
Algorithm-1 iterations and, because RoutePlans are a pure function of the
shares, produces byte-identical ``plan_signature()``s to the cold run that
wrote it.

Saves merge: the on-disk file is re-read and updated before writing, so
several communicators (tp + dp axes, sequential launchers) can share one
cache file.  Writes are atomic (tmp + rename).  Unknown/corrupt files are
treated as empty rather than fatal — a warm-start cache must never be
able to break a launch.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.topology import Collective

VERSION = 1

Key = Tuple[str, str, str, int, int, int]


def _key(profile: str, algo: str, op: Collective | str, n_ranks: int,
         bucket: int, grid: int) -> Key:
    op_value = op.value if isinstance(op, Collective) else str(op)
    return (str(profile), str(algo), op_value, int(n_ranks), int(bucket),
            int(grid))


def _split_degraded_name(name: str) -> Tuple[str, Optional[Dict[str, float]]]:
    """Parse a (possibly chained) degraded fabric name —
    ``base!t1=f1!t2=f2`` per ``links.degraded_profile_name`` — into
    ``(base, {target: factor})``.  A healthy name yields ``(name, {})``;
    a ``!``-segment that does not parse as ``target=float`` yields
    ``(base-so-far, None)`` so :meth:`TuningProfile.nearest` never
    matches on a name it cannot interpret."""
    parts = name.split("!")
    factors: Dict[str, float] = {}
    for seg in parts[1:]:
        target, sep, factor = seg.partition("=")
        if not sep or not target:
            return parts[0], None
        try:
            factors[target] = float(factor)
        except ValueError:
            return parts[0], None
    return parts[0], factors


class TuningProfile:
    """In-memory view of one warm-start cache file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[Key, Dict[str, object]] = {}

    # -- construction ---------------------------------------------------------

    @classmethod
    def load(cls, path: Optional[str]) -> "TuningProfile":
        prof = cls(path)
        if path and os.path.exists(path):
            prof._merge_file(path)
        return prof

    def _merge_file(self, path: str) -> None:
        try:
            with open(path) as f:
                doc = json.load(f)
            entries = doc.get("entries", []) if isinstance(doc, dict) else []
        except (OSError, ValueError):
            return                  # corrupt cache == empty cache
        for e in entries:
            try:
                key = _key(e["profile"], e.get("secondary_algo", "ring"),
                           e["op"], e["n_ranks"], e["bucket"], e["grid"])
                shares = {str(p): int(u) for p, u in e["shares"].items()}
            except (KeyError, TypeError, ValueError):
                continue
            if sum(shares.values()) != key[5]:
                continue            # does not cover the grid: unusable
            self._entries.setdefault(key, {}).update(e)
            self._entries[key]["shares"] = shares

    # -- store API -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, profile: str, algo: str, op: Collective, n_ranks: int,
               bucket: int, grid: int) -> Optional[Dict[str, int]]:
        e = self._entries.get(_key(profile, algo, op, n_ranks, bucket, grid))
        return dict(e["shares"]) if e else None

    def lookup_members(self, profile: str, algo: str, op: Collective,
                       n_ranks: int, bucket: int, grid: int
                       ) -> Optional[Dict[str, Dict[str, int]]]:
        """Saved per-instance weight vectors for one slot (None when the
        entry predates the member model or has none) — the link-level
        ``shares`` and the instance-level ``members`` warm-start together
        so a drained rail stays drained across launches."""
        e = self._entries.get(_key(profile, algo, op, n_ranks, bucket, grid))
        members = (e or {}).get("members")
        if not isinstance(members, dict):
            return None
        try:
            return {str(link): {str(m): int(w) for m, w in ws.items()}
                    for link, ws in members.items()}
        except (AttributeError, TypeError, ValueError):
            return None

    def lookup_codecs(self, profile: str, algo: str, op: Collective,
                      n_ranks: int, bucket: int, grid: int
                      ) -> Optional[Dict[str, str]]:
        """Saved per-link wire-codec choice for one slot — restored
        alongside the shares so a warm start executes the same compressed
        plan the cold run tuned (DESIGN.md §12).  ``{}`` means the cold
        run's refinement explicitly chose NO codecs (and the warm start
        must not re-decide); ``None`` means the entry predates codecs, so
        the caller falls back to a fresh choice."""
        e = self._entries.get(_key(profile, algo, op, n_ranks, bucket, grid))
        codecs = (e or {}).get("codecs")
        if not isinstance(codecs, dict):
            return None
        try:
            return {str(link): str(name) for link, name in codecs.items()}
        except (AttributeError, TypeError, ValueError):
            return None

    def nearest(self, profile: str, algo: str, op: Collective, n_ranks: int,
                bucket: int, grid: int) -> Optional[str]:
        """The profile NAME of the best warm-start entry for one slot on
        ``profile`` — the fault engine's re-convergence anchor (DESIGN.md
        §14).  Preference order:

        1. an exact entry for ``profile`` itself (a previously-seen
           degraded fabric: zero-iteration warm start, the §10 contract);
        2. an entry for the same base fabric degraded on the SAME target
           set, minimizing total |factor| distance — e.g. a transition to
           ``h800:nic4x400!rail3=0.25`` adopts a saved
           ``...!rail3=0.5`` entry over the healthy one, because its
           drain structure already matches;
        3. the healthy base entry — better than cold, worse than (2);
        4. None: nothing saved for this slot at all (the caller carries
           the live shares forward instead).

        Returns the name to pass to lookup/lookup_members/lookup_codecs,
        NOT the shares — callers need the member/codec companions too.
        """
        if self.lookup(profile, algo, op, n_ranks, bucket, grid) is not None:
            return profile
        base, want = _split_degraded_name(profile)
        best: Optional[Tuple[float, str]] = None
        for key in self._entries:
            if key[1:] != _key(profile, algo, op, n_ranks, bucket,
                               grid)[1:]:
                continue
            cand_base, cand = _split_degraded_name(key[0])
            if cand_base != base or cand is None or want is None:
                continue
            if set(cand) != set(want):
                continue
            dist = sum(abs(cand[t] - want[t]) for t in want)
            if best is None or dist < best[0]:
                best = (dist, key[0])
        if best is not None:
            return best[1]
        if base != profile and self.lookup(base, algo, op, n_ranks, bucket,
                                           grid) is not None:
            return base
        return None

    def record(self, profile: str, algo: str, op: Collective, n_ranks: int,
               bucket: int, grid: int, shares: Mapping[str, int], *,
               iterations: int = 0, converged: bool = True,
               members: Optional[Mapping[str, Mapping[str, int]]] = None,
               codecs: Optional[Mapping[str, str]] = None) -> None:
        key = _key(profile, algo, op, n_ranks, bucket, grid)
        self._entries[key] = {
            "profile": key[0], "secondary_algo": key[1], "op": key[2],
            "n_ranks": key[3], "bucket": key[4], "grid": key[5],
            "shares": {str(p): int(u) for p, u in shares.items()},
            "iterations": int(iterations), "converged": bool(converged),
        }
        if members:
            self._entries[key]["members"] = {
                str(link): {str(m): int(w) for m, w in ws.items()}
                for link, ws in members.items()}
        if codecs is not None:
            # {} is a real verdict ("refinement dropped every codec") and
            # must round-trip as such; only None omits the field, keeping
            # uncompressed cache files byte-compatible with pre-codec
            # readers
            self._entries[key]["codecs"] = {
                str(link): str(name) for link, name in codecs.items()}

    def save(self, path: Optional[str] = None) -> str:
        """Merge with whatever is on disk, then write atomically."""
        target = path or self.path
        if not target:
            raise ValueError("TuningProfile.save: no path configured")
        on_disk = TuningProfile.load(target)
        on_disk._entries.update(self._entries)
        doc = {"version": VERSION,
               "entries": [on_disk._entries[k]
                           for k in sorted(on_disk._entries)]}
        d = os.path.dirname(os.path.abspath(target))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=2)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = target
        return target

    def report(self) -> Dict[str, object]:
        return {"path": self.path, "entries": len(self._entries)}
