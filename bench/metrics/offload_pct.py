"""offload_pct: the share of the gradient all-reduce's bytes that the
plans of the traced steps put on any route but the primary (rank 0's
plans: every rank of the data axis takes the same)."""

from bench.metrics._common import traced


def read(run):
    steps = traced(run)
    if not steps:
        return None
    total = off = 0.0
    for calls in steps[0]["sync_calls"]:
        for c in calls:
            if c["units"] is None:
                return None
            total += c["nbytes"]
            off += c["nbytes"] * (1 - c["units"].get("primary", 0)
                                  / c["grain"])
    return 100.0 * off / total if total else None
