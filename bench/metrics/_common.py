"""What several readers share."""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional


def traced(run: Dict) -> List[Dict]:
    """Each rank's trace summary (empty in an untraced run)."""
    return [r["trace"] for r in run["ranks"] if r.get("trace")]


def mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def tokens_per_step(run: Dict) -> int:
    t = run["files"]["traffic"]
    return t["ranks"] * t["batch_per_rank"] * t["seq_len"]


def window_s(run: Dict) -> float:
    return max(r["window_s"] for r in run["ranks"])


def step_flops(run: Dict) -> float:
    cfg, t = run["files"]["config"], run["files"]["traffic"]
    fam = importlib.import_module(f"bench.flops.{cfg['family']}")
    return fam.step_flops(cfg, t["seq_len"], t["ranks"] * t["batch_per_rank"])


def is_k1(name: str) -> bool:
    """K1, the staged ring's accumulate (csrc/chunk_accumulate.cu on
    csrc/segments.cuh)."""
    return "segments_kernel" in name and "Accumulate" in name


def is_comm(op, main_stream) -> bool:
    """A device op of the gradient sync: NCCL's kernels, K1, and whatever
    ran off the compute stream (the sync's side stream)."""
    name, _, _, stream = op
    return "nccl" in name.lower() or is_k1(name) or stream != main_stream
