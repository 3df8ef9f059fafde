"""A few steps under ``torch.profiler``, read back into what the per-layer
metrics and the breakdown need.

The profiler writes its Chrome trace into the run's temporary directory;
it is read and deleted at once.  From it: every device operation (kernel,
copy, fill) with its name, start, length and stream; the busy time (the
union of their intervals); each idle gap between them, named by the
host operation that launched the work that ended it (the innermost CPU
op around the launch, found by the launch's correlation id); and the
program's spans, read by ``bench/spans.py``.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import pathlib
import time
from typing import Callable, Dict, List, Tuple

import torch

from bench import spans

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
#: characters of a name kept
NAME_CHARS = 120


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def record(run_steps: Callable[[int], None], steps: int, tag: str
           ) -> Tuple[List[Dict], float]:
    """The Chrome trace events of ``run_steps(steps)`` under the profiler
    (ended by a synchronize), and its wall time in seconds."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        _sync()
        wall = time.perf_counter() - t0
    tmp = pathlib.Path(os.environ.get("TMPDIR") or "/tmp")
    path = tmp / f"bench-trace-{tag}-{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if path.exists():
            path.unlink()
    return events, wall


def capture(run_steps: Callable[[int], None], steps: int, tag: str) -> Dict:
    """Profile ``run_steps(steps)`` and summarise its trace, the program's
    spans too (``spans`` and ``gaps_by_span`` of ``bench/spans.py``)."""
    t0 = time.perf_counter()
    events, wall = record(run_steps, steps, tag)
    out = summarize(events, steps, wall)
    by_span = spans.summarize(events, wall)
    out["spans"] = by_span["spans"]
    out["gaps_by_span"] = by_span["gaps_by_span"]
    out["read_s"] = time.perf_counter() - t0 - wall
    return out


def _stream(e: Dict):
    args = e.get("args", {})
    return args.get("stream", e.get("tid"))


def _intervals_union(ops: List[tuple]) -> List[List[float]]:
    spans: List[List[float]] = []
    for _, ts, dur, _ in sorted(ops, key=lambda o: o[1]):
        if spans and ts <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], ts + dur)
        else:
            spans.append([ts, ts + dur])
    return spans


def summarize(events: List[Dict], steps: int, wall_s: float) -> Dict:
    """``ops`` [(name, start us, length us, stream)], ``launches`` (device
    kernels, one a launch), ``busy_s``, ``wall_s``, ``steps`` and
    ``gaps`` {host op: idle seconds}."""
    ops, first_op = [], {}
    launch_at = {}
    cpu = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            op = (e["name"][:NAME_CHARS], float(e["ts"]),
                  float(e.get("dur", 0.0)), _stream(e))
            ops.append(op)
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                first_op[op] = corr
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (float(e["ts"]), e.get("tid"))
        elif cat == "cpu_op":
            ts = float(e["ts"])
            cpu[e.get("tid")].append((ts, ts + float(e.get("dur", 0.0)),
                                      e["name"][:NAME_CHARS]))
    for rows in cpu.values():
        rows.sort()
    starts = {tid: [r[0] for r in rows] for tid, rows in cpu.items()}

    def host_op(corr) -> str:
        if corr not in launch_at:
            return "unknown"
        ts, tid = launch_at[corr]
        rows, i = cpu.get(tid, []), bisect.bisect_right(starts.get(tid, []),
                                                        ts)
        for j in range(i - 1, -1, -1):
            if rows[j][1] >= ts:
                return rows[j][2]
        return "outside any op"

    spans = _intervals_union(ops)
    busy_us = sum(b - a for a, b in spans)
    by_start = sorted(ops, key=lambda o: o[1])
    gaps: Dict[str, float] = collections.defaultdict(float)
    k = 0
    for (_, a_end), (b_start, _) in zip(spans, spans[1:]):
        while by_start[k][1] < b_start:
            k += 1
        gaps[host_op(first_op.get(by_start[k]))] += (b_start - a_end) / 1e6
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0
    outside = wall_s - span_us / 1e6
    if outside > 0:
        gaps["outside the device's span"] += outside
    kernels = sum(1 for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel")
    return {"ops": ops, "launches": kernels, "busy_s": busy_us / 1e6,
            "wall_s": wall_s, "steps": steps, "gaps": dict(gaps)}


def main_stream(ops: List[tuple]):
    """The stream that ran the most device time: the compute stream."""
    per = collections.Counter()
    for _, _, dur, stream in ops:
        per[stream] += dur
    return per.most_common(1)[0][0] if per else None


def top(totals: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:n]]
