#!/usr/bin/env python3
"""The program's spans (``repro_torch/runtime/spans.py``) read from a
profiler trace, and a command that reads them in one cell.

  python3 bench/spans.py --workload mixtral-8x7b.train-1chip --seed 7 \\
      --steps 3

:func:`summarize` takes the Chrome trace's events, as ``bench/trace.py``
does, and puts each device operation (kernel, copy, fill) in the spans
around its launch: the launch is found by the operation's correlation
id, and the spans are the ``user_annotation`` ranges on the launch's
thread that hold the launch's start.  A span's name is its range's name
up to the first space (the rest is its argument).  Its ``device_s`` sums
the device time of every operation launched inside it, in spans nested
in it too; ``host_s`` sums its ranges' lengths (a range inside one of
the same name counts once); ``count`` counts its ranges.  Each idle gap
between device operations is named ``"<innermost span> / <host op>"``
after the operation that ends it, as ``trace.py``'s ``gaps`` name it by
host op alone, or ``"outside any span / <host op>"``.

The command runs the cell as its files stand (listed in BENCHMARK.json
or not) on its chips: each rank builds the cell's program on the seed's
weights, warms it up, times ``--steps`` untraced steps and then profiles
``--steps`` more, and writes what it read, every range of the spans in
``DETAIL`` included, to ``<--out>/spans-<cell>-<seed>-rank<r>.json``.
It needs the cell's CUDA cards and exits 2 without them.  The last line
of standard output gives, by rank, the device ms a step of each span and
of what lies outside the four layer spans, the busy share and the
counters.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the spans of the four layers a traced step is split into
LAYERS = ("attn", "moe.dispatch", "moe.experts", "adamw")
#: spans whose every range the command writes out
DETAIL = ("step", "sync.bucket", "route.primary", "route.staged",
          "route.ortho")
OUTSIDE = "outside any span"


class _Nest:
    """Properly nested host ranges of one thread: the innermost one that
    holds a time, and the chain of those around it."""

    def __init__(self, rows: List[tuple]):
        # (start, end, payload), outer ranges first where starts tie
        self.rows = sorted(rows, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.rows]
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, (a, _, _) in enumerate(self.rows):
            while stack and self.rows[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, ts: float) -> Optional[int]:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i is not None and i >= 0 and self.rows[i][1] < ts:
            i = self.parent[i]
        return i if i is not None and i >= 0 else None

    def chain(self, i: Optional[int]):
        while i is not None:
            yield i
            i = self.parent[i]


def _ranges(events: List[Dict], cat: str) -> Dict:
    rows = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == cat:
            ts = float(e["ts"])
            rows[e.get("tid")].append((ts, ts + float(e.get("dur", 0.0)),
                                       e["name"]))
    return {tid: _Nest(r) for tid, r in rows.items()}


def summarize(events: List[Dict], wall_s: float) -> Dict:
    """``spans`` {name: {device_s, host_s, count}}, ``gaps_by_span``
    {"<span> / <host op>": idle s}, ``device_s`` (every device op's
    length, summed) and ``ranges`` {name in ``DETAIL``: [[argument, host
    start us, host us, device us, last device end us]]}."""
    from bench import trace as TR
    spans, cpu = _ranges(events, "user_annotation"), _ranges(events,
                                                             "cpu_op")
    launch_at, ops = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, corr = e.get("cat", ""), e.get("args", {}).get("correlation")
        if cat in TR.DEVICE_CATS:
            ops.append((corr, float(e["ts"]), float(e.get("dur", 0.0)),
                        len(ops)))
        elif cat in TR.LAUNCH_CATS and corr is not None:
            launch_at[corr] = (float(e["ts"]), e.get("tid"))

    def base(name: str) -> str:
        return name.split(" ", 1)[0]

    # per span range: device us and last device end, by (tid, index)
    dev_us: Dict[tuple, float] = collections.defaultdict(float)
    last_end: Dict[tuple, float] = {}
    totals: Dict[str, float] = collections.defaultdict(float)
    label = {}                       # device op -> gap label
    for op in ops:
        corr, ts, dur, _ = op
        if corr not in launch_at:
            label[op] = "unknown / unknown"
            continue
        at, tid = launch_at[corr]
        nest = spans.get(tid)
        inner = nest.innermost(at) if nest else None
        names = set()
        for i in (nest.chain(inner) if nest else ()):
            dev_us[(tid, i)] += dur
            last_end[(tid, i)] = max(last_end.get((tid, i), 0.0), ts + dur)
            names.add(base(nest.rows[i][2]))
        for n in names:
            totals[n] += dur
        host = cpu.get(tid)
        h = host.innermost(at) if host else None
        where = base(nest.rows[inner][2]) if inner is not None else OUTSIDE
        what = host.rows[h][2] if h is not None else "outside any op"
        label[op] = f"{where} / {what}"

    out: Dict[str, Dict] = {}
    ranges: Dict[str, List] = {n: [] for n in DETAIL}
    for tid, nest in spans.items():
        for i, (a, b, name) in enumerate(nest.rows):
            n = base(name)
            row = out.setdefault(n, {"device_s": totals.get(n, 0.0) / 1e6,
                                     "host_s": 0.0, "count": 0})
            row["count"] += 1
            outer = [j for j in nest.chain(nest.parent[i])
                     if base(nest.rows[j][2]) == n]
            if not outer:
                row["host_s"] += (b - a) / 1e6
            if n in ranges:
                ranges[n].append([name[len(n) + 1:], a, b - a,
                                  dev_us.get((tid, i), 0.0),
                                  last_end.get((tid, i))])

    gaps: Dict[str, float] = collections.defaultdict(float)
    busy = TR._intervals_union(ops)
    by_start = sorted(ops, key=lambda o: o[1])
    k = 0
    for (_, a_end), (b_start, _) in zip(busy, busy[1:]):
        while by_start[k][1] < b_start:
            k += 1
        gaps[label[by_start[k]]] += (b_start - a_end) / 1e6
    outside = wall_s - ((busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0)
    if outside > 0:
        gaps["outside the device's span"] += outside
    return {"spans": out, "gaps_by_span": dict(gaps),
            "device_s": sum(o[2] for o in ops) / 1e6,
            "ranges": {n: sorted(r, key=lambda x: x[1])
                       for n, r in ranges.items() if r}}


def per_step(summary: Dict, steps: int) -> Dict[str, float]:
    """Device ms a step of each of ``LAYERS``, and of the rest
    (``outside_ms``: every device op in none of them)."""
    sp = summary["spans"]
    out = {n: 1e3 * sp.get(n, {}).get("device_s", 0.0) / steps
           for n in LAYERS}
    out["outside_ms"] = 1e3 * summary["device_s"] / steps - sum(out.values())
    return out


# -- the command -------------------------------------------------------------


def rank_run(spec: Dict) -> Dict:
    """One rank: the program warmed up, ``steps`` untraced steps timed,
    ``steps`` more profiled and read."""
    import importlib
    import torch
    from bench import trace as TR
    from bench.drivers.train import Job
    job = Job(spec)
    try:
        job.fresh(spec["seed"])
        job.warm()
        n = spec["steps"]
        TR._sync()
        t0 = time.perf_counter()
        for _ in range(n):
            job.step()
        TR._sync()
        untraced = (time.perf_counter() - t0) / n

        def run(k):
            for _ in range(k):
                job.step()
        events, wall = TR.record(run, n, f"spans-rank{job.rank}")
        try:                    # a program older than its spans has none
            mod = importlib.import_module("repro_torch.runtime.spans")
        except ModuleNotFoundError:
            counted = {}
        else:
            counted = mod.counters()
        base = TR.summarize(events, n, wall)
        out = summarize(events, wall)
        out.update(rank=job.rank, steps=n, wall_s=wall,
                   untraced_step_s=untraced, busy_s=base["busy_s"],
                   launches=base["launches"], counters=counted,
                   per_step_ms=per_step(out, n),
                   device_name=(torch.cuda.get_device_name(job.device)
                                if job.device.type == "cuda" else "cpu"))
        return out
    finally:
        job.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "spans"),
                    help="directory of the per-rank files")
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import cells
    files = cells.load(args.workload)
    chips = files["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA cards", file=sys.stderr)
        return 2
    spec = {"config": files["config"], "cell": files["cell"],
            "traffic": files["traffic"], "seed": args.seed,
            "steps": args.steps, "device": "cuda"}
    from bench import spans as this      # by name, for the spawned ranks
    if chips == 1:
        ranks = [this.rank_run(spec)]
    else:
        from repro_torch.launch.mesh import run_ranks
        ranks = run_ranks(this.rank_run, chips, backend="nccl", device="cuda",
                          timeout_s=600, args=(spec,))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    line = []
    for r in ranks:
        name = f"spans-{args.workload}-{args.seed}-rank{r['rank']}.json"
        (out_dir / name).write_text(json.dumps(r))
        top = sorted(r["gaps_by_span"].items(), key=lambda kv: -kv[1])[:8]
        line.append({"rank": r["rank"], "device": r["device_name"],
                     "per_step_ms": r["per_step_ms"],
                     "busy_pct": 100 * r["busy_s"] / r["wall_s"],
                     "traced_step_s": r["wall_s"] / r["steps"],
                     "untraced_step_s": r["untraced_step_s"],
                     "launches_per_step": r["launches"] / r["steps"],
                     "counters": r["counters"],
                     "spans": {n: [round(v["device_s"] * 1e3 / r["steps"], 3),
                                   round(v["host_s"] * 1e3 / r["steps"], 3),
                                   v["count"]]
                               for n, v in r["spans"].items()},
                     "gaps_by_span_top": top})
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
