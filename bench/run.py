#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print one JSON line.

  python3 bench/run.py --workload glm4-9b.train-dp4 --seed 7 --seconds 20 \\
      --trace 0

The cell's files are found by its name (``bench/workloads/<cell>.json``
and the configuration and traffic it names); the metrics reported are
BENCHMARK.json's ``end_to_end`` ones (``--trace 0``) or its ``per_layer``
ones (``--trace 1``) that list the cell, each read by
``bench/metrics/<name>.py``.  Needs as many CUDA cards as the cell has
chips, and exits 2 without them.  The last line of standard output is the
result; the numbers that decide ``correct`` are the last lines of
standard error.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the build and kernel caches of a run, at fixed paths in the checkout
CACHE = ROOT / "build" / "bench-cache"
#: a rank group that has not answered by then has hung
RANK_TIMEOUT_S = 330


def process_start() -> float:
    """When this process started, in epoch seconds (Linux's /proc; else
    when this module started)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - int(fields[19])
                              / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def setup_paths() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def _spread(ms) -> str:
    """min / median / max of a list of step times."""
    if not ms:
        return "-"
    ms = sorted(ms)
    return f"{ms[0]:.1f} / {ms[len(ms) // 2]:.1f} / {ms[-1]:.1f}"


def _mean_totals(dicts):
    keys = {k for d in dicts for k in d}
    return {k: sum(d.get(k, 0.0) for d in dicts) / len(dicts) for k in keys}


def assemble(cell: str, files, ranks, trace: bool, peaks,
             card: str = "") -> dict:
    """The result line of one run from its ranks' results."""
    from bench import cells, compare
    from bench import trace as TR
    checks = compare.checks(
        ({n: r["numbers"][n]["value"] for n in compare.NUMBERS}
         for r in ranks), files["cell"]["limits"])
    failed = max(r["failed"] for r in ranks)
    correct = compare.passes(checks) and failed == 0
    run = {"cell": cell, "files": files, "ranks": ranks, "peaks": peaks,
           "chips": len(ranks)}
    metrics = {}
    for m in cells.metrics_for(cell, "per_layer" if trace else "end_to_end"):
        value = cells.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": ranks[0].get("device_name", ""),
              "count": len(ranks),
              "memory_peak_bytes": max(r.get("peak_bytes", 0)
                                       for r in ranks)}
    out = {"correct": correct, "attempted": ranks[0]["steps"],
           "failed": failed, "metrics": metrics, "device": device}
    if trace:
        ts = [r["trace"] for r in ranks]
        device["busy_s"] = sum(t["busy_s"] for t in ts) / len(ts)
        device["window_s"] = sum(t["wall_s"] for t in ts) / len(ts)
        ops = []
        for t in ts:
            per = {}
            for name, _, dur, _ in t["ops"]:
                per[name] = per.get(name, 0.0) + dur / 1e6
            ops.append(per)
        out["breakdown"] = {
            "device_ops": TR.top(_mean_totals(ops)),
            "idle_gaps": TR.top(_mean_totals([t["gaps"] for t in ts]))}
        out["tracing"] = {
            "traced_step_s": ts[0]["wall_s"] / ts[0]["steps"],
            "untraced_step_s": ts[0]["untraced_step_s"]}
    out["card"] = card
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start()
    setup_paths()
    from bench import cells
    try:
        files = cells.load(args.workload)
        listed = [w["name"] for w in cells.manifest()["workloads"]]
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.workload not in listed:
        print(f"error: {args.workload} is not a cell of BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = files["cell"]["chips"]
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        spec = {"config": files["config"], "cell": files["cell"],
                "traffic": files["traffic"], "seed": args.seed,
                "seconds": args.seconds, "trace": bool(args.trace),
                "device": "cuda", "dist": "nccl",
                "t_process": t_process, "timeout_s": RANK_TIMEOUT_S}
        from bench import traffic
        traffic.check(files["traffic"], chips)
        ranks = cells.driver(files["cell"]["driver"]).run_cell(spec)
        name = ranks[0].get("device_name", "")
        table = json.loads((ROOT / "bench" / "peaks.json").read_text())
        peaks = next((v for k, v in table.items()
                      if not k.startswith("_") and k in name), {})
        result = assemble(args.workload, files, ranks, bool(args.trace),
                          peaks, power_limit())
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 1
    for r in ranks:
        phases = " / ".join(f"{x:.2f}" for x in r["setup_phases_s"])
        print(f"rank {r['rank']}: setup {r['setup_s']:.3f} s (to build / "
              f"build / weights / checked / {r['warm_steps']} warm: "
              f"{phases}), window "
              f"{r['window_s']:.3f} s for {r['steps']} steps, reference "
              f"{r['reference_s']:.1f} s, peak {r.get('peak_bytes')} B, "
              f"trace read {r.get('trace', {}).get('read_s', 0):.1f} s, "
              f"rebuilds {r['rebuilds']}, re-keys {r['rekeys']}, step ms "
              f"{_spread(r.get('step_ms'))}, losses "
              f"{r['prog']['losses']} (reference {r['ref']['losses']})",
              file=sys.stderr)
        for name, n in r["numbers"].items():
            print(f"  {name} {n['value']!r} at {n.get('at', '-')}",
                  file=sys.stderr)
    # every metric's reader is loaded by now: the last look for JAX
    found = sorted(set(cells.forbidden_modules()).union(
        *[r["modules"] for r in ranks]))
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
