#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell, in
one process (one set-up): the program's numbers against the reference's
on every seed of ``--seeds``, and on each of ``--variant-seeds`` the
control's (the reference on float8 operands) and each planted fault's
(``bench/faults.py``); ``--variants control,bf16`` adds the bf16
witness.

  python3 bench/calibrate.py --workload mixtral-8x7b.train-1chip \\
      --seeds 11,12,13 --variant-seeds 11 \\
      --faults unchanged,half_batch,grad_altered --out chiprun_out/cal.json

Prints one line a reading (the worst over ranks) with the verdict of the
harness's own comparison at the cell's limits (``correct``) and, last,
the lower reading (the program's largest), the smallest of the control
and of each fault, number by number, and the seeds on which each came
out correct.  Needs the cell's cards.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from run import setup_paths


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant-seeds", default="")
    ap.add_argument("--variants", default="control",
                    help="reference variants run in the program's place")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    setup_paths()
    import torch
    from bench import cells, compare
    files = cells.load(args.workload)
    if torch.cuda.device_count() < files["cell"]["chips"]:
        print("error: too few CUDA cards", file=sys.stderr)
        return 2
    spec = {"config": files["config"], "cell": files["cell"],
            "traffic": files["traffic"], "seeds": _ints(args.seeds),
            "variant_seeds": _ints(args.variant_seeds),
            "variants": [v for v in args.variants.split(",") if v],
            "faults": [f for f in args.faults.split(",") if f],
            "device": "cuda", "dist": "nccl",
            "timeout_s": 3000}
    t0 = time.time()
    ranks = cells.driver(files["cell"]["driver"]).calibrate(spec)
    if args.out:
        with open(args.out + ".raw", "w") as f:
            json.dump(ranks, f)
    rows, detail = {}, {}
    for r in ranks:
        for row in r["rows"]:
            key = (row["seed"], row["variant"])
            got = rows.setdefault(key, {})
            for name, v in row["numbers"].items():
                old = got.get(name, -math.inf)
                if math.isnan(v["value"]) or v["value"] > old:
                    got[name] = v["value"]
                    if "leaves" in v:
                        detail[key + (name,)] = {"at": v.get("at"),
                                                 "leaves": v["leaves"]}
    limits = files["cell"]["limits"]
    table = [{"seed": s, "variant": v, **nums,
              "correct": compare.passes(compare.checks([nums], limits))}
             for (s, v), nums in rows.items()]
    for row in table:
        print(json.dumps(row))
    for (s, v, name), d in detail.items():
        print(json.dumps({"seed": s, "variant": v, "number": name, **d}),
              file=sys.stderr)
    summary = {}
    for variant in {row["variant"] for row in table}:
        sel = [row for row in table if row["variant"] == variant]
        pick = max if variant == "program" else min
        summary[variant] = {name: pick(row[name] for row in sel)
                            for name in sel[0] if name not in
                            ("seed", "variant", "correct")}
        summary[variant]["correct_seeds"] = sorted(
            row["seed"] for row in sel if row["correct"])
    print(json.dumps({"summary": summary, "seconds": time.time() - t0,
                      "card": torch.cuda.get_device_name(0)}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": table, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
