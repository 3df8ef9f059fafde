"""The reference's dry-run of one (arch, shape, mesh), run as a script in a
subprocess of the port's dry-run tests (the reference's dry-run module
forces 512 host devices at import, so it never loads into a test
session).

  PYTHONPATH=src python tests/_torch_dryrun_ref.py OUT.json -- \\
      --arch glm4-9b --shape decode_32k --mesh single [--tuning-cache P]

It runs ``repro.launch.dryrun.run_one`` as its ``main`` would, and writes
to OUT.json the record and the per-call list ``parse_collectives`` gave
``run_one`` on the lowered StableHLO (``[op, axis, operand bytes]`` in
program order)."""

import json
import sys

import repro.launch.dryrun as dryrun        # sets XLA_FLAGS before jax
from repro.roofline import analysis


def main(argv) -> int:
    out, rest = argv[0], argv[argv.index("--") + 1:]
    calls = []
    parse = analysis.parse_collectives

    def recording(text, mesh_shape):
        got = parse(text, mesh_shape)
        calls.extend([c.op, c.axis, c.operand_bytes] for c in got)
        return got

    analysis.parse_collectives = recording
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--mesh-split", default="")
    ap.add_argument("--tuning-cache", default="")
    args = ap.parse_args(rest)
    split = (tuple(int(x) for x in args.mesh_split.split(","))
             if args.mesh_split else None)
    rec = dryrun.run_one(args.arch, args.shape, args.mesh == "multi",
                         mesh_split=split, tuning_cache=args.tuning_cache)
    with open(out, "w") as f:
        json.dump({"record": rec, "calls": calls}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
