"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
      --smoke --steps 50 --mesh-shape 2,1 --device cpu --dist gloo

Port of ``src/repro/launch/train.py``.  ``--smoke`` swaps in the reduced
config (2 layers, d_model 256).  The mesh shape is (data, model); every
rank is a process (``launch.mesh.run_ranks``) that builds the same
global weights from seed 0 and keeps its model-axis shards of them
(``convert.shard_params``), takes its rows of the global batch (the same
rows on every rank of a model line), combines its tensor-parallel
partial results through the model axis's FlexCommunicator and reduces
its gradients through the data axis's.  The flags are the reference's,
plus:

* ``--device`` (default ``cuda``): without a card, ``cuda`` exits 2 —
  never a silent CPU run;
* ``--dist gloo|nccl`` (default ``nccl``): the process-group backend.
  ``nccl`` puts one rank on each card and exits 2 with fewer cards than
  ranks; ``gloo`` runs every rank on card 0 (or the CPU) with the wire
  through host memory.  Neither falls back to the other.

The communicator's default profile is ``h100`` (the reference's launcher
uses ``tpu_v5e``).  Flags of tiers not ported yet exit 2 and name the
ROADMAP item that lifts them: ``--nodes``/``--cluster`` (queue 1 item
12), ``--pods`` (item 14), ``--degrade``/``--fault`` (item 13) and
``--bucket-mb`` > 0 (item 8).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.convert import shard_params
from repro_torch.core.communicator import CommConfig
from repro_torch.data.pipeline import make_batches
from repro_torch.launch.steps import build_train_program
from repro_torch.models.transformer import init_params, param_specs
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.loop import LoopConfig, run_loop


def _unported(args) -> str:
    """The ROADMAP item a flag of this run needs, or ""."""
    if args.nodes > 1 or args.cluster:
        return "--nodes/--cluster: ROADMAP queue 1 item 12 (two-tier cluster)"
    if args.pods > 1:
        return "--pods: ROADMAP queue 1 item 14 (pod tier)"
    if args.degrade or args.fault:
        return "--degrade/--fault: ROADMAP queue 1 item 13 (faults)"
    if args.bucket_mb > 0:
        return ("--bucket-mb > 0: ROADMAP queue 1 item 8 (bucketed "
                "overlapped gradient sync)")
    return ""


def train_rank(args: argparse.Namespace, dims, world: int) -> dict:
    """One rank's training run (or the only one, with ``world == 1``):
    weights from seed 0 (this rank's model-axis shards), the global
    synthetic batch stream, this rank's rows of it.  Rank 0 logs and saves
    the tuning cache; the ranks of data row 0 checkpoint (model rank 0
    writes)."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = Mesh(dims, ("data", "model"), device=args.device) \
        if world > 1 else None
    rank = mesh.rank if mesh is not None else 0
    device = mesh.device if mesh is not None else torch.device(args.device)
    comm = CommConfig(backend=args.backend, timing=args.timing,
                      secondary_algo=args.secondary_algo,
                      tuning_cache=args.tuning_cache,
                      compress=args.compress)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    program, ctx = build_train_program(cfg, mesh, comm=comm, opt=opt,
                                       device=device)
    specs = param_specs(cfg)
    if ctx.tp_size > 1:
        params = shard_params(params, specs, ctx.tp_index(), ctx.tp_size)
    opt_state = init_state(params)
    lead = rank == 0
    data_row0 = mesh is None or mesh.axis_index("data") == 0
    loop = LoopConfig(total_steps=args.steps, log_every=5 if lead else 0,
                      ckpt_every=args.ckpt_every,
                      ckpt_dir=(args.ckpt_dir or None) if data_row0
                      else None, param_specs=specs,
                      tuning_cache=(args.tuning_cache or None) if lead
                      else None)
    batches = make_batches(cfg, seq_len=args.seq_len,
                           batch_per_shard=args.batch)
    try:
        _, _, hist = run_loop(program, params, opt_state, batches, ctx, loop)
    finally:
        program.close()
    return {"history": hist, "report": loop.report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ALIASES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 2,1 = (data=2, model=1); empty = one device")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank; without a CUDA card "
                         "'cuda' exits 2 (pass 'cpu' to train on the CPU)")
    ap.add_argument("--dist", choices=["gloo", "nccl"], default="nccl",
                    help="process-group backend of the ranks: nccl = one "
                         "card per rank, gloo = host-memory wire")
    ap.add_argument("--nodes", type=int, default=0)
    ap.add_argument("--cluster", default="")
    ap.add_argument("--pods", type=int, default=0)
    ap.add_argument("--degrade", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--backend", choices=["flexlink", "nccl"],
                    default="flexlink")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint period in steps (0 = final only)")
    ap.add_argument("--out", default="",
                    help="write a JSON run report (losses, program stats, "
                         "tuning provenance)")
    ap.add_argument("--tuning-cache", default="",
                    help="TuningProfile JSON: warm-start Stage-1 shares "
                         "from it and persist them back at the end")
    ap.add_argument("--timing", choices=["sim", "measured"], default="sim",
                    help="Stage-2 TimingSource: analytic simulator or "
                         "wall-clock step durations (control/timing.py)")
    ap.add_argument("--secondary-algo", choices=["ring", "tree"],
                    default="ring",
                    help="secondary-path collective algorithm (paper §6)")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="bucketed overlapped gradient sync; only 0 "
                         "(monolithic per-leaf sync) is ported")
    ap.add_argument("--compress", default="",
                    help="secondary-path wire codecs (DESIGN.md §12), e.g. "
                         "'secondary=fp8' or 'staged=bf16,ortho=fp8'; the "
                         "tuner still chooses per slot whether each codec "
                         "pays.  Default: off")
    args = ap.parse_args(argv)

    missing = _unported(args)
    if missing:
        print(f"error: not ported yet: {missing}", file=sys.stderr)
        return 2
    dims = tuple(int(x) for x in args.mesh_shape.split(",")) \
        if args.mesh_shape else (1, 1)
    if len(dims) != 2:
        print("error: --mesh-shape takes (data, model)", file=sys.stderr)
        return 2
    world = int(np.prod(dims))
    if args.batch % dims[0]:
        print(f"error: --batch {args.batch} does not divide over "
              f"{dims[0]} data ranks", file=sys.stderr)
        return 2
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"error: --device {args.device} but no CUDA card is present; "
              f"pass --device cpu to train on the CPU", file=sys.stderr)
        return 2
    if world > 1 and args.dist == "nccl":
        if not args.device.startswith("cuda"):
            print("error: --dist nccl needs --device cuda; use --dist gloo "
                  "on the CPU", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < world:
            print(f"error: --dist nccl runs one card per rank: {world} "
                  f"ranks, {torch.cuda.device_count()} cards",
                  file=sys.stderr)
            return 2

    if world > 1:
        # by its module's name, so spawned ranks unpickle it under
        # ``python -m`` too
        from repro_torch.launch import train as this
        from repro_torch.launch.mesh import run_ranks
        device = "cuda" if args.device.startswith("cuda") else "cpu"
        args.device = device
        results = run_ranks(this.train_rank, world, backend=args.dist,
                            device=device, timeout_s=3600,
                            args=(args, dims, world))
        if any(r["history"] != results[0]["history"] for r in results):
            print("error: the ranks' losses differ", file=sys.stderr)
            return 1
        res = results[0]
    else:
        res = train_rank(args, dims, world)
    hist = res["history"]
    print(f"final loss: {hist[-1]:.4f} (from {hist[0]:.4f})")
    if args.out:
        rep = {"final_loss": hist[-1], "losses": hist, "steps": args.steps,
               "device": args.device, "dist": args.dist, "ranks": world,
               **(res["report"] or {})}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2, default=str)
        print(f"run report -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
