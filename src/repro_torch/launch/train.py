"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
      --smoke --steps 50 --mesh-shape 2,1 --device cpu --dist gloo

Port of ``src/repro/launch/train.py``.  ``--smoke`` swaps in the reduced
config (2 layers, d_model 256).  The mesh shape is (data, model), and
``--nodes N`` (or a ``--cluster`` name, which implies its node count)
prepends a node axis, as the reference's ``make_cluster_mesh``: the mesh is
(node, data, model), N x dp x tp ranks, the global batch divides over
dp x N, and the gradient sync is the hierarchical all-reduce over the
cluster's tiers (``repro_torch.cluster``).  Every rank is a process
(``launch.mesh.run_ranks``) that builds the same global weights from seed
0 and keeps its model-axis shards of them
(``convert.shard_params``; ep_a2a experts over the data axis as well),
takes its rows of the global batch (the same
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
uses ``tpu_v5e``); a named cluster sets it to its node type.
``--degrade name[:member]=factor`` folds statically into the fabric
(``configs/clusters.resolve_faults``): into the NIC tier or the node
profile of a cluster run, else into the node profile.  ``--bucket-mb`` > 0
buckets the gradient sync and launches each bucket from the backward
(train/bucketer.py); with a lossy ``--compress`` codec the AdamW state is
paired with error-feedback residuals, this rank's shards of them on a
model axis.  Flags of tiers not ported yet exit 2 and name the ROADMAP
item that lifts them: ``--pods`` (queue 1 item 14) and ``--fault`` (item
13).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.convert import spec_axes
from repro_torch.core.communicator import CommConfig
from repro_torch.data.pipeline import make_batches
from repro_torch.launch.steps import (build_train_program, local_params,
                                      rank_specs)
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.train.train_step import ef_init_residuals


def unported(args) -> str:
    """The ROADMAP item a flag of this run needs, or "" (the serve
    launcher's flags too)."""
    if args.pods > 1:
        return "--pods: ROADMAP queue 1 item 14 (pod tier)"
    if args.fault:
        return "--fault: ROADMAP queue 1 item 13 (faults)"
    return ""


def resolve_fabric(args, profile: str = "h100"):
    """``(cluster or None, node count, intra profile)`` of ``--cluster``,
    ``--nodes`` and ``--degrade`` (the reference's resolve_cluster then
    resolve_faults; a step-0 ``--degrade`` always folds statically)."""
    from repro_torch.configs.clusters import resolve_cluster, resolve_faults
    cluster, nodes, _ = resolve_cluster(getattr(args, "cluster", ""),
                                        args.nodes)
    if cluster is not None:
        profile = cluster.node.name
    cluster, profile, _ = resolve_faults(cluster, nodes, profile,
                                         degrade=args.degrade)
    return cluster, nodes, profile


def train_rank(args: argparse.Namespace, dims, world: int) -> dict:
    """One rank's training run (or the only one, with ``world == 1``):
    weights from seed 0 (this rank's model-axis shards), the global
    synthetic batch stream, this rank's rows of it.  ``dims`` is (data,
    model), or (node, data, model) on a cluster.  Rank 0 logs and saves
    the tuning cache; the ranks of node 0 and data row 0 checkpoint
    (model rank 0 writes)."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    cluster, _, profile = resolve_fabric(args)
    axes = ("node", "data", "model")[-len(dims):]
    mesh = Mesh(dims, axes, device=args.device) if world > 1 else None
    rank = mesh.rank if mesh is not None else 0
    device = mesh.device if mesh is not None else torch.device(args.device)
    comm = CommConfig(backend=args.backend, profile=profile,
                      timing=args.timing,
                      secondary_algo=args.secondary_algo,
                      tuning_cache=args.tuning_cache,
                      compress=args.compress)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    program, ctx = build_train_program(cfg, mesh, comm=comm, opt=opt,
                                       bucket_mb=args.bucket_mb,
                                       device=device, cluster=cluster)
    specs = rank_specs(cfg, ctx)
    params = local_params(params, specs, ctx)
    opt_state = init_state(params)
    if args.bucket_mb > 0 and ctx.ef_codec_name():
        # lossy wire codec: the error-feedback residuals ride the
        # optimizer state (train_step.py docstring)
        opt_state = (opt_state, ef_init_residuals(params))
    lead = rank == 0
    # the ranks of node 0 and data row 0 checkpoint; every rank when the
    # data axis shards leaves (ep_a2a experts), whose save gathers over it
    saves = (mesh is None
             or (ctx.node_index() == 0 and mesh.axis_index("data") == 0)
             or (ctx.ep_size > 1 and "data" in spec_axes(specs)))
    loop = LoopConfig(total_steps=args.steps, log_every=5 if lead else 0,
                      ckpt_every=args.ckpt_every,
                      ckpt_dir=(args.ckpt_dir or None) if saves
                      else None, param_specs=specs,
                      tuning_cache=(args.tuning_cache or None) if lead
                      else None)
    batches = make_batches(cfg, seq_len=args.seq_len,
                           batch_per_shard=args.batch)
    try:
        _, _, hist = run_loop(program, params, opt_state, batches, ctx, loop)
    finally:
        program.close()
    return {"history": hist, "report": loop.report,
            "cluster": ctx.comm_report().get("cluster")}


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
    ap.add_argument("--nodes", type=int, default=0,
                    help="cluster node count: prepends a node axis to "
                         "--mesh-shape; gradient sync becomes the "
                         "hierarchical all-reduce over the cluster's NIC "
                         "tier (repro_torch.cluster, DESIGN.md §9)")
    ap.add_argument("--cluster", default="",
                    help="named cluster topology from configs/clusters.py "
                         "(default: synthesized from the comm profile); "
                         "implies its node count")
    ap.add_argument("--pods", type=int, default=0,
                    help="pod count: > 1 is not ported yet (ROADMAP queue "
                         "1 item 14), exits 2")
    ap.add_argument("--degrade", default="",
                    help="launch-time fault injection name[:member]=factor "
                         "(e.g. rail3=0.25, nvlink=0.5): the NIC tier or "
                         "the node profile runs degraded from step 0")
    ap.add_argument("--fault", default="",
                    help="fault-timeline schedule: not ported yet (ROADMAP "
                         "queue 1 item 13), exits 2")
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
                    help="bucketed gradient sync: buckets of about this "
                         "many MiB, each launched from the backward "
                         "(0 = monolithic per-leaf sync)")
    ap.add_argument("--compress", default="",
                    help="secondary-path wire codecs (DESIGN.md §12), e.g. "
                         "'secondary=fp8' or 'staged=bf16,ortho=fp8'; the "
                         "tuner still chooses per slot whether each codec "
                         "pays.  Default: off")
    args = ap.parse_args(argv)

    missing = unported(args)
    if missing:
        print(f"error: not ported yet: {missing}", file=sys.stderr)
        return 2
    dims = tuple(int(x) for x in args.mesh_shape.split(",")) \
        if args.mesh_shape else (1, 1)
    if len(dims) != 2:
        print("error: --mesh-shape takes (data, model)", file=sys.stderr)
        return 2
    try:
        _, nodes, _ = resolve_fabric(args)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if nodes > 1:
        if get_config(args.arch).moe is not None and \
                get_config(args.arch).moe.impl == "ep_a2a":
            print("error: not ported yet: ep_a2a on a node mesh: ROADMAP "
                  "queue 1 item 14 (rail-local ep_all_to_all)",
                  file=sys.stderr)
            return 2
        dims = (nodes,) + dims
    world = int(np.prod(dims))
    shards = int(np.prod(dims[:-1]))
    if args.batch % shards:
        print(f"error: --batch {args.batch} does not divide over "
              f"{shards} data ranks", file=sys.stderr)
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
        # rank = (node * dp + data) * tp + model.  A MoE loss carries the
        # router's aux loss, which each model rank computes from its own
        # copies of the replicated leaves; those drift apart as the
        # reference's do under check_vma=False, so only the ranks of one
        # model index agree
        tp = dims[-1]
        cols = [results[m::tp] for m in range(tp)]
        if get_config(args.arch).moe is None:
            cols = [results]
        if any(r["history"] != col[0]["history"] for col in cols
               for r in col):
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
        if res.get("cluster") is not None:
            rep["cluster"] = res["cluster"]
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2, default=str)
        print(f"run report -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
