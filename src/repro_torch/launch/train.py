"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
      --smoke --steps 50 --mesh-shape 2,1 --device cpu --dist gloo

Port of ``src/repro/launch/train.py``.  ``--smoke`` swaps in the reduced
config (2 layers, d_model 256).  The mesh shape is (data, model), and
``--nodes N`` (or a ``--cluster`` name, which implies its node count)
prepends a node axis, as the reference's ``make_cluster_mesh``: the mesh is
(node, data, model), N x dp x tp ranks, the global batch divides over
dp x N, and the gradient sync is the hierarchical all-reduce over the
cluster's tiers (``repro_torch.cluster``).  ``--pods P`` with ``--nodes``
prepends a pod axis too, (pod, node, data, model): the three-tier cluster,
whose pod tier crosses the spine as its own communicator and joins the
gradient sync and the rail-local expert all_to_all; ``--pods`` without
``--nodes`` exits 2 with the reference's message.  A 3-dim
``--mesh-shape`` without ``--nodes`` is the legacy (pod, data, model)
mesh, whose pod axis is a plain reduction.  Every rank is a process
(``launch.mesh.run_ranks``) that builds the same global weights from seed
0 and keeps its model-axis shards of them
(``convert.shard_params``; ep_a2a experts over the ep span as well),
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
profile of a cluster run, else into the node profile.  ``--fault`` is a
fault timeline (repro_torch.faults, DESIGN.md §14): every rank attaches a
FabricClock, whose committed transitions re-key the communicators warm;
a ``node<i>@stepN=down`` event, which needs ``--ckpt-dir`` and a
``--ckpt-every`` below it, rebuilds the process groups over the surviving
ranks and resumes from the latest snapshot, while the lost node's ranks
leave.  ``--bucket-mb`` > 0
buckets the gradient sync and launches each bucket from the backward
(train/bucketer.py); with a lossy ``--compress`` codec the AdamW state is
paired with error-feedback residuals, this rank's shards of them on a
model axis.  A node loss with ``--pods`` > 1 exits 2 before any rank is
spawned: the reference's resume rebuilds the mesh without its pod axis.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.core.communicator import CommConfig
from repro_torch.data.pipeline import make_batches
from repro_torch.faults.elastic import NEEDS_CKPT
from repro_torch.launch.steps import (build_train_program, local_params,
                                      rank_specs)
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.train.train_step import ef_init_residuals


#: the reference's refusal of --pods without a multi-node cluster
NEEDS_NODES = ("--pods > 1 needs a multi-node cluster run (--nodes/"
               "--cluster): the pod tier composes above the NIC tier")
#: the refusal of a node loss on a pod mesh
NODE_LOSS_ON_PODS = ("--fault node events with --pods > 1: elastic resume "
                     "rebuilds a (node, data, model) mesh over the "
                     "survivors, and the reference's drops the pod axis "
                     "there, so the resumed run would not be the launched "
                     "fabric")


def resolve_fabric(args, profile: str = "h100"):
    """``(cluster or None, node count, pod count, intra profile, timeline
    or None)`` of ``--cluster``, ``--nodes``, ``--pods``, ``--degrade`` and
    ``--fault`` (the reference's resolve_cluster then resolve_faults; a
    step-0 event always folds statically, the later ones make the
    timeline; pods count for the spine targets)."""
    from repro_torch.configs.clusters import resolve_cluster, resolve_faults
    cluster, nodes, pods = resolve_cluster(getattr(args, "cluster", ""),
                                           args.nodes, args.pods)
    if cluster is not None:
        profile = cluster.node.name
    cluster, profile, timeline = resolve_faults(cluster, nodes, profile,
                                                degrade=args.degrade,
                                                fault=args.fault, pods=pods)
    return cluster, nodes, pods, profile, timeline


def mesh_axes(n_dims: int, nodes: int) -> tuple:
    """The axes of a launch's mesh of ``n_dims`` dims: with nodes, (node,
    data, model) or (pod, node, data, model), as the reference's
    ``make_cluster_mesh``; without, (data, model) or the legacy (pod,
    data, model)."""
    if nodes > 1:
        return ("pod", "node", "data", "model")[-n_dims:]
    return ("data", "model") if n_dims == 2 else ("pod", "data", "model")


def node_events(timeline) -> bool:
    """Whether a fault timeline (or None) loses a node (the serve
    launcher's check too)."""
    return timeline is not None and any(e.kind == "node"
                                        for e in timeline.events)


def train_rank(args: argparse.Namespace, dims, world: int) -> dict:
    """One rank's training run (or the only one, with ``world == 1``):
    weights from seed 0 (this rank's model-axis shards), the global
    synthetic batch stream, this rank's rows of it.  ``dims`` is (data,
    model), (node, data, model) or (pod, node, data, model) on a cluster,
    or the legacy (pod, data, model) (``mesh_axes``).  Rank 0 logs and
    saves the tuning cache; the ranks of pod 0, node 0 and data row 0
    checkpoint (model rank 0 writes), decided again after an elastic
    resume.  The result carries each communicator's tier by axis; with
    ``--fault`` the clock's report, and on the ranks of a lost node
    ``dropped_at``."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    cluster, nodes, _, profile, timeline = resolve_fabric(args)
    axes = mesh_axes(len(dims), nodes)
    mesh = Mesh(dims, axes, device=args.device) if world > 1 else None
    rank = mesh.rank if mesh is not None else 0
    device = mesh.device if mesh is not None else torch.device(args.device)
    comm = CommConfig(backend=args.backend, profile=profile,
                      timing=args.timing,
                      secondary_algo=args.secondary_algo,
                      tuning_cache=args.tuning_cache,
                      compress=args.compress,
                      # canonical schedule spec: a faulted run never shares
                      # a memoized communicator with a fault-free one
                      fault=timeline.spec() if timeline else "")
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

    def batches_fn():
        return make_batches(cfg, seq_len=args.seq_len,
                            batch_per_shard=args.batch)

    clock = handler = None
    if timeline is not None:
        from repro_torch.faults import FabricClock, make_train_resume
        clock = FabricClock(timeline).attach(ctx)
        if node_events(timeline):
            handler = make_train_resume(
                cfg, opt=opt, comm_config=comm, mesh=mesh,
                cluster=ctx.cluster, ckpt_dir=args.ckpt_dir,
                batches_fn=batches_fn, bucket_mb=args.bucket_mb,
                log=print if lead else (lambda *_: None))
    loop = LoopConfig(total_steps=args.steps, log_every=5 if lead else 0,
                      ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir or None, param_specs=specs,
                      tuning_cache=(args.tuning_cache or None) if lead
                      else None, faults=clock, on_node_loss=handler)
    try:
        _, _, hist = run_loop(program, params, opt_state, batches_fn(),
                              ctx, loop)
    finally:
        program.close()
    # after an elastic resume the clock holds the rebuilt ctx
    final = clock.ctx if clock is not None else ctx
    report = dict(loop.report or {})
    dropped = report.pop("dropped_at", None)
    comm_report = final.comm_report()
    return {"history": hist, "report": report,
            "cluster": comm_report.get("cluster"),
            "tiers": {c.axis_name: comm_report[c.axis_name]["tier"]
                      for c in final.comms()},
            "faults": clock.report() if clock is not None else None,
            "dropped_at": dropped}


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
                    help="pod count of a multi-node run: prepends a pod "
                         "axis; the pod tier crosses the spine as its own "
                         "communicator (DESIGN.md §15)")
    ap.add_argument("--degrade", default="",
                    help="launch-time fault injection name[:member]=factor "
                         "(e.g. rail3=0.25, nvlink=0.5): the NIC tier or "
                         "the node profile runs degraded from step 0")
    ap.add_argument("--fault", default="",
                    help="fault-timeline schedule (repro_torch.faults, "
                         "DESIGN.md §14), e.g. 'rail3@step200=0.25,rail3@"
                         "step600=1.0,node1@step400=down': per-member "
                         "degradation, full-link loss (=down) and elastic "
                         "whole-node loss at step boundaries.  Transitions "
                         "commit through the FabricClock's hysteresis and "
                         "warm-start Stage 2 from the nearest TuningProfile "
                         "entry; node loss rebuilds the process groups over "
                         "the surviving ranks and resumes from the latest "
                         "checkpoint")
    ap.add_argument("--backend", choices=["flexlink", "nccl"],
                    default="flexlink")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint period in steps (0 = final only); an "
                         "elastic node-loss schedule needs one below the "
                         "fault horizon")
    ap.add_argument("--out", default="",
                    help="write a JSON run report (losses, program stats, "
                         "tuning provenance, fault transitions)")
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

    dims = tuple(int(x) for x in args.mesh_shape.split(",")) \
        if args.mesh_shape else (1, 1)
    try:
        _, nodes, pods, _, timeline = resolve_fabric(args)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if pods > 1 and nodes <= 1:
        print(f"error: {NEEDS_NODES}", file=sys.stderr)
        return 2
    if node_events(timeline) and not args.ckpt_dir:
        print(f"error: {NEEDS_CKPT}", file=sys.stderr)
        return 2
    if node_events(timeline) and pods > 1:
        print(f"error: {NODE_LOSS_ON_PODS}", file=sys.stderr)
        return 2
    if nodes > 1:
        if len(dims) != 2:
            print("error: --nodes combines with a 2-dim (data, model) "
                  "--mesh-shape only", file=sys.stderr)
            return 2
        dims = ((pods,) if pods > 1 else ()) + (nodes,) + dims
    elif len(dims) not in (2, 3):
        print("error: --mesh-shape takes (data, model) or (pod, data, "
              "model)", file=sys.stderr)
        return 2
    world = int(np.prod(dims))
    shards = int(np.prod(dims[:-1]))
    if args.batch % shards:
        print(f"error: --batch {args.batch} does not divide over "
              f"{shards} data ranks", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import device_error, run_ranks
    err = device_error(args.device, args.dist, world)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2

    if world > 1:
        # by its module's name, so spawned ranks unpickle it under
        # ``python -m`` too
        from repro_torch.launch import train as this
        device = "cuda" if args.device.startswith("cuda") else "cpu"
        args.device = device
        results = run_ranks(this.train_rank, world, backend=args.dist,
                            device=device, timeout_s=3600,
                            args=(args, dims, world))
        # rank = ((pod * nodes + node) * dp + data) * tp + model.  A MoE
        # loss carries the router's aux loss, which each model rank
        # computes from its own copies of the replicated leaves; those
        # drift apart as the reference's do under check_vma=False, so only
        # the ranks of one model index agree
        # ranks of a lost node stopped at dropped_at: their losses are
        # the survivors' first dropped_at
        tp = dims[-1]
        live = [r for r in results if r["dropped_at"] is None]
        cols = [live[m::tp] for m in range(tp)]
        if get_config(args.arch).moe is None:
            cols = [live]
        if any(r["history"] != col[0]["history"] for col in cols
               for r in col) or any(
                   r["history"] != live[0]["history"][:r["dropped_at"]]
                   for r in results if r["dropped_at"] is not None):
            print("error: the ranks' losses differ", file=sys.stderr)
            return 1
        res = live[0]
    else:
        res = train_rank(args, dims, world)
    hist = res["history"]
    print(f"final loss: {hist[-1]:.4f} (from {hist[0]:.4f})")
    if args.out:
        rep = {"final_loss": hist[-1], "losses": hist, "steps": args.steps,
               "device": args.device, "dist": args.dist, "ranks": world,
               "tiers": res["tiers"], **(res["report"] or {})}
        if res.get("cluster") is not None:
            rep["cluster"] = res["cluster"]
        if res.get("faults") is not None:
            rep["faults"] = res["faults"]
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2, default=str)
        print(f"run report -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
