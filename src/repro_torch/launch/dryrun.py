"""Multi-pod dry-run driver.

For every (architecture x input shape x mesh) this lowers the EXACT step
the launchers run, on ``meta`` tensors: no byte of the model is
allocated, no kernel runs and no rank is spawned.  It records the
collectives the step issues, this rank's argument and output bytes, the
analytic roofline and the Stage-1 tuning.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k --mesh single --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Port of ``src/repro/launch/dryrun.py``.  The reference forces 512 host
devices and lowers + compiles a ``shard_map`` program over them; here one
process is rank 0 of a dry mesh (``launch/mesh.py``'s ``Mesh.dry``: the
production meshes (16, 16) and (2, 16, 16), or the ``--mesh-split`` /
``--nodes`` / ``--pods`` ones), which has no process group: its
collectives log ``(op, axis, dtype, bytes)`` and answer with ``meta``
tensors.  ``StepProgram.lower`` runs the launchers' own programs
(``build_train_program`` / ``build_prefill_program`` /
``build_serve_program``) once on meta params (``eval_shape_params``, cut
to this rank's shards), meta optimizer state and the meta inputs of
``launch/shapes.py``.  The serve step takes the position as a host int;
the dry-run passes ``seq_len - 1`` (the fullest cache, the roofline's).
Any position gives the same collectives: the position picks only which
shard writes the new K/V (a host branch with no collective) and the
attention masks, while every collective's shape comes from the batch and
the cache.

The record has the reference's keys, with these differences:

* ``collective_structure`` (calls by ``op@axis``) in place of
  ``hlo_collective_structure``, counted over the log's ``traced`` calls:
  those issued outside ``ParallelCtx.unrecorded()``, the reference's scan
  body once (a layer loop's first layer, its backward, everything outside
  the loop);
* ``collective_calls``: the traced calls ``[op, axis, dtype, bytes]`` in
  order, the calls and bytes of every executed call by ``op@axis``;
* ``memory_analysis``: this rank's argument bytes (its param and
  optimizer shards, its rows of the batch, its cache block, the position
  as the reference's int32 scalar) and output bytes, from their meta
  tensors.  No compiler is asked, so there is no temp or generated-code
  figure;
* no ``hlo_cost_analysis_raw`` and no ``compile_s``: nothing is compiled
  (the roofline's FLOPs and bytes are the analytic cost model's, in the
  reference too);
* the roofline's ``t_*`` terms use the H100's datasheet peaks
  (``roofline/analysis.py``).

``run_one`` takes one keyword more than the reference's, ``profile``: the
intra-node profile when no named cluster sets it, ``h100`` as in the
port's launchers (the reference's is ``tpu_v5e``).  The ``[a2a]`` line
prints ``rail_balance`` only when it is a number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.core.communicator import CommConfig, comm_release
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import (Mesh, make_production_mesh, mesh_dims,
                                     mesh_nodes)
from repro_torch.launch.steps import (build_prefill_program,
                                      build_serve_program,
                                      build_train_program,
                                      eval_shape_opt_state,
                                      eval_shape_params, local_batch,
                                      local_inputs, local_params, rank_specs)
from repro_torch.runtime.program import tree_bytes


def default_node_split(nodes: int, pods: int = 1):
    """(data, model) split for an N-node mesh with no --mesh-split: the
    largest power-of-two pod slice of 512 ranks (pods * nodes * d * m <=
    512), model axis first up to the production 16 (the reference's
    forced device count)."""
    budget = max(512 // max(nodes * max(pods, 1), 1), 1)
    m = min(budget, 16)
    return (max(budget // m, 1), m)


def node_layout(nodes: int, mesh_split, pods: int = 1):
    """The (data, model) split an N-node run uses — ONE derivation shared
    by run_one (which builds the mesh from it) and main (which names the
    result-cache file from it)."""
    return (tuple(mesh_split) if mesh_split is not None
            else default_node_split(nodes, pods))


def _dry_mesh(multi_pod: bool, mesh_split, nodes: int, pods: int):
    """(mesh, name) of one run: a cluster mesh with nodes, the split pod,
    or the production mesh."""
    if nodes > 1:
        if multi_pod:
            raise ValueError("--nodes does not combine with the multi-pod "
                             "mesh (pick one outer axis)")
        split = node_layout(nodes, mesh_split, pods)
        name = f"nodes{nodes}x{split[0]}x{split[1]}"
        if pods > 1:
            return (Mesh.dry((pods, nodes) + tuple(split),
                             ("pod", "node", "data", "model")),
                    f"pods{pods}-" + name)
        return Mesh.dry((nodes,) + tuple(split),
                        ("node", "data", "model")), name
    if mesh_split is not None and not multi_pod:
        return (Mesh.dry(tuple(mesh_split), ("data", "model")),
                f"single{mesh_split[0]}x{mesh_split[1]}")
    return (make_production_mesh(multi_pod=multi_pod),
            "multi" if multi_pod else "single")


def _lower(cfg, shape, mesh, comm, *, remat, cluster, bucket_mb):
    """Build the launchers' program for ``shape`` and lower it on meta
    arguments: (lowered step, this rank's argument bytes, the ctx's
    tuning status and comm report), read before the program is retired;
    the converged shares are saved to the comm's tuning cache."""
    pods, dp, tp = mesh_dims(mesh)
    batch = SH.input_specs(cfg, shape, tp=tp, dp=dp, pods=pods)
    prog = None
    try:
        if shape.kind == "train":
            prog, ctx = build_train_program(cfg, mesh, comm=comm,
                                            remat=remat, cluster=cluster,
                                            bucket_mb=bucket_mb)
        elif shape.kind == "prefill":
            prog, ctx = build_prefill_program(cfg, mesh, comm=comm,
                                              remat=remat, cluster=cluster)
        else:
            prog, ctx, _ = build_serve_program(cfg, mesh, shape, comm=comm,
                                               cluster=cluster)
        params = local_params(eval_shape_params(cfg), rank_specs(cfg, ctx),
                              ctx)
        if shape.kind == "train":
            opt = eval_shape_opt_state(params)
            if bucket_mb > 0 and ctx.ef_codec_name():
                # lossy wire codec: error-feedback residuals ride the opt
                # state, param-shaped (train_step.py docstring)
                opt = (opt, pytree.tree_map(torch.empty_like, params))
            lowered = prog.lower(params, opt, batch)
            args = (params, opt, local_batch(batch, ctx, mesh.device))
        elif shape.kind == "prefill":
            lowered = prog.lower(params, batch)
            args = (params, local_batch(batch, ctx, mesh.device))
        else:
            isp = SH.input_partition_specs(cfg, shape, tp=tp, dp=dp,
                                           pods=pods)
            cache = local_inputs(batch["cache"], isp["cache"], mesh)
            # the last position (module docstring: any gives the same
            # collectives)
            lowered = prog.lower(params, cache, batch["token"],
                                 shape.seq_len - 1)
            # the position as the reference's int32 scalar argument
            args = (params, cache,
                    local_inputs(batch["token"], isp["token"], mesh),
                    batch["pos"])
        # warm/cold Stage-1 provenance per slot, and the shares persisted
        # for the next launch
        if comm.tuning_cache:
            ctx.save_tuning_profile(comm.tuning_cache)
        return (lowered, tree_bytes(args), ctx.tuning_status(),
                ctx.comm_report())
    finally:
        # retire the probe program even on failure: a --all sweep builds
        # one per (arch, shape, mesh) and main() catches per-pair
        # exceptions
        if prog is not None:
            prog.close()


def run_one(arch: str, shape_name: str, multi_pod: bool,
            backend: str = "flexlink", mesh_split=None,
            remat=True, variant: str = "",
            tuning_cache: str = "", secondary_algo: str = "ring",
            nodes: int = 1, cluster_name: str = "",
            degrade: str = "", bucket_mb: float = 0.0,
            compress: str = "", fault: str = "",
            cluster_pods: int = 0, profile: str = "h100") -> dict:
    """The reference's ``run_one``: mesh_split, a (data, model) reshape of
    the 256-rank pod; remat True | False | "dots"; tuning_cache, a
    TuningProfile JSON the Stage-1 shares warm-start from and are saved
    back to; nodes > 1 prepends a node axis (the two-tier hierarchical
    sync), cluster_pods > 1 a pod axis above it (three tiers, the
    rail-local MoE dispatch); degrade / fault, a static fault or a fault
    timeline (its projection rides the record); compress, the secondary
    paths' wire codecs.  ``profile`` is the intra profile when no named
    cluster sets one."""
    from repro_torch.configs.clusters import resolve_cluster, resolve_faults
    cfg = get_config(arch)
    shape = SH.SHAPES[shape_name]
    cluster, nodes, cluster_pods = resolve_cluster(cluster_name, nodes,
                                                   cluster_pods)
    cluster, intra_profile, timeline = resolve_faults(
        cluster, nodes, cluster.node.name if cluster else profile,
        degrade=degrade, fault=fault, pods=cluster_pods)
    if cluster_pods > 1 and nodes <= 1:
        raise ValueError("--pods > 1 needs a multi-node run (--nodes or a "
                         "3-tier --cluster): the pod tier composes above "
                         "the NIC tier")
    mesh, mesh_name = _dry_mesh(multi_pod, mesh_split, nodes, cluster_pods)
    chips = mesh.world
    # runtime_balancing=False keeps the lowered step out of any Stage-2
    # replay log, and the dry mesh gives the run its own communicators
    comm = CommConfig(backend=backend, profile=intra_profile,
                      runtime_balancing=False, tag="dryrun",
                      tuning_cache=tuning_cache,
                      secondary_algo=secondary_algo, compress=compress,
                      fault=timeline.spec() if timeline else "")
    pods, dp, tp = mesh_dims(mesh)
    try:
        lowered, arg_bytes, tuning_status, comm_rep = _lower(
            cfg, shape, mesh, comm, remat=remat, cluster=cluster,
            bucket_mb=bucket_mb)
    finally:
        comm_release(mesh)      # a dry mesh lives for one run

    # fault-transition table (repro_torch.faults, DESIGN.md §14): a
    # dry-run never advances fabric time, so this is the STATIC projection
    fault_proj = []
    if timeline is not None:
        from repro_torch.faults import FabricClock
        fault_proj = FabricClock(timeline).projection()
        for row in fault_proj:
            print(f"  [fault] step {row['step']:>5d} {row['kind']:<7s} "
                  f"{row['event']} (commits at step {row['commit_step']})",
                  flush=True)

    # per-member share table (DESIGN.md §10): one row per multi-member
    # link per tuned slot
    for axis, slots in sorted(tuning_status.items()):
        for slot_name, st in sorted(slots.items()):
            for link, weights in sorted((st.get("members") or {}).items()):
                total = sum(weights.values()) or 1
                cells = " ".join(f"{m}={w}({w / total:.0%})"
                                 for m, w in weights.items())
                print(f"  [members] {axis}/{slot_name} {link}: {cells}",
                      flush=True)

    # per-slot wire table (DESIGN.md §12): logical vs wire bytes + codec
    # id per path, and the aggregate wire scale the roofline uses
    wire_logical = wire_total = 0.0
    for axis, rep in sorted(comm_rep.items()):
        if not isinstance(rep, dict):
            continue
        for slot_name, desc in sorted(rep.items()):
            if not isinstance(desc, dict) or "wire" not in desc:
                continue
            w = desc["wire"]
            wire_logical += w["logical_bytes"]
            wire_total += w["wire_bytes"]
            if desc.get("codecs"):
                cells = " ".join(
                    f"{p}={row['codec']}"
                    f"({row['logical_bytes']}->{row['wire_bytes']}B)"
                    for p, row in sorted(w["paths"].items()))
                print(f"  [wire] {axis}/{slot_name}: {cells} "
                      f"saved={w['bytes_saved']}B", flush=True)
    wire_scale = (wire_total / wire_logical
                  if compress and wire_logical else 1.0)

    # cluster rollup + MoE-dispatch split (DESIGN.md §15)
    cluster_rep = comm_rep.get("cluster")
    if isinstance(cluster_rep, dict) and "a2a" in cluster_rep:
        a2a = cluster_rep["a2a"]
        bal = a2a["rail_balance"]
        bal = f" rail_balance={bal:.2f}" if isinstance(bal, float) else ""
        print(f"  [a2a] rail_local={a2a['rail_local_bytes']}B "
              f"spine={a2a['spine_bytes']}B intra={a2a['intra_bytes']}B"
              f"{bal} ({a2a['source']})", flush=True)

    out_bytes = lowered.output_bytes
    mem_report = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "note": "this rank's, from its meta tensors; no compiler is asked, "
                "so there is no temp or generated-code figure",
    }

    # --- roofline ---------------------------------------------------------
    # the analytic op inventory (roofline/analytic.py), as the reference's;
    # the logged calls give the collective STRUCTURE (kinds + axes)
    from repro_torch.roofline.analysis import HBM_BW, LINK_BW, PEAK_FLOPS
    from repro_torch.roofline.analytic import cost_model, step_time_bounds
    # the node axis is an outer data-parallel dimension for the cost model
    cm = cost_model(cfg, shape, tp=tp, dp=dp * mesh_nodes(mesh), pods=pods,
                    backend=backend, remat=remat,
                    ep_over_pods=cluster_pods > 1)
    t_compute = cm.flops_total / (chips * PEAK_FLOPS)
    t_memory = cm.hbm_bytes / (chips * HBM_BW)
    t_collective = cm.collective_bytes / (chips * LINK_BW)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    if bucket_mb > 0 and shape.kind == "train":
        grad_bytes = (cm.params / max(tp, 1)) * 4
        n_buckets = max(int(np.ceil(grad_bytes / (bucket_mb * 2 ** 20))), 1)
    else:
        n_buckets = 1
    bounds = step_time_bounds(t_compute, t_memory, t_collective,
                              n_buckets=n_buckets, wire_scale=wire_scale)
    model_flops = 6.0 * cm.active_params * (
        shape.global_batch * (shape.seq_len if shape.kind == "train" else 1))
    if shape.kind != "train":
        model_flops = 2.0 * cm.active_params * shape.global_batch * (
            shape.seq_len if shape.kind == "prefill" else 1)
    log = lowered.log
    roofline = {
        "chips": chips,
        "flops_fwd": cm.flops_fwd, "flops_total": cm.flops_total,
        "hbm_bytes": cm.hbm_bytes,
        "collective_bytes_total": cm.collective_bytes,
        "collective_by_axis": cm.coll_by_axis(),
        "collective_by_op": cm.coll_by_op(),
        "t_compute": t_compute, "t_memory": t_memory,
        "t_collective": t_collective, "dominant": dominant,
        **bounds,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / cm.flops_total
        if cm.flops_total else 0.0,
        "params": cm.params, "active_params": cm.active_params,
        "memory_per_chip": arg_bytes + out_bytes,
    }
    if compress:
        roofline["wire_scale"] = wire_scale
        roofline["wire_bytes_saved"] = int(wire_logical - wire_total)

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "backend": backend, "chips": chips, "ok": True,
        "variant": variant, "remat": str(remat),
        "degrade": degrade,
        **({"fault": fault, "faults": fault_proj} if fault else {}),
        **({"compress": compress} if compress else {}),
        **({"cluster": cluster_rep} if isinstance(cluster_rep, dict)
           else {}),
        "tuning": tuning_status,
        "lower_s": round(lowered.lower_s, 1),
        "memory_analysis": mem_report,
        "collective_structure": log.structure("traced"),
        "collective_calls": {
            "traced": [list(c) for c in log.traced],
            "executed_calls": log.structure("executed"),
            "executed_bytes": log.bytes_by("executed"),
        },
        "roofline": roofline,
    }
    return rec


def result_tag(args, arch: str, shape_name: str, mesh_name: str,
               nodes: int, pods: int, mesh_split) -> str:
    """The result-cache file's name of one pair: every knob that changes
    the record or the comm memo key is in it."""
    tag = f"{arch}__{shape_name}__{mesh_name}__{args.backend}"
    if nodes > 1:
        split = node_layout(nodes, mesh_split, pods)
        extra = f"nodes{nodes}x{split[0]}x{split[1]}"
        if pods > 1:
            extra = f"pods{pods}-" + extra
        if args.cluster:
            extra += f"-{args.cluster}"
        tag = f"{arch}__{shape_name}__{mesh_name}-{extra}__{args.backend}"
    if args.degrade:
        safe = args.degrade.replace(":", "_").replace("=", "-")
        tag += f"__degrade-{safe}"
    if args.fault:
        safe = (args.fault.replace(":", "_").replace("=", "-")
                .replace("@", "~").replace(",", "+"))
        tag += f"__fault-{safe}"
    if args.bucket_mb > 0:
        tag += f"__bmb{args.bucket_mb:g}"
    if args.compress:
        safe = (args.compress.replace(":", "_").replace("=", "-")
                .replace(",", "+"))
        tag += f"__compress-{safe}"
    return tag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALIASES) + ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SH.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--backend", choices=["flexlink", "nccl"],
                    default="flexlink")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) pair")
    ap.add_argument("--out", default="results/dryrun",
                    help="output dir (one json per pair)")
    ap.add_argument("--mesh-split", default="",
                    help="d,m reshape of the single pod (e.g. 2,4)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="node count: prepends a 'node' axis so the step "
                         "lowers the two-tier hierarchical gradient sync; "
                         "combine with --mesh-split")
    ap.add_argument("--cluster", default="",
                    help="named cluster topology from configs/clusters.py "
                         "(default: synthesized from the profile)")
    ap.add_argument("--pods", type=int, default=0,
                    help="pod count: prepends a 'pod' axis above the node "
                         "axis (three-level hierarchical sync, rail-local "
                         "MoE all_to_all).  A 3-tier --cluster implies "
                         "its pod count")
    ap.add_argument("--degrade", default="",
                    help="fault injection name[:member]=factor: scale one "
                         "link member's effective bandwidth (e.g. "
                         "rail3=0.25).  The degraded fabric keys its own "
                         "TuningProfile entries")
    ap.add_argument("--fault", default="",
                    help="fault-timeline schedule, e.g. 'rail3@step200="
                         "0.25,node1@step400=down': validated against the "
                         "run's fabric, its static transition table "
                         "printed; fabric time never advances")
    ap.add_argument("--tuning-cache", default="",
                    help="TuningProfile JSON: warm-start Stage-1 and save "
                         "the converged shares back after lowering")
    ap.add_argument("--secondary-algo", choices=["ring", "tree"],
                    default="ring")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="bucketed overlapped gradient sync: target bucket "
                         "size in MiB (train shapes).  0 = monolithic sync")
    ap.add_argument("--compress", default="",
                    help="secondary-path wire codecs, e.g. 'secondary=fp8' "
                         "or 'staged=bf16,ortho=fp8'")
    ap.add_argument("--assert-warm", action="store_true",
                    help="exit nonzero unless EVERY tuned slot was "
                         "warm-started with zero Stage-1 iterations")
    args = ap.parse_args(argv)
    mesh_split = (tuple(int(x) for x in args.mesh_split.split(","))
                  if args.mesh_split else None)
    from repro_torch.configs.clusters import resolve_cluster
    _, nodes, pods = resolve_cluster(args.cluster, args.nodes, args.pods)

    archs = sorted(ALIASES) if args.all else [args.arch]
    shapes_ = sorted(SH.SHAPES) if args.all else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    pairs = [(a, s, m) for a in archs for s in shapes_ for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    failures = cold_slots = checked_slots = 0
    for arch, shape_name, mesh_name in pairs:
        tag = result_tag(args, arch, shape_name, mesh_name, nodes, pods,
                         mesh_split)
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[run ] {tag}", flush=True)
        t0 = time.time()
        try:
            rec = run_one(arch, shape_name, mesh_name == "multi",
                          args.backend, mesh_split=mesh_split,
                          tuning_cache=args.tuning_cache,
                          secondary_algo=args.secondary_algo,
                          nodes=nodes, cluster_name=args.cluster,
                          degrade=args.degrade, bucket_mb=args.bucket_mb,
                          compress=args.compress, fault=args.fault,
                          cluster_pods=pods)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "backend": args.backend, "ok": False, "error": repr(e)}
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        status = "OK" if rec.get("ok") else "FAIL"
        extra = ""
        if rec.get("ok"):
            r = rec["roofline"]
            slots = [s for ax in rec.get("tuning", {}).values()
                     for s in ax.values()]
            warm = sum(s["warm"] for s in slots)
            cold_slots += len(slots) - warm
            checked_slots += len(slots)
            extra = (f" dominant={r['dominant']}"
                     f" tc={r['t_compute']:.2e} tm={r['t_memory']:.2e}"
                     f" tl={r['t_collective']:.2e}"
                     f" lower={rec['lower_s']}s"
                     f" wall={time.time() - t0:.1f}s"
                     f" slots={warm}/{len(slots)} warm")
        print(f"[{status:4s}] {tag}{extra}", flush=True)
    if args.assert_warm and (cold_slots or not checked_slots):
        # zero checked slots (every pair skipped as cached, or nothing
        # tuned) must fail too: a vacuous pass verifies nothing
        what = (f"{cold_slots} slot(s) ran Stage-1 cold" if cold_slots
                else "no tuned slots were checked (cached/skipped runs?)")
        print(f"[FAIL] --assert-warm: {what} (expected a full warm-start "
              f"from {args.tuning_cache or '<no --tuning-cache>'})",
              flush=True)
        return 2
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
