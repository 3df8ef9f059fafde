"""Serving launcher: batched request serving — wave engine or the
continuous-batching paged engine (DESIGN.md §13).

Port of ``src/repro/launch/serve.py`` (its flags, workload builder and
printed lines), plus ``--device`` (default ``cuda``; no card means exit
2, never a silent CPU run) and ``--attn-impl`` for the paged engine's
attention (``kernel`` = the CUDA flash-decode kernel).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --requests 8 --paged on --attn-impl kernel --mixed

The launcher serves on one device, as the reference's: the engines take
no model axis (serving across devices is
``launch/steps.build_serve_program``).  ``--tuning-cache --timing
--secondary-algo --compress`` are kept for the reference's command-line
contract only: they go into the ``CommConfig`` of its one-device ctx,
which has no communicator, so they change nothing and print the
reference's note; ``--tuning-cache`` also saves the (empty) profile when
draining ends.  The communicator's default profile is ``h100`` (the
reference's launcher uses ``tpu_v5e``).  As the reference's, ``--nodes N``
> 1 builds ``cluster_for(profile, N, pods=P)`` (``--pods P``) into the
one-device ctx, which registers the NIC tier's profile, and the pod tier's
when P > 1, and records the topology (printed, and in the ``--out``
record); the decode never crosses the NIC tier.
``--degrade`` degrades the NIC tier or the node profile of the run's
fabric (``configs/clusters.resolve_faults``).  ``--fault`` takes link and
member schedules over serve ticks: a FabricClock is attached to the ctx,
the engine advances it once a tick, and the record carries its report
(the one-device ctx has no communicator to re-key, as the reference's);
node events need the training loop's elastic resume and exit with the
reference's message.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.core.communicator import CommConfig
from repro_torch.launch.train import node_events
from repro_torch.models.tp import ParallelCtx
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import (PagedServeConfig, PagedServeEngine,
                                        ServeConfig, ServeEngine)


def build_workload(rng, n_requests: int, vocab: int, max_new: int,
                   mixed: bool):
    """(prompt, max_new) pairs.  --mixed interleaves short chat-style and
    long document-style requests — the population where wave scheduling
    collapses (a long request holds the whole wave)."""
    work = []
    for i in range(n_requests):
        if mixed and i % 2 == 1:
            plen = int(rng.integers(16, 33))
            mnew = max(max_new, 16)
        else:
            plen = int(rng.integers(3, 9))
            mnew = max(4, max_new // 2) if mixed else max_new
        work.append((rng.integers(1, vocab, size=plen).tolist(), mnew))
    return work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ALIASES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; without a CUDA card "
                         "'cuda' exits 2 (pass 'cpu' to run on the CPU)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged", choices=["on", "off"], default="off",
                    help="'on': continuous batching over the paged KV "
                         "cache; 'off': the wave engine (the parity "
                         "baseline)")
    ap.add_argument("--attn-impl", choices=["reference", "kernel"],
                    default="reference",
                    help="paged attention: 'reference' = dense block-gather "
                         "(bit-identical to the wave engine), 'kernel' = "
                         "the flash-decode kernel (CUDA on the card, its "
                         "plain version on the CPU)")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="tokens per paged KV block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool blocks per layer (0 = auto-size, no "
                         "preemption pressure)")
    ap.add_argument("--max-tokens-in-flight", type=int, default=32,
                    help="packed-row budget per tick (top batch-shape "
                         "bucket)")
    ap.add_argument("--max-requests", type=int, default=8,
                    help="concurrent admitted requests (paged engine)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed short/long prompt+output lengths")
    ap.add_argument("--assert-warm", action="store_true",
                    help="exit 2 unless the engine built at most one step "
                         "per batch-shape bucket (admission-driven shape "
                         "changes must be exec-cache hits)")
    ap.add_argument("--out", default="",
                    help="write the serve record (serving block + cache "
                         "stats) to this JSON path")
    ap.add_argument("--tuning-cache", default="",
                    help="TuningProfile JSON: warm-start Stage-1 shares "
                         "and persist them back when draining finishes")
    ap.add_argument("--timing", choices=["sim", "measured"], default="sim",
                    help="Stage-2 TimingSource (control/timing.py)")
    ap.add_argument("--secondary-algo", choices=["ring", "tree"],
                    default="ring")
    ap.add_argument("--compress", default="",
                    help="secondary-path wire codecs, e.g. 'secondary=fp8' "
                         "or 'staged=bf16,ortho=fp8' (DESIGN.md §12)")
    ap.add_argument("--degrade", default="",
                    help="launch-time fault injection name[:member]=factor "
                         "on the NIC tier (with --nodes > 1) or the node "
                         "profile")
    ap.add_argument("--fault", default="",
                    help="fault-timeline schedule over serve TICKS "
                         "(repro_torch.faults, DESIGN.md §14), e.g. "
                         "'rail3@step20=0.25,rail3@step60=1.0'; link and "
                         "member events only (node loss needs the training "
                         "loop's elastic resume)")
    ap.add_argument("--nodes", type=int, default=1,
                    help="cluster node count: registers the NIC-tier "
                         "profile (so --tuning-cache keys line up with "
                         "multi-node launches) and records the topology "
                         "on the ctx.  This launcher itself is "
                         "single-device: the decode never crosses the NIC "
                         "tier")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod count for the registered topology: with "
                         "--nodes > 1 the synthesized cluster grows the "
                         "pod tier (DESIGN.md §15), so tuning-cache keys "
                         "line up with three-tier launches")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device} but no CUDA card is present; "
              f"pass --device cpu to serve on the CPU", file=sys.stderr)
        return 2

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    # one device's ctx, with the comm config plumbed so a multi-axis
    # deployment of this launcher inherits the control-plane flags
    from repro_torch.cluster.topology import cluster_for
    from repro_torch.configs.clusters import resolve_faults
    profile = "h100"
    pods = max(args.pods, 1)
    cluster = (cluster_for(profile, args.nodes, pods=pods)
               if args.nodes > 1 else None)
    try:
        cluster, profile, timeline = resolve_faults(
            cluster, args.nodes, profile, degrade=args.degrade,
            fault=args.fault, pods=pods)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if node_events(timeline):
        raise SystemExit("--fault node events need the training loop's "
                         "elastic resume; serving supports link/member "
                         "schedules only")
    ctx = ParallelCtx(comm_config=CommConfig(
        profile=profile, timing=args.timing,
        secondary_algo=args.secondary_algo,
        tuning_cache=args.tuning_cache, compress=args.compress,
        fault=timeline.spec() if timeline else ""),
        cluster=cluster)
    clock = None
    if timeline is not None:
        from repro_torch.faults import FabricClock
        clock = FabricClock(timeline).attach(ctx)
    if not ctx.comms() and (args.timing != "sim" or args.tuning_cache
                            or args.secondary_algo != "ring"
                            or args.nodes > 1 or args.degrade
                            or args.compress or args.fault):
        print("note: single-device launch has no communicators — "
              "--timing/--tuning-cache/--secondary-algo/--nodes/--degrade/"
              "--fault/--compress take effect only with parallel axes (the "
              "decode wave itself never crosses the NIC tier; see "
              "launch/shapes.py)")
    if cluster is not None:
        pod = (f", {cluster.n_pods} pods, pod tier "
               f"{cluster.pod_tier.name}" if cluster.pod_tier else "")
        print(f"cluster: {cluster.name}, {cluster.n_nodes} nodes of "
              f"{cluster.node.name}, NIC tier {cluster.nic_tier.name}{pod} "
              f"(registered; the decode runs on one device)")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    if args.paged == "on":
        engine = PagedServeEngine(params, cfg, ctx, PagedServeConfig(
            max_requests=args.max_requests, cache_len=96,
            kv_block=args.kv_block, n_blocks=args.kv_blocks,
            max_tokens_in_flight=args.max_tokens_in_flight,
            attn_impl=args.attn_impl))
    else:
        engine = ServeEngine(params, cfg, ctx,
                             ServeConfig(slots=args.slots, cache_len=96))
    rng = np.random.default_rng(0)
    t0 = time.time()
    for prompt, mnew in build_workload(rng, args.requests, cfg.vocab,
                                       args.max_new, args.mixed):
        engine.submit(prompt, max_new=mnew, temperature=args.temperature)
    engine.run_until_drained()
    dt = time.time() - t0
    fin = engine.finished()
    total_toks = sum(len(v) for v in fin.values())
    print(f"served {len(fin)} requests, {total_toks} tokens "
          f"in {dt:.1f}s ({total_toks / dt:.1f} tok/s, "
          f"engine={args.paged == 'on' and 'paged' or 'wave'}, "
          f"device={device})")
    rep = engine.comm_report()
    ec = rep["executable_cache"]
    print(f"decode executable cache: {ec['rebuilds']} rebuilds, "
          f"{ec['hits']} hits, {ec['evictions']} evictions")
    pr = rep["program"]
    print(f"decode issue/await: {pr['issued']} issued, "
          f"{pr['awaits']} awaited, {pr['in_flight']} in flight")
    assert pr["in_flight"] == 0
    srv = rep["serving"]
    if srv["engine"] == "paged":
        tif = srv["tokens_in_flight"]
        bc = srv["batch_bucket_cache"]
        kv = srv["kv_blocks"]
        print(f"serving: {srv['steps']} packed steps, tokens in flight "
              f"peak {tif['peak']}/{tif['budget']}, buckets "
              f"{srv['buckets']}, bucket-cache hit rate {bc['hit_rate']} "
              f"({bc['hits']} hits / {bc['rebuilds']} rebuilds)")
        print(f"serving: {srv['scheduler']['preemptions']} preemptions, "
              f"kv blocks peak {kv['peak_in_use']}/{kv['total']}, "
              f"median step {srv['step_ms']['median']:.3f} ms")
    if clock is not None:
        fr = clock.report()
        print(f"faults: {len(fr['transitions'])} transition(s), "
              f"{fr['rekeys']} re-key(s), {fr['suppressed_flaps']} "
              f"suppressed flap(s)")
    if args.tuning_cache:
        n = engine.save_tuning(args.tuning_cache)
        print(f"tuning profile: {n} slots -> {args.tuning_cache}")
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "engine": srv["engine"],
                       "device": str(device), "requests": len(fin),
                       "tokens": total_toks, "wall_s": round(dt, 3),
                       "serving": srv, "executable_cache": ec,
                       "program": pr, "profile": profile,
                       "cluster": cluster.describe() if cluster else None,
                       **({"faults": clock.report()} if clock else {})},
                      f, indent=2, default=str)
        print(f"serve record -> {args.out}")
    for rid in sorted(fin)[:4]:
        print(f"  req {rid}: {fin[rid][:10]}")
    assert len(fin) == args.requests

    if args.assert_warm:
        # at most one build per batch-shape bucket (a single-device ctx
        # has one plan signature), and non-vacuous hits on the paged path
        failures = []
        buckets = max(len(pr.get("shape_buckets", [])), 1)
        if ec["rebuilds"] > buckets:
            failures.append(
                f"{ec['rebuilds']} rebuilds > {buckets} bucket(s): "
                "admission-driven shape changes rebuilt the step")
        if srv["engine"] == "paged" and ec["hits"] == 0:
            failures.append("no exec-cache hits — vacuous bucket check")
        if failures:
            for msg in failures:
                print(f"[FAIL] --assert-warm: {msg}")
            engine.close()
            return 2
        print(f"[OK] --assert-warm: {ec['rebuilds']} rebuilds across "
              f"{buckets} bucket(s)")
    engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
