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
draining ends.  The communicator's default profile is ``h100`` (the reference's
launcher uses ``tpu_v5e``).  ``--degrade --fault --nodes --pods`` need
tiers not ported yet and exit 2 naming the ROADMAP item: 13 (faults), 12
(two-tier cluster), 14 (pod tier).
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
from repro_torch.launch.train import unported
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
                    help="fault injection name[:member]=factor: not ported "
                         "yet (ROADMAP queue 1 item 13), exits 2")
    ap.add_argument("--fault", default="",
                    help="fault-timeline schedule over serve ticks: not "
                         "ported yet (item 13), exits 2")
    ap.add_argument("--nodes", type=int, default=1,
                    help="cluster node count: > 1 is not ported yet (item "
                         "12), exits 2")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod count: > 1 is not ported yet (item 14), "
                         "exits 2")
    args = ap.parse_args(argv)

    missing = unported(args)
    if missing:
        print(f"error: not ported yet: {missing}", file=sys.stderr)
        return 2
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
    ctx = ParallelCtx(comm_config=CommConfig(
        timing=args.timing, secondary_algo=args.secondary_algo,
        tuning_cache=args.tuning_cache, compress=args.compress))
    if not ctx.comms() and (args.timing != "sim" or args.tuning_cache
                            or args.secondary_algo != "ring"
                            or args.compress):
        print("note: single-device launch has no communicators — "
              "--timing/--tuning-cache/--secondary-algo/--nodes/--degrade/"
              "--fault/--compress take effect only with parallel axes (the "
              "decode wave itself never crosses the NIC tier; see "
              "launch/shapes.py)")
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
                       "program": pr}, f, indent=2, default=str)
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
