#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel from the checkout's CUDA sources (K6, K1, K2-K5 and K7, one
   ``nvcc`` per source, all at once), timed;
2. K6, the paged flash-decode kernel, against its plain PyTorch version at
   glm4-9b shapes (Hq 32, Hkv 2, hd 128, block 16; T in {1, 8, 32}, max
   blocks in {6, 256}; float32 and bfloat16; padding rows and a sliding
   window) at atol 3e-5 (f32) / 2e-2 (bf16), padding rows exact zeros;
3. reduced glm4-9b in float32 (TF32 off throughout): the paged engine
   with the kernel, the paged engine with the dense-gather reference and
   the wave engine give equal greedy streams;
4. full-width glm4-9b in bfloat16 (random weights from seed 0) through
   the serving launcher, ``--paged on --attn-impl kernel --requests 8
   --mixed``: every request served, K6 launched 40 x packed steps; then
   one packed step's logits with the kernel against the reference path;
5. K6 timed by CUDA events (median) at the phase-4 shape and at 256
   blocks, beside its plain version, ``F.scaled_dot_product_attention``
   on the gathered dense K/V (a yardstick the port never calls) and the
   memory bound of the card named in phase 1;
6. K1, the staged ring's chunk accumulate, against its plain version in
   float32 and bfloat16 at lengths {1, 1000, 2^20+7, 2^26}, aligned and
   one element off alignment: bit for bit, and equal to ``a + b`` in
   bfloat16;
7. the lossless multi-path collective through the communicator: 4 ranks
   (``launch.mesh.run_ranks``, gloo, all on this card, so their wire goes
   through host memory) with the ``h100`` profile:
   (a) mesh (data=2, model=2), the data axis's communicator with ortho
   axis model: tuned all-reduce, all-gather and reduce-scatter of 256 MiB
   bfloat16 small-integer payloads, and an all-reduce with an explicit
   three-route plan, each equal to the sum or concatenation the parent
   computes from the same inputs; (b) mesh (data=4): a tuned 1 GiB
   all-reduce, likewise; (c) mesh (data=4), shares 50/50 primary/staged
   on random bfloat16: the run with K1 bit-identical to the run with its
   plain version.  Every rank's ``plan_signature()`` agrees, and K1 ran
   (n-1) x staged_substeps times per staged reduce.  Wall times are of
   host-staged gloo on one card, not a link bandwidth;
8. K1 timed by CUDA events at the staged sub-chunk of (b) and at a
   64 MiB bfloat16 chunk, beside its plain version, ``a + b`` and the
   memory bound (3 x bytes over the card's rate), with the operands
   rotated over enough copies that each call reads device memory, not L2;
9. the wire codecs K2-K5 and the mixed (float32 + bfloat16) K1 against
   their plain versions on the card at lengths {1, 127, 1000, 2^20+7,
   2^26}, aligned and one element off, float32 and bfloat16 input, both
   fp8 formats, with NaN and inf groups: bit for bit (NaN at the same
   places, and with the same bits);
10. compressed collectives on 4 ranks (gloo on this card), ``h100``
   profile: (a) mesh (data=2, model=2), an explicit three-route
   all-reduce of 64 MiB random bfloat16 with fp8 on the staged and ortho
   routes; (b) the same mesh, tuned 256 MiB bfloat16 all-gather and
   reduce-scatter under ``compress="secondary=fp8"``; (c) mesh (data=4),
   a tuned 256 MiB float32 all-reduce under ``compress="staged=bf16"``.
   Each equals, bit for bit, the same collective run on CPU copies (the
   codecs' plain versions); gathered rows are equal on every rank of a
   line; the error against the exact sum stays within (n + 1) fp8 (or
   bf16) steps of each 128-element block's magnitude; K2-K5 and K1
   launches equal what the plans imply;
11. full-width glm4-9b training (depth cut 40 -> 2, bf16, random weights
   from seed 0), ``build_train_program`` + ``run_loop`` on 2 gloo ranks
   sharing this card, seq 128, global batch 8, 3 steps each with the
   ``nccl`` backend, ``flexlink`` and ``flexlink`` with
   ``--compress secondary=fp8``, AdamW at lr 1e-4: finite losses, equal
   on both ranks, falling; flexlink within 5e-3 of nccl per step, fp8
   within 0.05 max(|loss|, 1); the fp8 step's codec plans printed and
   the K2/K3/K4 launches equal to what those plans imply; peak memory;
12. (a) K2-K5 and the mixed K1 against their plain versions at every
   length, dtype and format their kernels were given in phase 11's fp8
   run and phase 10 (c), aligned and one element off, NaN and inf groups
   included: bit for bit (the ``max_abs_err`` of the kernels line); (b)
   the same kernels timed by CUDA events at one staged sub-chunk of
   their path (K2-K4: the lm_head gradient all-reduce of phase 11; K5 and
   the mixed K1: phase 10 (c)) and at 64 MiB, beside their plain
   versions, the memory bound and, for K5 and the mixed K1, the one
   PyTorch call that computes the same function.  Each timed call works
   on its own copy of the operands, rotated so that none is still in L2
   (as in phase 8).  Phase 12 runs after phase 13, and its check (a)
   also covers every length phase 13 gave K1;
13. tensor-parallel training of full-width glm4-9b (depth cut 40 -> 2,
   bf16, random weights from seed 0, each rank keeping its model-axis
   shards of the global init) on (data=2, model=2): 4 gloo ranks sharing
   this card, seq 128, global batch 8, 3 steps each with the ``nccl``
   backend and ``flexlink``, AdamW at lr 1e-4, the model axis's
   all-reduce slot pinned by a TuningProfile to primary/staged/ortho
   50/25/25 (the tuner would give these 4 MiB combines the primary route
   only): finite losses, equal on all 4 ranks, falling, flexlink within
   5e-3 of nccl; recorded calls a step (3 on the model axis, one a leaf
   on the data axis: the reference's per-trace counts); model-axis
   all-reduces executed a step (5 forward, 2 in the checkpoint
   recompute, 5 backward); K1 launches equal to what the executed plans
   imply; peak memory and wall time;
14. K7a/K7b, the payload split and merge, against their plain versions
   in float32 and bfloat16 at the reference test's cases, at lengths and
   offsets one element off its blocks and at 64 MiB (the second half of a
   128 MiB payload; four segments of 1/2, 1/4, 1/8, 1/8 of 64 MiB): bit
   for bit; timed at 64 MiB beside their plain versions,
   ``x[a:b].clone()`` / ``torch.cat`` and the memory bound, on rotated
   operand copies.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  The launches in that line are the
ranks' own counts from each kernel's path, summed: K1 from phase 7, K2-K4
from the fp8 training run of phase 11, K5 and the mixed K1 from phase
10 (c), K7 from phase 13 (0: no path calls it); each rank process sets
its counts to 0 just before that path and reports them just after it.
Without a CUDA card, or without the rest of the checkout beside this
file, it prints no result and exits 1.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# glm4-9b attention shapes (configs/glm4_9b.py) and the serving pool block
HQ, HKV, HD, BS = 32, 2, 128, 16
ATOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}

# datasheet figures (NVIDIA H100 data sheet, dense): memory bytes/s and
# bf16 tensor-core FLOP/s, by the card's name
CARD_PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
              "H100": (3.35e12, 989e12)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_peaks(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if all(part in name for part in key.split()):
            return key, CARD_PEAKS[key]
    raise RuntimeError(f"chip_smoke: no datasheet figures for {name!r}")


def make_case(gen, t_rows, maxb, dtype, n_pads=0):
    """q, pools, block tables (each row its own blocks) and kv_valid."""
    dev = "cuda"
    nb = t_rows * maxb
    q = torch.randn((t_rows, HQ, HD), generator=gen, device=dev).to(dtype)
    kp = torch.randn((nb, BS, HKV, HD), generator=gen, device=dev).to(dtype)
    vp = torch.randn((nb, BS, HKV, HD), generator=gen, device=dev).to(dtype)
    tables = torch.randperm(nb, generator=gen, device=dev).to(
        torch.int32).reshape(t_rows, maxb)
    kv_valid = torch.randint(1, maxb * BS + 1, (t_rows,), generator=gen,
                             device=dev, dtype=torch.int32)
    if n_pads:
        kv_valid[-n_pads:] = 0
    return q, kp, vp, tables, kv_valid


def time_ms(fn, iters=20, warmup=5, sets=None) -> float:
    """Median device time of one call, by CUDA events around each call.
    A spin kernel (about 50 ms) goes first so that the host queues every
    timed call before the device reaches them: the events then bracket
    device time only, not the host's launch overhead between calls.

    With ``sets``, call i is ``fn(i % sets)``: it works on the (i % sets)-th
    of ``sets`` copies of its operands, and its result stays alive for the
    next ``sets`` calls, so no two calls in a row share an input or an
    output buffer.  The warm-up goes once through every copy; ``rotations``
    sizes ``sets`` so that each operand has left the L2 cache before its
    next use: the call then reads and writes device memory, as the bound
    assumes."""
    call = (lambda i: fn()) if sets is None else (lambda i: fn(i % sets))
    keep = collections.deque(maxlen=sets or 1)
    warmup = max(warmup, sets or 0)     # every copy once, in call order
    for i in range(warmup):
        keep.append(call(i))
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for i, (s, e) in enumerate(zip(starts, ends)):
        s.record()
        keep.append(call(warmup + i))
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


# the H100's L2 cache (50 MB on the SXM and PCIe cards)
L2_BYTES = 50 * 10 ** 6


def rotations(nbytes: int) -> int:
    """Copies of a call's operands (``nbytes`` read and written a call) to
    rotate over so that three L2 sizes of other traffic pass between two
    uses of one copy."""
    return 1 + -(-3 * L2_BYTES // nbytes)


def phase1_card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import payload_partition as pp
    t0 = time.perf_counter()
    built = _nvcc.build_all([fd.SOURCE, ca.SOURCE, codec.SOURCE, pp.SOURCE])
    build_s = time.perf_counter() - t0
    for src, (lib, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
        print(f"phase 1: built {lib.relative_to(ROOT)} from "
              f"{src.relative_to(ROOT)}")
    print(f"phase 1: card {torch.cuda.get_device_name(0)}; "
          f"{len(built)} kernels built in parallel in {build_s:.1f} s")
    return smi[0]


def phase2_kernel_vs_plain(gen):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for t_rows in (1, 8, 32):
            for maxb in (6, 256):
                n_pads = 0 if t_rows == 1 else 2
                windows = [None] + ([8 if maxb == 6 else 1000]
                                    if t_rows > 1 else [])
                case = make_case(gen, t_rows, maxb, dtype, n_pads)
                for window in windows:
                    got = fd.paged_flash_decode_pool(*case, window=window)
                    want = ref.paged_flash_decode_ref(*case, window=window)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    check(err <= ATOL[dtype],
                          f"K6 {dtype} T={t_rows} maxb={maxb} "
                          f"window={window}: max err {err} > {ATOL[dtype]}")
                    if n_pads:
                        check(bool(torch.all(got[-n_pads:] == 0)),
                              "K6 padding rows are not exact zeros")
                    check(bool(torch.all(torch.isfinite(got))),
                          "K6 output not finite")
                    errs[dtype] = max(errs[dtype], err)
    print(f"phase 2: K6 vs plain version at Hq {HQ} Hkv {HKV} hd {HD} "
          f"block {BS}, T {{1,8,32}} x maxb {{6,256}}, with padding rows and "
          f"windows: max abs err f32 {errs[torch.float32]:.3g} (atol 3e-5), "
          f"bf16 {errs[torch.bfloat16]:.3g} (atol 2e-2); padding rows exact "
          f"zeros")
    return errs


def phase3_reduced_parity():
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import init_params, single_device_ctx
    from repro_torch.serving.engine import (PagedServeConfig,
                                            PagedServeEngine, ServeConfig,
                                            ServeEngine)
    cfg = get_config("glm4-9b").reduced()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=s).tolist()
               for s in (5, 3, 9, 2, 7, 12)]

    def serve(engine):
        for p in prompts:
            engine.submit(p, max_new=6)
        engine.run_until_drained()
        fin = engine.finished()
        engine.close()
        return fin

    streams = {}
    for impl in ("kernel", "reference"):
        before = fd.launch_count
        eng = PagedServeEngine(params, cfg, single_device_ctx(),
                               PagedServeConfig(max_requests=4, cache_len=96,
                                                kv_block=16,
                                                max_tokens_in_flight=16,
                                                min_bucket=4, attn_impl=impl))
        streams[impl] = serve(eng)
        launches = fd.launch_count - before
        want = cfg.n_layers * eng.serving_report()["steps"] \
            if impl == "kernel" else 0
        check(launches == want, f"reduced {impl}: {launches} K6 launches, "
              f"expected {want}")
    streams["wave"] = serve(ServeEngine(params, cfg, single_device_ctx(),
                                        ServeConfig(slots=4, cache_len=96)))
    check(streams["kernel"] == streams["reference"] == streams["wave"],
          f"reduced greedy streams differ: {streams}")
    check(all(len(v) == 6 for v in streams["wave"].values()),
          "reduced streams have the wrong length")
    print(f"phase 3: reduced glm4-9b f32 (TF32 off): paged kernel == paged "
          f"reference == wave on {len(prompts)} greedy streams")


def phase4_full_width(out_dir: pathlib.Path):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve
    cfg = get_config("glm4-9b")
    record = out_dir / "serve_full_width.json"
    fd.launch_count = 0
    rc = serve.main(["--arch", "glm4-9b", "--paged", "on", "--attn-impl",
                     "kernel", "--requests", "8", "--mixed", "--device",
                     "cuda", "--out", str(record)])
    launches = fd.launch_count
    check(rc == 0, f"serve launcher returned {rc}")
    rec = json.loads(record.read_text())
    steps = rec["serving"]["steps"]
    check(rec["requests"] == 8, f"served {rec['requests']} of 8 requests")
    check(launches == cfg.n_layers * steps,
          f"K6 launched {launches} times, expected {cfg.n_layers} x {steps}")
    tok_s = rec["tokens"] / rec["wall_s"]
    print(f"phase 4: full-width glm4-9b bf16: {rec['requests']} requests, "
          f"{rec['tokens']} tokens, {steps} packed steps, K6 launches "
          f"{launches} = {cfg.n_layers} x {steps}; {tok_s:.1f} tok/s over "
          f"{rec['wall_s']} s; median step "
          f"{rec['serving']['step_ms']['median']:.2f} ms")
    torch.cuda.empty_cache()
    from repro_torch.models import init_params
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, "cuda")
    logits_check(cfg, params, gen)
    profile_serve(cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches, rec


def logits_check(cfg, params, gen):
    """One full-width packed step (2 requests, 32 rows) with the kernel and
    with the dense-gather reference path on the same pool contents:
    finite logits of the expected shape that agree."""
    from repro_torch.models import single_device_ctx
    from repro_torch.models.transformer import (PagedConfig, init_paged_pool,
                                                paged_decode_step)
    ctx = single_device_ctx()
    dev = "cuda"
    rows = torch.tensor([0] * 20 + [1] * 10 + [-1] * 2, device=dev)
    positions = torch.tensor(list(range(20)) + list(range(10)) + [0, 0],
                             device=dev)
    tokens = torch.randint(1, cfg.vocab, (32,), generator=gen, device=dev)
    tables = torch.arange(12, device=dev, dtype=torch.int32).reshape(2, 6)
    sample = torch.tensor([19, 29], device=dev)
    out = {}
    for impl in ("kernel", "reference"):
        pcfg = PagedConfig(block_size=BS, n_blocks=12, max_blocks_per_req=6,
                           attn_impl=impl)
        pool = init_paged_pool(cfg, ctx, pcfg, device=dev)
        out[impl], _ = paged_decode_step(params, pool, tokens, positions,
                                         rows, tables, sample, cfg, ctx,
                                         pcfg)
    k, r = out["kernel"].float(), out["reference"].float()
    check(k.shape == (2, cfg.vocab_padded), f"logits shape {k.shape}")
    check(bool(torch.isfinite(k).all()), "full-width logits not finite")
    rel = ((k - r).norm() / r.norm()).item()
    check(rel < 0.1, f"full-width logits kernel vs reference rel err {rel}")
    print(f"phase 4: full-width logits [2, {cfg.vocab_padded}] finite; "
          f"kernel vs reference path relative L2 error {rel:.3g} (< 0.1)")


def profile_serve(cfg, params):
    """The phase-4 workload once more (same engine settings, kernel path)
    under torch.profiler: the device's busy share of the drain and what
    takes the time, on the device and on the host.  The profiler's own
    cost lengthens the host side, so the wall time here is not the
    serving metric (phase 4's unprofiled run is)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import build_workload
    from repro_torch.models import single_device_ctx
    from repro_torch.serving.engine import PagedServeConfig, PagedServeEngine
    eng = PagedServeEngine(params, cfg, single_device_ctx(), PagedServeConfig(
        max_requests=8, cache_len=96, kv_block=16, max_tokens_in_flight=32,
        attn_impl="kernel"))
    for prompt, mnew in build_workload(np.random.default_rng(0), 8,
                                       cfg.vocab, 12, True):
        eng.submit(prompt, max_new=mnew)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.serving_report()["steps"]
    eng.close()
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        print("phase 4: profiled drain: device time not measured (the "
              "profiler recorded no device events)")
        return
    print(f"phase 4: profiled drain of {steps} packed steps: device busy "
          f"{busy_ms:.1f} ms of {wall_ms:.1f} ms wall ({busy_ms / wall_ms:.1%}"
          f"); per step {busy_ms / steps:.2f} ms busy of "
          f"{wall_ms / steps:.2f} ms")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"  device {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")
    host = [e for e in avgs if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"  host self {e.self_cpu_time_total / 1e3:9.2f} ms  "
              f"x{e.count:<6d} {e.key[:100]}")


def phase5_times(card):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    key, (mem_bps, bf16_flops) = card_peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for maxb in (6, 256):
        case = make_case(gen, 32, maxb, torch.bfloat16)
        q, kp, vp, tables, kv_valid = case
        # the library yardstick: SDPA over the gathered dense K/V with the
        # kv_valid mask (gather and head expansion outside the timing)
        flat = (tables[:, :, None].long() * BS +
                torch.arange(BS, device="cuda")).reshape(32, maxb * BS)
        kd = kp.reshape(-1, HKV, HD)[flat].permute(0, 2, 1, 3)
        vd = vp.reshape(-1, HKV, HD)[flat].permute(0, 2, 1, 3)
        kd = kd.repeat_interleave(HQ // HKV, dim=1).contiguous()
        vd = vd.repeat_interleave(HQ // HKV, dim=1).contiguous()
        mask = (torch.arange(maxb * BS, device="cuda")[None, :]
                < kv_valid[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        ms = time_ms(lambda: fd.paged_flash_decode_pool(*case))
        plain_ms = time_ms(lambda: ref.paged_flash_decode_ref(*case))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask))
        # the bound: K/V of the positions < kv_valid read once, q read and
        # out written once, tables and kv_valid read once
        n_pos = int(kv_valid.sum().item())
        elt = q.element_size()
        nbytes = (2 * n_pos * HKV * HD * elt + 2 * q.numel() * elt
                  + tables.numel() * 4 + kv_valid.numel() * 4)
        flops = 4 * n_pos * HQ * HD
        bound_ms = max(nbytes / mem_bps, flops / bf16_flops) * 1e3
        bound_by = "bytes" if nbytes / mem_bps >= flops / bf16_flops \
            else "operations"
        rows[maxb] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          bytes=nbytes, flops=flops)
        print(f"phase 5: K6 bf16 T=32 maxb={maxb} ({n_pos} cached positions):"
              f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes} B at {mem_bps / 1e12:.2f} TB/s, {flops} flop at "
              f"{bf16_flops / 1e12:.0f} TFLOP/s: {key} datasheet); "
              f"{bound_ms / ms:.1%} of bound")
    return rows


# -- K1 and the collective path (phases 6-8) ----------------------------------

K1_LENGTHS = (1, 1000, (1 << 20) + 7, 1 << 26)
WALL_NOTE = "host-staged gloo on one card, not a link bandwidth"
MiB = 1 << 20


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def phase6_k1_vs_plain():
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        err = 0.0
        for n in K1_LENGTHS:
            a = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
            b = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
            for off in (0, 1):      # 16-byte aligned, then one element off
                x, y = a[off:off + n], b[off:off + n]
                before = ca.launch_count[dtype, dtype]
                got = ops.accumulate(x, y)
                want = ref.chunk_accumulate_ref(x, y)
                torch.cuda.synchronize()
                check(ca.launch_count[dtype, dtype] == before + 1,
                      "K1 did not launch")
                check(torch.equal(_bits(got), _bits(want)),
                      f"K1 {dtype} n={n} offset {off}: not bit-identical "
                      f"to its plain version")
                if dtype == torch.bfloat16:
                    check(torch.equal(_bits(got), _bits(x + y)),
                          f"K1 bf16 n={n}: differs from a + b")
                err = max(err, (got.float() - want.float()).abs().max()
                          .item())
        errs[dtype] = err
    print(f"phase 6: K1 vs plain version, float32 and bfloat16, lengths "
          f"{K1_LENGTHS}, aligned and misaligned: bit for bit (max abs err "
          f"f32 {errs[torch.float32]}, bf16 {errs[torch.bfloat16]}); bf16 "
          f"equal to a + b")
    return errs


def _pattern(numel: int, rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s payload: small integers (0..40, so sums over 4
    ranks stay exact in bfloat16) with period 31 x 37, which no
    power-of-two segment offset matches; built in pieces."""
    out = torch.empty(numel, dtype=torch.bfloat16, device=device)
    step = 1 << 26
    for lo in range(0, numel, step):
        i = torch.arange(lo, min(lo + step, numel), dtype=torch.int32,
                         device=device)
        out[lo:lo + i.numel()] = ((i % 31) + (i // 31) % 37 + 3 * rank) % 41
    return out


def _digest(x: torch.Tensor) -> str:
    return hashlib.blake2b(x.contiguous().view(torch.uint8).cpu().numpy(),
                           digest_size=16).hexdigest()


# shapes of phase 7 (elements of bfloat16 per rank)
A_SHAPE = (32768, 4096)            # 256 MiB
B_NUMEL = 512 * MiB                # 1 GiB
C_NUMEL = 128 * MiB                # 256 MiB
THREE_ROUTES = {"primary": 50, "staged": 25, "ortho": 25}
HALVES = {"primary": 50, "staged": 50}


def collective_rank():
    """One rank of phase 7; returns digests, wall times, plans, counts."""
    sys.path.insert(0, str(SRC))
    from repro_torch.core import routing
    from repro_torch.core.communicator import (CommConfig, bucket_for,
                                               comm_init_rank)
    from repro_torch.core.topology import Collective
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import Mesh
    mesh_a = Mesh((2, 2), ("data", "model"))
    mesh_b = Mesh((4,), ("data",))
    rank, dev = mesh_a.rank, mesh_a.device
    cfg = CommConfig(profile="h100")
    comm_a = comm_init_rank("data", 2, cfg, ortho_name="model", mesh=mesh_a)
    comm_b = comm_init_rank("data", 4, cfg, mesh=mesh_b)
    ca.launch_count.clear()
    out = {"wire": mesh_a.wire, "digest": {}, "wall_s": {}, "plans": {},
           "want_k1": 0}

    def run(name, fn, plan, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        out["wall_s"][name] = time.perf_counter() - t0
        out["plans"][name] = (plan.chunk_units, plan.staged_substeps)
        if (plan.collective in (Collective.ALL_REDUCE,
                                Collective.REDUCE_SCATTER)
                and "staged" in plan.paths):
            out["want_k1"] += (n - 1) * plan.staged_substeps
        return y

    def tuned(comm, op, x):
        return comm._bucket_plan(op, bucket_for(x.numel() *
                                                x.element_size()))

    x = _pattern(A_SHAPE[0] * A_SHAPE[1], rank, dev).reshape(A_SHAPE)
    for name, op, call in (
            ("a_all_reduce", Collective.ALL_REDUCE, comm_a.all_reduce),
            ("a_all_gather", Collective.ALL_GATHER, comm_a.all_gather),
            ("a_reduce_scatter", Collective.REDUCE_SCATTER,
             comm_a.reduce_scatter)):
        y = run(name, lambda: call(x), tuned(comm_a, op, x), 2)
        out["digest"][name] = _digest(y)
        del y
    plan = routing.build_plan(Collective.ALL_REDUCE, "data", THREE_ROUTES,
                              "model")
    y = run("a_all_reduce_three_routes", lambda: routing.execute(
        plan, x, mesh_a), plan, 2)
    out["digest"]["a_all_reduce_three_routes"] = _digest(y)
    del x, y
    x = _pattern(B_NUMEL, rank, dev)
    y = run("b_all_reduce", lambda: comm_b.all_reduce(x),
            tuned(comm_b, Collective.ALL_REDUCE, x), 4)
    out["digest"]["b_all_reduce"] = _digest(y)
    del x, y
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    x = torch.randn(C_NUMEL, generator=gen, device=dev).to(torch.bfloat16)
    plan = routing.build_plan(Collective.ALL_REDUCE, "data", HALVES)
    k1 = run("c_all_reduce", lambda: routing.execute(plan, x, mesh_b),
             plan, 4)
    launches = sum(ca.launch_count.values())
    plain = routing.execute(plan, x, mesh_b,
                            accumulate=ref.chunk_accumulate_ref)
    torch.cuda.synchronize()
    check(sum(ca.launch_count.values()) == launches,
          "the plain run launched K1")
    out["c_bit_identical"] = bool(torch.equal(_bits(k1), _bits(plain)))
    out["k1_launches"] = launches
    out["signature"] = [repr(comm_a.plan_signature()),
                        repr(comm_b.plan_signature())]
    return out


def phase7_collectives():
    from repro_torch.launch.mesh import run_ranks
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = run_ranks(collective_rank, 4, backend="gloo", device="cuda",
                    timeout_s=900)
    wall = time.perf_counter() - t0
    print(f"phase 7: 4 ranks on {torch.cuda.get_device_name(0)}, wire "
          f"{res[0]['wire']}, profile h100; ranks ran {wall:.1f} s")
    check(all(r["wire"] == "host" for r in res), "wire is not host")
    # what every rank must hold, from the same inputs, in the parent
    line_a = {r: [m, 2 + m] for r, m in ((r, r % 2) for r in range(4))}
    want = {r: {} for r in range(4)}
    for r in range(4):
        ins = [_pattern(A_SHAPE[0] * A_SHAPE[1], q, dev).reshape(A_SHAPE)
               for q in line_a[r]]
        total = (ins[0].float() + ins[1].float()).to(torch.bfloat16)
        want[r]["a_all_reduce"] = want[r]["a_all_reduce_three_routes"] = \
            _digest(total)
        want[r]["a_all_gather"] = _digest(torch.cat(ins))
        half = A_SHAPE[0] // 2
        d = r // 2
        want[r]["a_reduce_scatter"] = _digest(total[d * half:(d + 1) * half])
        del ins, total
    total = torch.zeros(B_NUMEL, dtype=torch.float32, device=dev)
    for q in range(4):
        total += _pattern(B_NUMEL, q, dev).float()
    b_digest = _digest(total.to(torch.bfloat16))
    del total
    torch.cuda.empty_cache()
    for r, got in enumerate(res):
        want[r]["b_all_reduce"] = b_digest
        for name, d in want[r].items():
            check(got["digest"][name] == d,
                  f"rank {r} {name}: result differs from the exact one")
        check(got["c_bit_identical"], f"rank {r}: (c) with K1 differs from "
              f"(c) with K1's plain version")
        check(got["k1_launches"] == got["want_k1"],
              f"rank {r}: K1 launched {got['k1_launches']} times, the "
              f"plans say {got['want_k1']}")
        check(got["signature"] == res[0]["signature"],
              f"rank {r}: plan_signature differs from rank 0's")
        check(got["plans"] == res[0]["plans"], f"rank {r}: other plans")
    for name, t in res[0]["wall_s"].items():
        units, sub = res[0]["plans"][name]
        print(f"phase 7: {name}: plan {units} substeps {sub}; exact on every "
              f"rank; wall {max(r['wall_s'][name] for r in res):.3f} s "
              f"({WALL_NOTE})")
    launches = sum(r["k1_launches"] for r in res)
    print(f"phase 7: (c) K1 run bit-identical to the plain-accumulate run "
          f"on all ranks; plan_signature equal on all ranks; K1 launches "
          f"{launches} over 4 ranks = sum of (n-1) x staged_substeps over "
          f"the staged reduces")
    return launches, res[0]["plans"]


def phase8_k1_times(card, plans):
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import ref
    key, (mem_bps, _) = card_peaks(card)
    units, substeps = plans["b_all_reduce"]
    staged = dict(units).get("staged", 0)
    check(staged > 0, f"the 1 GiB plan {units} has no staged share")
    # the staged segment of (b), its per-rank ring chunk, one sub-chunk
    sub = B_NUMEL * staged // 16 // 4 // substeps
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    for name, n in (("b_substep", sub), ("chunk_64MiB", 32 * MiB)):
        nbytes = 3 * n * 2
        k = rotations(nbytes)
        a = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(k)]
        b = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(k)]
        before = collections.Counter(ca.launch_count)
        ms = time_ms(lambda i: ca.chunk_accumulate(a[i], b[i]), sets=k)
        # timing launches are not the path's
        ca.launch_count.clear()
        ca.launch_count.update(before)
        plain_ms = time_ms(lambda i: ref.chunk_accumulate_ref(a[i], b[i]),
                           sets=k)
        lib_ms = time_ms(lambda i: a[i] + b[i], sets=k)
        del a, b
        flops = n
        bound_ms = max(nbytes / mem_bps, flops / 67e12) * 1e3
        bound_by = "bytes" if nbytes / mem_bps >= flops / 67e12 \
            else "operations"
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by, n=n)
        print(f"phase 8: K1 bf16 n={n} ({name}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, a + b {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
              f"{mem_bps / 1e12:.2f} TB/s: {key} datasheet); "
              f"{bound_ms / ms:.1%} of bound; operands rotated over {k} "
              f"copies, out of L2")
    return rows


# -- the wire codecs and the data-parallel train step (phases 9-12) -----------

CODEC_LENGTHS = (1, 127, 1000, (1 << 20) + 7, 1 << 26)
FMTS = ("fp8_e4m3", "fp8_e5m2")


def _codec_input(n, dtype, gen, special):
    """Random values whose 128-element groups span 10 decades; with
    ``special``, a NaN in group 0, an inf in group 2 and a -inf last."""
    x = torch.randn(n, generator=gen, device="cuda")
    groups = -(-n // 128)
    mag = torch.exp(torch.empty(groups, device="cuda").uniform_(
        -12, 12, generator=gen))
    x *= mag.repeat_interleave(128)[:n]
    if special:
        x[min(5, n - 1)] = float("nan")
        if n > 2 * 128:
            x[2 * 128 + 7] = float("inf")
            x[n - 1] = float("-inf")
    return x.to(dtype)


def _same_bits(got, want, what, key, stats):
    """Bit for bit where the values are numbers, NaN at the same places.
    Adds to ``stats``: the NaNs whose bits differ, and per ``key`` the max
    abs difference over the elements finite in both."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    finite = torch.isfinite(g) & torch.isfinite(w)
    err = float((g[finite] - w[finite]).abs().max()) if finite.any() else 0.0
    stats[key] = max(stats.get(key, 0.0), err)
    if got.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
              f"{what}: fp8 bytes differ from the plain version's")
        return
    gn, wn = torch.isnan(g), torch.isnan(w)
    check(torch.equal(gn, wn), f"{what}: NaN at other places than the "
          f"plain version's")
    check(torch.equal(_bits(got)[~gn], _bits(want)[~wn]),
          f"{what}: not bit-identical to the plain version")
    nan_bits = stats.setdefault("nan_bits", {})
    nan_bits[key] = nan_bits.get(key, 0) + int(
        (_bits(got)[gn] != _bits(want)[wn]).sum())


def phase9_codecs_vs_plain():
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases, stats = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in CODEC_LENGTHS:
            x = _codec_input(n + 1, dtype, gen, special=True)
            b = _codec_input(n + 1, dtype, gen, special=False)
            for off in (0, 1):
                xs, bs = x[off:off + n], b[off:off + n]
                for fmt in FMTS:
                    before = dict(codec.launch_count)
                    vals, scales = codec.fp8_encode(xs, fmt)
                    dec = codec.fp8_decode(vals, scales, fmt, dtype)
                    acc = codec.fp8_decode_accumulate(vals, scales, bs, fmt)
                    torch.cuda.synchronize()
                    check(all(codec.launch_count[k] == before[k] + 1
                              for k in ("fp8_encode", "fp8_decode",
                                        "fp8_decode_accumulate")),
                          "a codec kernel did not launch")
                    r_vals, r_scales = ref.fp8_encode_ref(xs, fmt=fmt)
                    tag = f"{fmt} {dtype} n={n} offset {off}"
                    _same_bits(vals, r_vals, f"K2 values {tag}",
                               "fp8_encode", stats)
                    _same_bits(scales, r_scales, f"K2 scales {tag}",
                               "fp8_encode", stats)
                    _same_bits(dec, ref.fp8_decode_ref(
                        vals, scales, out_dtype=dtype), f"K4 {tag}",
                        "fp8_decode", stats)
                    _same_bits(acc, ref.fp8_decode_accumulate_ref(
                        vals, scales, bs), f"K3 {tag}",
                        "fp8_decode_accumulate", stats)
                    cases += 1
                _same_bits(codec.bf16_pack(xs), ref.bf16_pack_ref(xs),
                           f"K5 {dtype} n={n} offset {off}", "bf16_pack",
                           stats)
                if dtype == torch.float32:
                    packed = ref.bf16_pack_ref(bs)
                    before = ca.launch_count[ca.MIXED]
                    got = ops.accumulate(xs, packed)
                    torch.cuda.synchronize()
                    check(ca.launch_count[ca.MIXED] == before + 1,
                          "the mixed K1 did not launch")
                    _same_bits(got, ref.chunk_accumulate_ref(xs, packed),
                               f"mixed K1 n={n} offset {off}", "k1_mixed",
                               stats)
            del x, b
    torch.cuda.empty_cache()
    print(f"phase 9: K2/K3/K4 vs plain versions in {cases} cases (lengths "
          f"{CODEC_LENGTHS}, aligned and one off, float32 and bfloat16, "
          f"e4m3 and e5m2, NaN and inf groups), K5 and the mixed K1 "
          f"likewise: bit for bit, NaN at the same places (NaNs with "
          f"other bits: {stats.get('nan_bits', {})}); max abs err "
          f"{ {k: v for k, v in stats.items() if k != 'nan_bits'} }")
    return stats


def codec_launches(plan, n: int, dtype) -> collections.Counter:
    """The K1-K5 launches one ``routing.execute`` of ``plan`` makes on one
    rank, for a payload of ``dtype`` on an axis of ``n`` ranks (the ortho
    axis of these runs has 2).  Per staged ring with s sub-chunks: the
    all-reduce encodes n x s times (the reduce-scatter's (n-1) x s
    partials and the all-gather's s sources), fuses (n-1) x s
    decode-accumulates and decodes n x s gathered rows; an ortho detour
    encodes and decodes twice.  bf16_pack decodes by a cast, and its
    decode-accumulate is K1 (mixed for a float32 payload)."""
    c = collections.Counter()
    s, op = plan.staged_substeps, plan.collective.value
    for path in plan.paths:
        if path == "primary":
            continue
        if path == "staged":
            enc, dec, acc = {"all_reduce": (n * s, n * s, (n - 1) * s),
                             "reduce_scatter": ((n - 1) * s, 0, (n - 1) * s),
                             "all_gather": (s, n * s, 0),
                             "all_to_all": (n - 1, n - 1, 0)}[op]
        else:
            enc, dec, acc = 2, 2, 0
        codec = plan.codec_for(path)
        if codec == "bf16_pack":
            c["bf16_pack"] += enc
            c["k1_mixed" if dtype == torch.float32 else "k1"] += acc
        elif codec:
            c["fp8_encode"] += enc
            c["fp8_decode"] += dec
            c["fp8_decode_accumulate"] += acc
        elif dtype.is_floating_point and torch.finfo(dtype).bits < 32:
            c["k1"] += acc
    return c


def _kernel_counts(reset=False):
    """This process's K1-K5 and K7 launch counts (set to 0 first with
    reset)."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec
    from repro_torch.kernels import payload_partition as pp
    if reset:
        for counts in (codec.launch_count, pp.launch_count):
            for k in counts:
                counts[k] = 0
        ca.launch_count.clear()
    mixed = ca.launch_count[ca.MIXED]
    return collections.Counter({**codec.launch_count, "k1_mixed": mixed,
                                "k1": sum(ca.launch_count.values()) - mixed,
                                "k7a": pp.launch_count["extract"],
                                "k7b": pp.launch_count["merge"]})


@contextlib.contextmanager
def recorded_calls(seen: set):
    """Within the block, every call of a K1-K5 wrapper adds what its
    kernel was given to ``seen``: (kernel, length, dtype, fp8 format),
    the dtype being the payload's (the input of K2 and K5, the output of
    K3 and K4, the float32 operand of the mixed K1).  The wrappers and
    their counts are untouched; this only looks at their arguments."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec
    keys = {
        "fp8_encode": lambda x, fmt="fp8_e4m3": (x.numel(), x.dtype, fmt),
        "fp8_decode": lambda v, s, fmt, dt=torch.float32: (v.numel(), dt,
                                                           fmt),
        "fp8_decode_accumulate": lambda v, s, b, fmt: (v.numel(), b.dtype,
                                                       fmt),
        "bf16_pack": lambda x: (x.numel(), x.dtype, None)}
    originals = {name: getattr(codec, name) for name in keys}
    k1 = ca.chunk_accumulate

    def wrap(name, fn):
        def call(*args):
            seen.add((name, *keys[name](*args)))
            return fn(*args)
        return call

    def k1_call(a, b):
        seen.add(("k1_mixed" if a.dtype != b.dtype else "k1", a.numel(),
                  a.dtype, None))
        return k1(a, b)

    for name, fn in originals.items():
        setattr(codec, name, wrap(name, fn))
    ca.chunk_accumulate = k1_call
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(codec, name, fn)
        ca.chunk_accumulate = k1


def _rank_payload(numel, dtype, seed, rank):
    """Rank ``rank``'s random payload: blocks of 4096 elements span 3.5
    decades, so the codecs' per-group scales differ."""
    gen = torch.Generator(device="cuda").manual_seed(seed * 100 + rank)
    x = torch.randn(numel, generator=gen, device="cuda")
    groups = -(-numel // 4096)
    x *= torch.exp(torch.empty(groups, device="cuda").uniform_(
        -4, 4, generator=gen)).repeat_interleave(4096)[:numel]
    return x.to(dtype)


def _block_max(x, block=128):
    """|x| max over each 128-block and its two neighbours, per element: a
    bound on the abs-max of any codec group (128 consecutive elements,
    wherever it starts) that holds the element."""
    n = x.numel()
    pad = (-n) % block
    a = torch.cat([x.abs().float().reshape(-1),
                   torch.zeros(pad, device=x.device)])
    m = a.view(-1, block).amax(dim=1)
    m = torch.maximum(m, torch.cat([m[1:], m[-1:]]))
    m = torch.maximum(m, torch.cat([m[:1], m[:-1]]))
    return m.repeat_interleave(block)[:n]


def codec_rank():
    """One rank of phase 10; returns plans, digests, launch counts and
    errors, per run."""
    sys.path.insert(0, str(SRC))
    from repro_torch.core import routing
    from repro_torch.core.communicator import (CommConfig, bucket_for,
                                               comm_init_rank)
    from repro_torch.core.topology import Collective
    from repro_torch.launch.mesh import Mesh
    mesh_a = Mesh((2, 2), ("data", "model"))
    mesh_b = Mesh((4,), ("data",))
    cpu_a = Mesh((2, 2), ("data", "model"), device="cpu")
    cpu_b = Mesh((4,), ("data",), device="cpu")
    rank = mesh_a.rank
    comm_a = comm_init_rank("data", 2, CommConfig(
        profile="h100", compress="secondary=fp8"), ortho_name="model",
        mesh=mesh_a)
    comm_b = comm_init_rank("data", 4, CommConfig(
        profile="h100", compress="staged=bf16"), mesh=mesh_b)
    out = {}

    def run(name, plan, mesh, cpu_mesh, x, seed):
        n = mesh.axis_size("data")
        line = [mesh.peer("data", i) for i in range(n)]
        seen = set()
        _kernel_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_calls(seen):
            y = routing.execute(plan, x, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        plain = routing.execute(plan, x.cpu(), cpu_mesh)
        check(_kernel_counts() == launches, "the CPU run launched kernels")
        rec = {"plan": (plan.chunk_units, plan.path_codecs,
                        plan.staged_substeps),
               "wall_s": wall, "digest": _digest(y),
               "equal_plain": bool(torch.equal(_bits(y.cpu()),
                                               _bits(plain))),
               "launches": dict(launches), "calls": seen,
               "want": dict(codec_launches(plan, n, x.dtype))}
        # the exact result, from every input of this rank's line
        ins = [_rank_payload(x.numel(), x.dtype, seed, r).reshape(x.shape)
               for r in line]
        op = plan.collective.value
        if op == "all_gather":
            exact = torch.stack([t.float() for t in ins])
            mag = torch.maximum(_block_max(exact), _block_max(y))
            hops = 1
        else:
            exact = sum(t.float() for t in ins)
            if op == "reduce_scatter":
                d, lead = mesh.axis_index("data"), x.shape[0] // n
                exact = exact[d * lead:(d + 1) * lead]
                ins = [t[d * lead:(d + 1) * lead] for t in ins]
            mag = _block_max(exact)
            for t in ins:
                mag = torch.maximum(mag, _block_max(t))
            hops = n + 1      # ring partials + gathered row, or 3 ortho
        # one step of the wire format at a group's abs-max: 32/448 for
        # e4m3, 2^-7 relative for the bf16 pack; plus the payload's own
        # rounding of the sum
        step = 2.0 ** -7 if "bf16_pack" in str(plan.path_codecs) else 1 / 14
        err = (y.float() - exact).abs().reshape(-1)
        tol = hops * step * mag + exact.abs().reshape(-1) * 2.0 ** -7
        rec["err_over_tol"] = float((err / tol.clamp_min(1e-30)).max())
        rec["max_abs_err"] = float(err.max())
        out[name] = rec

    x = _rank_payload(32 * MiB, torch.bfloat16, 1, rank)
    plan = routing.build_plan(Collective.ALL_REDUCE, "data", THREE_ROUTES,
                              "model", path_codecs={"staged": "fp8_e4m3",
                                                    "ortho": "fp8_e4m3"})
    run("a_three_route_all_reduce_fp8", plan, mesh_a, cpu_a, x, 1)
    x = _rank_payload(A_SHAPE[0] * A_SHAPE[1], torch.bfloat16, 2,
                      rank).reshape(A_SHAPE)
    for name, op in (("b_all_gather_fp8", Collective.ALL_GATHER),
                     ("b_reduce_scatter_fp8", Collective.REDUCE_SCATTER)):
        plan = comm_a._bucket_plan(op, bucket_for(x.numel() * 2))
        check(plan.path_codecs, f"{name}: the tuned plan carries no codec")
        run(name, plan, mesh_a, cpu_a, x, 2)
    x = _rank_payload(64 * MiB, torch.float32, 3, rank)
    plan = comm_b._bucket_plan(Collective.ALL_REDUCE, bucket_for(256 * MiB))
    check(plan.path_codecs == (("staged", "bf16_pack"),),
          f"(c): the tuned plan {plan} carries no bf16_pack")
    run("c_all_reduce_f32_bf16_pack", plan, mesh_b, cpu_b, x, 3)
    return out


def phase10_codec_collectives():
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(codec_rank, 4, backend="gloo", device="cuda",
                    timeout_s=900)
    print(f"phase 10: 4 ranks on {torch.cuda.get_device_name(0)}, "
          f"compressed collectives, profile h100; ranks ran "
          f"{time.perf_counter() - t0:.1f} s")
    launches, calls = collections.Counter(), set()
    for name, rec in res[0].items():
        for r, got in enumerate(res):
            g = got[name]
            if name.startswith("c_"):
                calls |= g["calls"]
            check(g["plan"] == rec["plan"], f"rank {r} {name}: other plan")
            check(g["equal_plain"], f"rank {r} {name}: the kernel run "
                  f"differs from the plain-version run")
            check(collections.Counter(g["launches"]) ==
                  collections.Counter(g["want"]),
                  f"rank {r} {name}: launches {g['launches']}, the plan "
                  f"implies {g['want']}")
            check(g["err_over_tol"] <= 1.0, f"rank {r} {name}: error "
                  f"{g['max_abs_err']} beyond the codec's step bound "
                  f"({g['err_over_tol']:.3f} of it)")
            if name.startswith("c_"):
                launches += collections.Counter(g["launches"])
        if name.startswith("b_all_gather"):
            # the ranks of one data line (same model index) hold one result
            for r in range(4):
                check(res[r][name]["digest"] == res[r % 2][name]["digest"],
                      f"rank {r}: gathered rows differ within its line")
        print(f"phase 10: {name}: plan {rec['plan']}; kernel run == plain "
              f"run on every rank; max abs err vs exact "
              f"{max(g[name]['max_abs_err'] for g in res):.4g} "
              f"({max(g[name]['err_over_tol'] for g in res):.3f} of the "
              f"step bound); launches a rank {rec['launches']} = the "
              f"plan's; wall {max(g[name]['wall_s'] for g in res):.3f} s "
              f"({WALL_NOTE})")
    return launches, calls


# phase 11: full-width glm4-9b with its depth cut to TRAIN_LAYERS.  The
# learning rate is one a 4096-wide model takes in its first steps: the
# launcher's 1e-3 (sized for the reduced config) sends this model's loss
# up, from 12.7 to 18.1 in one step, on this card
TRAIN_LAYERS = 2
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
TRAIN_RUNS = (("nccl", {"backend": "nccl"}),
              ("flexlink", {}),
              ("fp8", {"compress": "secondary=fp8"}))
LM_HEAD_NUMEL = 4096 * 151552


def train_rank():
    """One rank of phase 11: three 3-step runs of full-width glm4-9b
    (depth cut) through build_train_program + run_loop.  Every collective
    call's plan is recorded, and the kernel counts are set to 0 just
    before each run and read just after it."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.core.communicator import CommConfig
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_train_program
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=TRAIN_LAYERS)
    mesh = Mesh((2, 1), ("data", "model"))
    calls = []
    execute = routing.execute

    def recorded(plan, x, m, **kw):
        calls.append((plan, m.axis_size(plan.axis_name), x.dtype,
                      x.numel()))
        return execute(plan, x, m, **kw)

    routing.execute = recorded
    out = {}
    try:
        for name, comm in TRAIN_RUNS:
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = init_params(cfg, gen, "cuda")
            opt_state = init_state(params)
            program, ctx = build_train_program(
                cfg, mesh, comm=CommConfig(profile="h100", **comm),
                opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                total_steps=TRAIN_STEPS), name=name)
            batches = make_batches(cfg, seq_len=128, batch_per_shard=8)
            calls.clear()
            seen = set()
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with recorded_calls(seen):
                params, opt_state, hist = run_loop(
                    program, params, opt_state, batches, ctx,
                    LoopConfig(total_steps=TRAIN_STEPS, log_every=0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            program.close()
            want = collections.Counter()
            for plan, n, dtype, _ in calls:
                want += codec_launches(plan, n, dtype)
            plans = sorted({(p.collective.value, numel, p.chunk_units,
                             p.path_codecs, p.staged_substeps)
                            for p, _, _, numel in calls if p.path_codecs})
            out[name] = {"losses": hist, "wall_s": wall,
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30,
                         "launches": dict(launches), "want": dict(want),
                         "calls": len(calls), "codec_plans": plans,
                         "kernel_calls": seen}
            del params, opt_state, program, ctx
            torch.cuda.empty_cache()
    finally:
        routing.execute = execute
    return out


def phase11_training():
    from repro_torch.launch.mesh import run_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(train_rank, 2, backend="gloo", device="cuda",
                    timeout_s=900)
    print(f"phase 11: full-width glm4-9b (d_model 4096, d_ff 13696, vocab "
          f"151552, 32/2 heads; depth cut 40 -> {TRAIN_LAYERS}), bf16, "
          f"seed 0, seq 128, global batch 8, AdamW lr {TRAIN_LR}, 2 gloo "
          f"ranks on one card; "
          f"ranks ran {time.perf_counter() - t0:.1f} s")
    losses = {}
    for name, _ in TRAIN_RUNS:
        hist = [r[name]["losses"] for r in res]
        check(all(np.isfinite(h).all() for h in hist),
              f"{name}: loss not finite: {hist}")
        check(hist[0] == hist[1], f"{name}: the ranks' losses differ: "
              f"{hist}")
        check(hist[0][-1] < hist[0][0], f"{name}: loss did not fall: "
              f"{hist[0]}")
        for r, got in enumerate(res):
            check(collections.Counter(got[name]["launches"]) ==
                  collections.Counter(got[name]["want"]),
                  f"rank {r} {name}: launches {got[name]['launches']}, the "
                  f"step's plans imply {got[name]['want']}")
        losses[name] = hist[0]
        rec = res[0][name]
        print(f"phase 11: {name}: losses {hist[0]}; {rec['calls']} "
              f"collective calls; launches a rank {rec['launches']}; "
              f"{rec['wall_s']:.1f} s for {TRAIN_STEPS} steps; peak "
              f"{max(r[name]['peak_gib'] for r in res):.2f} GiB a rank")
    for i in range(TRAIN_STEPS):
        d = abs(losses["flexlink"][i] - losses["nccl"][i])
        check(d < 5e-3, f"step {i}: flexlink {losses['flexlink'][i]} vs "
              f"nccl {losses['nccl'][i]}")
        lim = 0.05 * max(abs(losses["nccl"][i]), 1.0)
        check(abs(losses["fp8"][i] - losses["nccl"][i]) <= lim,
              f"step {i}: fp8 {losses['fp8'][i]} vs nccl "
              f"{losses['nccl'][i]} beyond {lim}")
    plans = res[0]["fp8"]["codec_plans"]
    check(any(p[1] == LM_HEAD_NUMEL for p in plans),
          f"the lm_head all-reduce carries no codec: {plans}")
    for op, numel, units, codecs, sub in plans:
        print(f"phase 11: fp8 codec plan: {op} of {numel} elements: units "
              f"{units}, codecs {codecs}, substeps {sub}")
    launches = {name: sum((collections.Counter(r[name]["launches"])
                           for r in res), collections.Counter())
                for name, _ in TRAIN_RUNS}
    print(f"phase 11: flexlink within 5e-3 of nccl a step, fp8 within "
          f"0.05 max(|loss|, 1); launches over 2 ranks, each the sum over "
          f"the steps' plans: flexlink {dict(launches['flexlink'])}, fp8 "
          f"{dict(launches['fp8'])}")
    calls = set().union(*(r["fp8"]["kernel_calls"] for r in res))
    return launches, plans, calls


# phase 13: tensor-parallel training of full-width glm4-9b (depth cut to
# TRAIN_LAYERS) on (data=2, model=2): 4 gloo ranks on the card.  The h100
# tuner gives the model axis's 4 MiB activation combines the primary route
# only; a TuningProfile pins that slot to three routes, so the staged ring
# (and K1) and the ortho detour run inside the forward, the recompute and
# the backward of every combine
TP_MESH = (2, 2)
TP_RUNS = (("nccl", {"backend": "nccl"}), ("flexlink", {}))
TP_SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}
TP_SEQ = 128
TP_BATCH = 8                   # global: 4 rows a data rank


def _pin_model_axis(path: str, d_model: int) -> int:
    """Write the TuningProfile that pins the model axis's all-reduce slot
    (one [4, 128, d_model] bf16 combine) to TP_SHARES; returns its
    bucket."""
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.communicator import bucket_for
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    nbytes = TP_BATCH // TP_MESH[0] * TP_SEQ * d_model * 2
    prof = TuningProfile(path)
    prof.record("h100", "ring", Collective.ALL_REDUCE, TP_MESH[1],
                bucket_for(nbytes), SHARE_GRID, TP_SHARES)
    prof.save(path)
    return bucket_for(nbytes)


def _step_phase() -> str:
    """Where an executed collective runs: the forward, the checkpoint
    recompute (inside the backward, grad mode on) or the backward."""
    if torch._C._current_graph_task_id() == -1:
        return "forward"
    return "recompute" if torch.is_grad_enabled() else "backward"


def tp_train_rank(pinned: str):
    """One rank of phase 13: two 3-step runs of full-width glm4-9b (depth
    cut) on the (data=2, model=2) mesh through build_train_program +
    run_loop, from the global init's model-axis shards.  Every executed
    collective's plan and step phase is recorded, and the kernel counts
    are set to 0 just before each run and read just after it."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.core import routing
    from repro_torch.core.communicator import CommConfig
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_train_program
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    from torch.utils import _pytree as pytree
    cfg = dataclasses.replace(get_config("glm4-9b"), n_layers=TRAIN_LAYERS)
    mesh = Mesh(TP_MESH, ("data", "model"))
    specs = param_specs(cfg)
    calls = []
    execute = routing.execute

    def recorded(plan, x, m, **kw):
        calls.append((plan, m.axis_size(plan.axis_name), x.dtype,
                      x.numel(), _step_phase()))
        return execute(plan, x, m, **kw)

    routing.execute = recorded
    out = {}
    try:
        for name, comm in TP_RUNS:
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = shard_params(init_params(cfg, gen, "cuda"), specs,
                                  mesh.axis_index("model"), TP_MESH[1])
            torch.cuda.empty_cache()
            opt_state = init_state(params)
            program, ctx = build_train_program(
                cfg, mesh, comm=CommConfig(profile="h100",
                                           tuning_cache=pinned, **comm),
                opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                total_steps=TRAIN_STEPS), name=name)
            batches = make_batches(cfg, seq_len=TP_SEQ,
                                   batch_per_shard=TP_BATCH)
            calls.clear()
            seen = set()
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with recorded_calls(seen):
                params, opt_state, hist = run_loop(
                    program, params, opt_state, batches, ctx,
                    LoopConfig(total_steps=TRAIN_STEPS, log_every=0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            rec = {c.axis_name: len(c.recorder(name).issued_calls())
                   for c in ctx.comms()}
            program.close()
            want = collections.Counter()
            for plan, n, dtype, _, _ in calls:
                want += codec_launches(plan, n, dtype)
            model = collections.Counter(ph for p, *_, ph in calls
                                        if p.axis_name == "model")
            out[name] = {
                "losses": hist, "wall_s": wall,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": dict(launches), "want": dict(want),
                "recorded": rec, "model_exec": dict(model),
                "model_plans": sorted({(p.chunk_units, p.staged_substeps,
                                        numel) for p, _, _, numel, _ in calls
                                       if p.axis_name == "model"}),
                "leaves": len(pytree.tree_leaves(params)),
                "kernel_calls": seen}
            del params, opt_state, program, ctx
            torch.cuda.empty_cache()
    finally:
        routing.execute = execute
    return out


def phase13_tp_training():
    from repro_torch.launch.mesh import run_ranks
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        bucket = _pin_model_axis(pinned, 4096)
        t0 = time.perf_counter()
        res = run_ranks(tp_train_rank, 4, backend="gloo", device="cuda",
                        timeout_s=900, args=(pinned,))
    print(f"phase 13: full-width glm4-9b (depth cut 40 -> {TRAIN_LAYERS}), "
          f"bf16, seed 0, seq {TP_SEQ}, global batch {TP_BATCH}, AdamW lr "
          f"{TRAIN_LR}, mesh (data=2, model=2), 4 gloo ranks on one card, "
          f"model-axis all-reduce slot ({bucket} B bucket) pinned to "
          f"{TP_SHARES}; ranks ran {time.perf_counter() - t0:.1f} s")
    # a step executes the embedding's and each layer's two combines in
    # the forward and their transposes in the backward; the recompute of
    # each checkpointed layer stops after its last saved activation, so
    # it repeats the attention combine and not the MLP's
    per_step = {"forward": 1 + 2 * TRAIN_LAYERS, "recompute": TRAIN_LAYERS,
                "backward": 1 + 2 * TRAIN_LAYERS}
    losses = {}
    for name, _ in TP_RUNS:
        hist = [r[name]["losses"] for r in res]
        check(all(np.isfinite(h).all() for h in hist),
              f"{name}: loss not finite: {hist}")
        check(all(h == hist[0] for h in hist), f"{name}: the ranks' losses "
              f"differ: {hist}")
        check(hist[0][-1] < hist[0][0], f"{name}: loss did not fall: "
              f"{hist[0]}")
        for r, got in enumerate(res):
            g = got[name]
            check(collections.Counter(g["launches"]) ==
                  collections.Counter(g["want"]),
                  f"rank {r} {name}: launches {g['launches']}, the step's "
                  f"plans imply {g['want']}")
            want_exec = {k: v * TRAIN_STEPS for k, v in per_step.items()}
            check(g["model_exec"] == want_exec, f"rank {r} {name}: "
                  f"model-axis all-reduces {g['model_exec']}, want "
                  f"{want_exec}")
            if name == "flexlink":
                check(g["recorded"] == {"model": 3, "data": g["leaves"]},
                      f"rank {r}: recorded {g['recorded']}, want 3 model-"
                      f"axis calls and {g['leaves']} data-axis calls")
                units = {u for plan in g["model_plans"] for u, _ in plan[0]}
                check(units == {"primary", "staged", "ortho"},
                      f"rank {r}: model-axis plans {g['model_plans']}")
        losses[name] = hist[0]
        rec = res[0][name]
        print(f"phase 13: {name}: losses {hist[0]}; recorded a step "
              f"{rec['recorded']}; model-axis all-reduces executed a step "
              f"{ {k: v // TRAIN_STEPS for k, v in rec['model_exec'].items()} }"
              f"; launches a rank {rec['launches']}; "
              f"{max(r[name]['wall_s'] for r in res):.1f} s for "
              f"{TRAIN_STEPS} steps; peak "
              f"{max(r[name]['peak_gib'] for r in res):.2f} GiB a rank")
    for i in range(TRAIN_STEPS):
        d = abs(losses["flexlink"][i] - losses["nccl"][i])
        check(d < 5e-3, f"step {i}: flexlink {losses['flexlink'][i]} vs "
              f"nccl {losses['nccl'][i]}")
    for plan in res[0]["flexlink"]["model_plans"]:
        print(f"phase 13: flexlink model-axis plan: units {plan[0]}, "
              f"substeps {plan[1]}, {plan[2]} elements")
    total = sum((collections.Counter(r[name]["launches"]) for r in res
                 for name, _ in TP_RUNS), collections.Counter())
    k1 = sum(collections.Counter(r["flexlink"]["launches"])["k1"]
             for r in res)
    print(f"phase 13: flexlink within 5e-3 of nccl a step; K1 launches over "
          f"4 ranks {k1} = the sum over the executed plans; the model "
          f"axis records 3 calls a step (the reference's per-trace count) "
          f"and executes {per_step} a step")
    calls = set().union(*(r["flexlink"]["kernel_calls"] for r in res))
    return k1, {k: total[k] for k in ("k7a", "k7b")}, calls


# float32 operations each kernel does per element (abs, max, divide and
# convert for K2; convert and a multiply or fused multiply-add for K3 and
# K4; a convert for K5; a convert and an add for the mixed K1)
CODEC_OPS = {"fp8_encode": 4, "fp8_decode_accumulate": 2, "fp8_decode": 2,
             "bf16_pack": 1, "k1_mixed": 2}
F32_FLOPS = 67e12


def phase12_main_path_check(calls):
    """Each K2-K5 and mixed K1 wrapper against its plain version at every
    (length, dtype, format) its kernel was given on the main path: phase
    11's fp8 training run and phase 10 (c).  Aligned and one element off,
    NaN and inf groups included: bit for bit, NaN at the same places."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, ref
    gen = torch.Generator(device="cuda").manual_seed(121)
    stats, lengths = {}, collections.defaultdict(set)
    for name, n, dtype, fmt in sorted(calls, key=str):
        x = _codec_input(n + 1, dtype, gen, special=True)
        b = _codec_input(n + 1, dtype, gen, special=False)
        for off in (0, 1):
            xs, bs = x[off:off + n], b[off:off + n]
            tag = f"{name} {dtype} {fmt} n={n} offset {off} (main path)"
            if name == "bf16_pack":
                _same_bits(codec.bf16_pack(xs), ref.bf16_pack_ref(xs), tag,
                           name, stats)
                continue
            if name in ("k1", "k1_mixed"):
                other = ref.bf16_pack_ref(bs) if name == "k1_mixed" else bs
                _same_bits(ca.chunk_accumulate(xs, other),
                           ref.chunk_accumulate_ref(xs, other), tag, name,
                           stats)
                continue
            vals, scales = ref.fp8_encode_ref(xs, fmt=fmt)
            if name == "fp8_encode":
                got = codec.fp8_encode(xs, fmt)
                _same_bits(got[0], vals, tag, name, stats)
                _same_bits(got[1], scales, tag, name, stats)
            elif name == "fp8_decode":
                _same_bits(codec.fp8_decode(vals, scales, fmt, dtype),
                           ref.fp8_decode_ref(vals, scales, out_dtype=dtype),
                           tag, name, stats)
            else:
                _same_bits(codec.fp8_decode_accumulate(vals, scales, bs, fmt),
                           ref.fp8_decode_accumulate_ref(vals, scales, bs),
                           tag, name, stats)
        lengths[name].add(n)
        del x, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name in ("fp8_encode", "fp8_decode_accumulate", "fp8_decode",
                 "bf16_pack", "k1_mixed"):
        check(lengths[name], f"{name}: no call recorded on the main path")
    lengths = {k: sorted(v) for k, v in lengths.items()}
    print(f"phase 12: K2-K5 and the mixed K1 vs plain versions at every "
          f"length the main path gave them ({lengths}), aligned and one "
          f"off, NaN and inf groups: "
          f"bit for bit, NaN at the same places (NaNs with other bits: "
          f"{stats.get('nan_bits', {})}); max abs err "
          f"{ {k: v for k, v in stats.items() if k != 'nan_bits'} }")
    return stats, lengths


def phase12_codec_times(card, plans, lengths):
    key, (mem_bps, _) = card_peaks(card)
    # K2-K4 at the lm_head gradient all-reduce of phase 11 ([4096, 151552]
    # bf16): its staged segment, one rank's ring chunk of it, one
    # sub-chunk; K5 and the mixed K1 at the longest call of their own
    # path, phase 10 (c)
    _, numel, units, _, substeps = [p for p in plans
                                    if p[0] == "all_reduce"
                                    and p[1] == LM_HEAD_NUMEL][0]
    sub = numel * dict(units)["staged"] // 16 // 2 // substeps
    check(sub in lengths["fp8_encode"], f"the lm_head sub-chunk {sub} is "
          f"not among the fp8 path's lengths {lengths['fp8_encode']}")
    where = {name: (sub, "one staged sub-chunk of the lm_head gradient "
                         "all-reduce, phase 11")
             for name in ("fp8_encode", "fp8_decode_accumulate",
                          "fp8_decode")}
    for name in ("bf16_pack", "k1_mixed"):
        where[name] = (max(lengths[name]), "one staged sub-chunk of the "
                       "float32 all-reduce of phase 10 (c)")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = collections.defaultdict(dict)
    for shape_name in ("main", "64MiB"):
        groups = collections.defaultdict(list)
        for name in CODEC_OPS:
            groups[where[name][0] if shape_name == "main"
                   else 32 * MiB].append(name)
        for n, names in sorted(groups.items()):
            _time_codecs(n, names, gen, shape_name, rows, key, mem_bps)
    for name in CODEC_OPS:
        rows[name]["main"]["where"] = where[name][1]
    return rows


def _time_codecs(n, names, gen, shape_name, rows, key, mem_bps):
    """Time the kernels ``names`` at length ``n`` into rows[name][shape]."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, ref
    s = -(-n // 128) * 4
    # name: (kernel, plain version, one PyTorch call or None, bytes: every
    # input read once, every output written once); each takes the index
    # of its operands' copy
    calls = {
        "fp8_encode": (lambda i: codec.fp8_encode(xb[i]),
                       lambda i: ref.fp8_encode_ref(xb[i]), None,
                       2 * n + n + s),
        "fp8_decode_accumulate": (
            lambda i: codec.fp8_decode_accumulate(vals[i], scales[i], bb[i],
                                                  "fp8_e4m3"),
            lambda i: ref.fp8_decode_accumulate_ref(vals[i], scales[i],
                                                    bb[i]),
            None, n + s + 2 * n + 2 * n),
        "fp8_decode": (
            lambda i: codec.fp8_decode(vals[i], scales[i], "fp8_e4m3",
                                       torch.bfloat16),
            lambda i: ref.fp8_decode_ref(vals[i], scales[i],
                                         out_dtype=torch.bfloat16),
            None, n + s + 2 * n),
        "bf16_pack": (lambda i: codec.bf16_pack(xf[i]),
                      lambda i: ref.bf16_pack_ref(xf[i]),
                      lambda i: xf[i].to(torch.bfloat16), 4 * n + 2 * n),
        "k1_mixed": (lambda i: ca.chunk_accumulate(xf[i], packed[i]),
                     lambda i: ref.chunk_accumulate_ref(xf[i], packed[i]),
                     lambda i: xf[i] + packed[i], 4 * n + 2 * n + 4 * n),
    }
    k = rotations(min(calls[name][3] for name in names))
    xb = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(k)]
    xf = [torch.randn(n, generator=gen, device="cuda") for _ in range(k)]
    bb = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(k)]
    vals, scales = zip(*(ref.fp8_encode_ref(x) for x in xb))
    packed = [ref.bf16_pack_ref(x) for x in xf]
    for name in names:
        kern, plain, lib, nbytes = calls[name]
        ms = time_ms(kern, sets=k)
        plain_ms = time_ms(plain, iters=5, warmup=1, sets=k)
        lib_ms = time_ms(lib, sets=k) if lib is not None else None
        b_s, f_s = nbytes / mem_bps, CODEC_OPS[name] * n / F32_FLOPS
        bound_ms = max(b_s, f_s) * 1e3
        bound_by = "bytes" if b_s >= f_s else "operations"
        rows[name][shape_name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, n=n)
        lib_txt = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        print(f"phase 12: {name} n={n} ({shape_name}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{lib_txt}, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes} B at {mem_bps / 1e12:.2f} TB/s: "
              f"{key} datasheet); {bound_ms / ms:.1%} of bound; operands "
              f"rotated over {k} copies, out of L2")
    del xb, xf, bb, vals, scales, packed
    torch.cuda.empty_cache()


def _codec_row(name, cuda_name, source, replaces, launches, rows,
               launches_from, err, err_lengths, lengths):
    main, big = rows["main"], rows["64MiB"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_from": launches_from, "max_abs_err": err,
            "max_abs_err_at": f"the main path's lengths {lengths}, phase 12",
            "max_abs_err_phase9": err_lengths,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "shape": f"n={main['n']} ({main['where']})",
            "n_64MiB": {k: big[k] for k in ("n", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")},
            "kernel": cuda_name}


# phase 14: K7, the payload split and merge.  No path launches them
# (routing.execute partitions with views and torch.cat, as the reference's
# execute does with lax.dynamic_slice), so they are held against their
# plain versions and timed here only
K7_SPLITS = ((1,), (2, 1), (1, 3, 2), (4, 1, 2, 3))
K7_BIG = 64 * MiB                      # bytes a timed call copies


def _k7_cases(dtype, err):
    """K7a and K7b vs plain versions at the reference test's cases and at
    one element off its blocks; returns the max abs error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import payload_partition as pp
    blk = ref.BLOCK
    x = (torch.arange(10 * blk + 4, device="cuda", dtype=torch.float32)
         * 0.5).to(dtype)

    def same(got, want, tag):
        torch.cuda.synchronize()
        check(torch.equal(_bits(got), _bits(want)), f"K7 {tag} {dtype}: "
              f"not bit-identical to its plain version")
        return max(err, (got.float() - want.float()).abs().max().item())

    for n_blocks, start in ((1, 0), (2, 1), (3, 5)):
        err = same(ops.extract_segment(x[:8 * blk], start, n_blocks),
                   ref.extract_segment_ref(x[:8 * blk], start, n_blocks),
                   f"extract ({n_blocks}, {start})")
        a, n = start * blk + 1, n_blocks * blk - 1
        err = same(pp.extract(x, a, n), x[a:a + n].clone(),
                   f"extract [{a}, {a + n})")
    for sizes in K7_SPLITS:
        for extra in (0, 1):
            segs, off = [], 0
            for s in sizes:
                segs.append(x[off:off + s * blk + extra].clone())
                off += s * blk + extra
            got = ops.merge_segments(segs) if extra == 0 else pp.merge(segs)
            err = same(got, ref.merge_segments_ref(segs),
                       f"merge {sizes} + {extra}")
    return err


def phase14_k7(card):
    from repro_torch.kernels import payload_partition as pp
    from repro_torch.kernels import ref
    key, (mem_bps, _) = card_peaks(card)
    before = dict(pp.launch_count)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = _k7_cases(dtype, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(14)
    blk = ref.BLOCK
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = K7_BIG // torch.finfo(dtype).bits * 8         # elements
        nb = n // blk
        k = rotations(2 * K7_BIG)
        # K7a: the second half of a 2n payload; K7b: four segments of
        # 1/2, 1/4, 1/8, 1/8 of n
        xs = [torch.randn(2 * n, generator=gen, device="cuda").to(dtype)
              for _ in range(k)]
        parts = (nb // 2, nb // 4, nb // 8, nb // 8)
        segs = [[torch.randn(p * blk, generator=gen, device="cuda").to(dtype)
                 for p in parts] for _ in range(k)]
        got = pp.extract(xs[0], n, n)
        check(torch.equal(_bits(got), _bits(ref.extract_segment_ref(
            xs[0], nb, nb))), f"K7a 64 MiB {dtype}: not bit-identical")
        got = pp.merge(segs[0])
        check(torch.equal(_bits(got), _bits(ref.merge_segments_ref(
            segs[0]))), f"K7b 64 MiB {dtype}: not bit-identical")
        del got
        calls = {
            "extract_segment": (lambda i: pp.extract(xs[i], n, n),
                                lambda i: ref.extract_segment_ref(
                                    xs[i], nb, nb),
                                lambda i: xs[i][n:2 * n].clone()),
            "merge_segments": (lambda i: pp.merge(segs[i]),
                               lambda i: ref.merge_segments_ref(segs[i]),
                               lambda i: torch.cat(segs[i]))}
        for name, (kern, plain, lib) in calls.items():
            ms = time_ms(kern, sets=k)
            plain_ms = time_ms(plain, sets=k)
            lib_ms = time_ms(lib, sets=k)
            bound_ms = 2 * K7_BIG / mem_bps * 1e3
            rows[name, dtype] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound_ms,
                                     bound_by="bytes", n=n)
            lib_name = ("x[a:b].clone()" if name == "extract_segment"
                        else "torch.cat")
            print(f"phase 14: {name} {str(dtype)[6:]} {n} elements "
                  f"(64 MiB): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"{lib_name} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"bytes ({2 * K7_BIG} B at {mem_bps / 1e12:.2f} TB/s: "
                  f"{key} datasheet); {bound_ms / ms:.1%} of bound; "
                  f"operands rotated over {k} copies, out of L2")
        del xs, segs
        torch.cuda.empty_cache()
    # timing and checking launches are not a path's
    pp.launch_count.update(before)
    print(f"phase 14: K7a/K7b vs plain versions, float32 and bfloat16, at "
          f"the reference test's cases, one element off its blocks and at "
          f"64 MiB: bit for bit (max abs err {max(errs.values())}); no "
          f"path launches them (launches 0)")
    return max(errs.values()), rows


def _k7_row(name, line, err, rows):
    main = rows[name, torch.bfloat16]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/payload_partition.cu",
            "replaces": f"src/repro/kernels/payload_partition.py:{line}",
            "launches": 0,
            "launches_from": "no path calls it: routing.execute slices "
                             "with views, as the reference's does with "
                             "lax.dynamic_slice",
            "max_abs_err": err,
            "max_abs_err_at": "the reference test's cases, one element "
                              "off, 64 MiB; float32 and bfloat16, phase 14",
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "shape": f"{main['n']} bf16 elements (64 MiB copied)",
            "float32": {k: rows[name, torch.float32][k]
                        for k in ("n", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
            "kernel": {"extract_segment": "K7a",
                       "merge_segments": "K7b"}[name]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # float32 references run in full float32 on the card (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase1_card_and_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase2_kernel_vs_plain(gen)
    phase3_reduced_parity()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        launches, _ = phase4_full_width(pathlib.Path(tmp))
    times = phase5_times(card)
    main_row, long_row = times[6], times[256]
    k1_errs = phase6_k1_vs_plain()
    k1_launches, plans = phase7_collectives()
    k1_rows = phase8_k1_times(card, plans)
    k1_main, k1_big = k1_rows["b_substep"], k1_rows["chunk_64MiB"]
    codec_errs = phase9_codecs_vs_plain()
    bf16_launches, bf16_calls = phase10_codec_collectives()
    train_launches, train_plans, train_calls = phase11_training()
    fp8_launches = train_launches["fp8"]
    tp_k1, k7_launches, tp_calls = phase13_tp_training()
    path_errs, path_lengths = phase12_main_path_check(
        train_calls | bf16_calls | tp_calls)
    codec_rows = phase12_codec_times(card, train_plans, path_lengths)
    k7_err, k7_rows = phase14_k7(card)
    kernels = [{
        "name": "paged_flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:89",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "T=32 Hq=32 Hkv=2 hd=128 block=16 maxb=6 bf16",
        "maxb256": {k: long_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
    }, {
        "name": "chunk_accumulate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunk_accumulate.cu",
        "replaces": "src/repro/kernels/chunk_accumulate.py:40",
        "launches": k1_launches,
        "max_abs_err": k1_errs[torch.bfloat16],
        "max_abs_err_f32": k1_errs[torch.float32],
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"],
        "shape": f"n={k1_main['n']} bf16 (one staged sub-chunk of the "
                 f"1 GiB all-reduce on 4 ranks)",
        "chunk_64MiB": {k: k1_big[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
        "launches_train_flexlink": train_launches["flexlink"]["k1"],
        "launches_train_tp_flexlink": tp_k1,
        "mixed_f32_bf16": {
            "launches": bf16_launches["k1_mixed"],
            "max_abs_err": path_errs["k1_mixed"],
            "max_abs_err_at": f"the main path's lengths "
                              f"{path_lengths['k1_mixed']}, phase 12",
            "max_abs_err_phase9": codec_errs["k1_mixed"],
            "launches_from": "phase 10 (c), 4 ranks",
            **{k: codec_rows["k1_mixed"]["main"][k]
               for k in ("n", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "where")},
            "n_64MiB": {k: codec_rows["k1_mixed"]["64MiB"][k]
                        for k in ("n", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}},
    }]
    codec_src = "src/repro_torch/kernels/csrc/codec.cu"
    fp8_from = "phase 11, fp8 training run, 2 ranks"
    kernels += [
        _codec_row(name, cuda_name, codec_src,
                   f"src/repro/kernels/codec.py:{line}", launches[name],
                   codec_rows[name], launches_from, path_errs[name],
                   codec_errs[name], path_lengths[name])
        for name, cuda_name, line, launches, launches_from in (
            ("fp8_encode", "K2", 80, fp8_launches, fp8_from),
            ("fp8_decode_accumulate", "K3", 136, fp8_launches, fp8_from),
            ("fp8_decode", "K4", 110, fp8_launches, fp8_from),
            ("bf16_pack", "K5", 55, bf16_launches,
             "phase 10 (c), 4 ranks"))]
    kernels += [_k7_row(name, line, k7_err, k7_rows)
                for name, line in (("extract_segment", 36),
                                   ("merge_segments", 59))]
    for row in kernels:
        if row.get("kernel") in ("K7a", "K7b"):
            got = k7_launches[row["kernel"].lower()]
            check(got == 0, f"{row['name']}: {got} launches on the "
                  f"training path, which never calls it")
            row["launches"] = got
        else:
            check(row["launches"] > 0, f"{row['name']}: no launch on its "
                  f"path")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
