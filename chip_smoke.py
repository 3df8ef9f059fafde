#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel from the checkout's CUDA sources (K6 and K1, one ``nvcc`` per
   source, all at once), timed;
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
   memory bound (3 x bytes over the card's rate).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  K1's launches in that line are the
ranks' own counts from phase 7, summed: each rank process sets its count
to 0 before its collectives and reports it after them.  Without a CUDA
card, or without the rest of the checkout beside this file, it prints no
result and exits 1.
"""

from __future__ import annotations

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


def time_ms(fn, iters=20, warmup=5) -> float:
    """Median device time of one call, by CUDA events around each call.
    A spin kernel (about 50 ms) goes first so that the host queues every
    timed call before the device reaches them: the events then bracket
    device time only, not the host's launch overhead between calls."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase1_card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import flash_decode as fd
    t0 = time.perf_counter()
    built = _nvcc.build_all([fd.SOURCE, ca.SOURCE])
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
                before = ca.launch_count
                got = ops.accumulate(x, y)
                want = ref.chunk_accumulate_ref(x, y)
                torch.cuda.synchronize()
                check(ca.launch_count == before + 1, "K1 did not launch")
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
    ca.launch_count = 0
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
    launches = ca.launch_count
    plain = routing.execute(plan, x, mesh_b,
                            accumulate=ref.chunk_accumulate_ref)
    torch.cuda.synchronize()
    check(ca.launch_count == launches, "the plain run launched K1")
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
        a = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        before = ca.launch_count
        ms = time_ms(lambda: ca.chunk_accumulate(a, b))
        ca.launch_count = before          # timing launches are not the path's
        plain_ms = time_ms(lambda: ref.chunk_accumulate_ref(a, b))
        lib_ms = time_ms(lambda: a + b)
        nbytes = 3 * n * a.element_size()
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
              f"{bound_ms / ms:.1%} of bound")
    return rows


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
    }]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
