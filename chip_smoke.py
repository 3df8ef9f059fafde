#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel from the checkout's CUDA sources, timed;
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
   memory bound of the card named in phase 1.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the checkout beside this file, it prints no result and exits 1.
"""

from __future__ import annotations

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
    from repro_torch.kernels import flash_decode as fd
    t0 = time.perf_counter()
    lib, log = fd.build()
    build_s = time.perf_counter() - t0
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    print(f"phase 1: card {torch.cuda.get_device_name(0)}; built "
          f"{lib.relative_to(ROOT)} from {fd.SOURCE.relative_to(ROOT)} in "
          f"{build_s:.1f} s")
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
