#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--baseline DIR]

``--baseline`` names an earlier checkout (``git archive`` of a commit,
unpacked; only its ``src/repro_torch/kernels`` is read): its K6 runs
phase 4's logits step beside this checkout's, its K2-K4 are timed in
turns with this checkout's in phase 12, its K1 and K5 launched once a
sub-chunk are timed in turns with this checkout's one launch a ring step
in phases 8 and 12, its K7 in turns with this checkout's in phase 14
(and its codec's, K1's and K7's SASS counted in phase 1).
Without it the script needs nothing but this checkout.

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel from the checkout's CUDA sources (K6, K1, K2-K5 and K7, one
   ``nvcc`` per source, all at once), timed, with ptxas's registers and
   spills of each kernel, the codec, K1 and K7 kernels' SASS instruction
   counts (``cuobjdump -sass``; global loads and stores by width) and K6's
   dynamic shared memory;
2. K6, the paged flash-decode kernel, against its plain PyTorch version at
   glm4-9b shapes (Hq 32, Hkv 2, hd 128, block 16), at GQA groups 1,
   2, 4, 8, 12 and 16 with hd 64 and 128, at kimi-k2's full width
   (Hq 64, Hkv 8, hd 112), at internvl2's (Hq 64, Hkv 8, hd 128) and at
   glm4-9b's shard at (model=2) (Hq 16, Hkv 1, hd 128) (T in {1, 8, 32},
   max blocks in
   {6, 64, 256}; float32 and bfloat16; padding rows and a sliding window)
   at atol 3e-5 (f32) / 2e-2 (bf16), padding rows exact zeros; the
   n_split each call took is printed;
3. reduced glm4-9b in float32 (TF32 off throughout): the paged engine
   with the kernel, the paged engine with the dense-gather reference and
   the wave engine give equal greedy streams;
4. full-width glm4-9b in bfloat16 (random weights from seed 0) through
   the serving launcher, ``--paged on --attn-impl kernel --requests 8
   --mixed``: every request served, K6 launched 40 x packed steps; then
   one packed step's logits with the kernel, with the dense-gather
   reference path and with that path on the params upcast to float32:
   the relative L2 error of each bf16 path against the float32 run, and
   of the kernel path against the dense bf16 one, each bounded; and the
   workload once more under ``torch.profiler`` (the device's busy share,
   the top kernels, K6's device time a packed step);
5. K6 timed by CUDA events (median) at the phase-4 shape and at 256 and
   1024 blocks, beside its plain version,
   ``F.scaled_dot_product_attention`` on the gathered dense K/V,
   head-expanded and with ``enable_gqa`` (the yardsticks the port never
   calls; the faster is the library time), a streaming read of as many
   bytes (``torch.sum`` over a contiguous buffer: what a plain kernel
   reaches at that size) and the memory bound of the card named in phase
   1, each call on its own copy of the operands, rotated out of L2 (the
   L2-warm reading that PRs 11-14 reported is printed beside it);
6. K1, the staged ring's chunk accumulate, against its plain version in
   float32 and bfloat16 at lengths {1, 1000, 2^20+7, 2^26}, aligned and
   one element off alignment: bit for bit, and equal to ``a + b`` in
   bfloat16; then one segment-table launch each of K1 (f32, bf16, f16,
   f32 + bf16) and K5 (f32, bf16) over tables of 1, 2, 3, 8 and 1
   segments (K1_TABLES), every segment aligned, one element off, or every
   other one off, NaN and inf included: bit for bit pair by pair, one
   launch a table, and each segment on the vector path exactly when its
   pointers are 16-byte aligned;
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
   n - 1 times per staged reduce: one launch a ring step over all its
   sub-chunks.  Wall times are of host-staged gloo on one card, not a
   link bandwidth;
8. K1 timed by CUDA events at the staged sub-chunk of (b) (2^20) and at a
   64 MiB bfloat16 chunk (2^25), beside its plain version, ``a + b`` and
   the memory bound (3 x bytes over the card's rate), and one ring step
   of (b) (its s sub-chunks) as one segment-table launch against one
   launch a sub-chunk (``--baseline``'s K1, else this checkout's), in
   turns, with the operands rotated over enough copies that each call
   reads device memory, not L2;
9. the wire codecs K2-K5 and the mixed (float32 + bfloat16) K1 against
   their plain versions on the card at lengths {1, 127, 1000, 2^20+7,
   2^26}, aligned and one element off, float32 and bfloat16 input, both
   fp8 formats, with NaN, inf and all-zero groups: bit for bit (NaN at
   the same places, and with the same bits);
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
   launches equal what the plans imply (K1 and K5 once a ring step, the
   fp8 codecs once a sub-chunk);
11. full-width glm4-9b training (depth cut 40 -> 2, bf16, random weights
   from seed 0), ``build_train_program`` + ``run_loop`` on 2 gloo ranks
   sharing this card, seq 128, global batch 8, 2 steps each with the
   ``nccl`` backend, ``flexlink`` and ``flexlink`` with
   ``--compress secondary=fp8``, AdamW at lr 1e-4: finite losses, equal
   on both ranks, falling; flexlink within 5e-3 of nccl per step, fp8
   within 0.05 max(|loss|, 1); the fp8 step's codec plans printed and
   the K2/K3/K4 launches equal to what those plans imply, and how many of
   those calls took codec.cu's 16-byte vector path; peak memory; then the
   same model with its gradient sync in 64 MiB buckets launched from the
   backward (``bucket_mb=64``), ``flexlink-b64`` and ``fp8-b64-ef``
   (``secondary=fp8`` with error-feedback residuals): 47 buckets a step,
   the GradBucketer plan's, issued g0.. in order from inside the backward
   on the ctx's side stream; under fp8 46 of them take the error-feedback
   roundtrip and the residuals are live; K1-K4 launches equal to what the
   plans imply plus one K2 and one K4 an error-feedback bucket;
   flexlink-b64 within 5e-3 of nccl a step, fp8-b64-ef within 0.05
   max(|loss|, 1); the wall times of every run printed beside each other
   (host-staged gloo on one card: no overlap is claimed);
12. (a) K1-K5 against their plain versions at every length, dtype and
   format their kernels were given on the main path (phases 7, 10, 11
   and 13), aligned and one element off, and the K1 and K5 segment-table
   launches at every table of sub-chunk lengths those phases gave them,
   aligned, one off and every other segment off, NaN and inf groups
   included: bit for bit (the ``max_abs_err`` of the kernels line); (b)
   K2-K5 and the mixed K1 timed by CUDA events at one staged sub-chunk
   of their path (K2-K4: the lm_head gradient all-reduce of phase 11; K5
   and the mixed K1: phase 10 (c), 131072) and at 64 MiB (2^25 elements
   for K5), beside their plain versions, the memory bound and, for K5
   and the mixed K1, the one PyTorch call that computes the same
   function (with ``--baseline``, the earlier K2-K4 beside them, in
   turns); then one ring step each of K5 and the mixed K1 (phase 10
   (c)'s) and of K1 (phase 13's model-axis combine) as one segment-table
   launch against one launch a sub-chunk, in turns (as in phase 8).
   Each timed call works on its own copy of the operands, rotated so
   that none is still in L2 (as in phase 8).  Phase 12 runs after phase
   13;
13. tensor-parallel training of full-width glm4-9b (depth cut 40 -> 2,
   bf16, random weights from seed 0, each rank keeping its model-axis
   shards of the global init) on (data=2, model=2): 4 gloo ranks sharing
   this card, seq 128, global batch 8, 2 steps each with the ``nccl``
   backend and ``flexlink``, AdamW at lr 1e-4, the model axis's
   all-reduce slot pinned by a TuningProfile to primary/staged/ortho
   50/25/25 (the tuner would give these 4 MiB combines the primary route
   only): finite losses, equal on all 4 ranks, falling, flexlink within
   5e-3 of nccl; recorded calls a step (3 on the model axis, one a leaf
   on the data axis: the reference's per-trace counts); model-axis
   all-reduces executed a step (5 forward, 2 in the checkpoint
   recompute, 5 backward); K1 launches equal to what the executed plans
   imply, n - 1 a staged ring; peak memory and wall time; and
   ``flexlink-b64``, the same run with 64 MiB buckets launched from the
   backward: 27 buckets a step (a rank's shards) issued in order on the
   side stream, one data-axis call recorded in each bucket's scope, the
   launches of its plans, losses within 5e-3 of flexlink.  Before the
   flexlink run's first step each rank lowers the same program
   (``StepProgram.lower``) on meta copies of its arguments: the lowered
   step's collectives (op, axis, dtype, bytes) equal the first live
   step's, traced and executed, as multisets, and so do the plan
   signatures;
14. K7a/K7b, the payload split and merge on segments.cuh's tables,
   against their plain versions in float32, bfloat16 and uint8 at the
   reference test's cases, at lengths and offsets one element off its
   blocks and at merges of 9 and 17 segments (ceil(n / 8) launches), and
   in bfloat16 at 64 MiB
   (the second half of a 128 MiB payload; four segments of 1/2, 1/4,
   1/8, 1/8 of 64 MiB; 9 and 17 segments) and at the route segments of
   phase 7 (a)'s 256 MiB payload and phase 13's 4 MiB combine at
   50/25/25: bit for bit; each timed (with ``--baseline``, in turns with
   the earlier K7: earlier, this, this, earlier), beside their plain
   versions, ``x[a:b].clone()`` / ``torch.cat`` and the memory bound, on
   rotated operand copies;
15. MoE serving through the paged engine and K6: (a) reduced float32
   mixtral-8x7b and kimi-k2 (TF32 off): greedy streams through K6 equal
   those through the dense-gather path, K6 launched layers x packed
   steps, one packed step's logits within 1e-4; (b) mixtral-8x7b at its
   published widths (depth cut 32 -> 8, bf16, seed 0; 8 experts top-2,
   sliding window 4096), 8 mixed requests, and (c) kimi-k2 at its
   published widths (depth cut 61 -> 2: the dense prefix layer and one
   MoE layer of 384 experts top-8, head_dim 112), 4 requests: every
   request served, K6 launched layers x packed steps, tok/s and the
   median step; one packed step's logits, kernel path against dense
   gather, relative L2 with the kernel pass's routing pinned to the
   dense pass's experts (bounded) and unpinned (printed with the token
   routings that flipped between the paths);
16. MoE training: (a) mixtral-8x7b at its published widths (depth cut to
   1, bf16) on (data=2), 2 gloo ranks on the card, seq 128, global batch
   8, 2 steps each with ``nccl`` and ``flexlink``: losses (router aux
   included) finite, falling, bit for bit equal, K1 launched, peak
   memory; (b) reduced kimi-k2 ``ep_a2a`` (4 experts over the data axis,
   their FFN hidden dim over the model axis) on (data=2, model=2), 4
   gloo ranks, the data axis's all_to_all slot pinned to primary +
   staged: losses bit for bit equal between nccl and flexlink, and 2
   all_to_alls a step in the forward, 2 in the checkpoint recompute and
   2 in the backward (their transposes) on every rank;
17. SSM and hybrid: (a) mamba2-1.3b and (b) zamba2-1.2b at their
   published widths and depths (48 and 38 Mamba2 layers; zamba2's shared
   attention block after each group of 6 and 2 remainder layers), bf16,
   seed 0, 4 requests through the wave engine: every request served,
   tokens in the vocabulary, a forward's logits finite, tok/s; then
   mamba2-1.3b at its widths, depth cut 48 -> 12, on (data=2), 2 steps
   with ``nccl`` and ``flexlink``:
   losses falling and bit for bit equal, K1 launched, peak memory;
18. the vlm and encdec families: (a) reduced float32 internvl2-76b
   (paged engine through K6 == dense gather == wave engine, K6 launched
   layers x packed steps, one packed step's logits within 1e-4) and
   whisper-medium (the wave engine's greedy streams on the card equal
   its streams on the CPU, the cross-attention cache zero on both, as the
   reference's served Whisper); (b) InternVL2-76B's backbone at its
   published widths (depth cut 80 -> 4, bf16, seed 0) through the paged
   engine with K6, phase 4's 8 mixed requests: every request served, K6
   launched 4 x packed steps, tok/s and the median step, one packed
   step's logits kernel vs dense gather within phase 4's bound; (c) the
   prefill program on that model, batch 2 of 256 stub patch rows and 32
   tokens, on one rank and on (model=2) (2 gloo ranks on the card, the
   model axis pinned to 50/25/25): last-row logits of the two within a
   bound, K1 launches equal to what the executed plans imply, peak
   memory; (d) whisper-medium at its published widths and depth through
   the serving launcher on the wave engine, 4 requests: every request
   served, tokens in the vocabulary, tok/s; (e) whisper-medium at its
   widths, depth cut 24 + 24 -> 6 + 6, and reduced internvl2-76b on
   (data=2), 2 steps each with ``nccl`` and
   ``flexlink`` (the frontend stubs in the batch): losses falling and bit
   for bit equal, K1 launched, peak memory, wall time;
19. serving across devices through ``launch/steps.build_serve_program``,
   gloo ranks on the card: (a) reduced float32 glm4-9b and zamba2-1.2b
   (TF32 off) on (model=2) (batch 4, the cache sequence-sharded over
   model) and on (data=2, model=2) (batch 1, over data x model), 10
   steps: every rank's logits within 2e-3 (the reference's bound) of the
   decode over a local cache on the same ranks and, for glm4, of one
   rank's local decode (zamba2's gap to one rank is printed: a Mamba2
   block at tp > 1 normalises over each shard's heads, as the
   reference's); Q gathers issued on the side stream and joined before
   they are read; (b) glm4-9b at its published widths and depth, bf16,
   seed 0, on (model=2), batch 8, a 4096 cache (2048 a rank) filled with
   seeded random K/V at the model's own scale (the same global cache on
   every mesh and on one rank), 6 greedy steps from 3072 (the argmax of
   the logits gathered over the model axis), each issued and awaited,
   the model axis's all-reduce pinned to 50/25/25: K1 launches equal to
   what the executed plans imply, 81 combines and 40 Q gathers (issued =
   joined) a step, ms a step, peak memory, and the program lowered on
   meta copies before the first step issuing, tracing and planning what
   that step does (as phase 13's); the same steps on the shards
   upcast to float32: the last step's logits within 2e-3 of one rank's
   float32 decode of the same tokens; (c) the same model, batch 1, the
   cache over (data=2, model=2) (4 ranks, 32768, 8192 a rank), filled,
   4 steps from 24574 (the owning shard moves from 2 to 3; shards 0-2
   hold real keys): K1 = the plans', every rank's bf16 logits' and one
   rank's distances from one rank's float32 run printed; the same steps
   on the shards' first 8 layers upcast to float32 (four ranks' whole
   shards in float32 would not fit the card): every rank's logits within
   2e-3 of one rank's float32 decode of those layers; (d)
   ``paged_decode_step`` through K6 at (model=2) (16 Q heads and 1 KV
   head a rank), 8 requests' prompts packed in one step, then 6 greedy
   steps: K6 launched 40 x steps a rank, each of those calls against
   K6's plain version on its own inputs (atol 2e-2), the packed step's
   bf16 logits and one rank's each within phase 4's bound of one rank's
   float32 step through K6.  In (b)-(d) the sharded bf16 run's distance
   from the float32 run is under 1.2 times one rank's.  Then every K1
   segment table the serve programs of (b) and (c) launched against the
   plain version, bit for bit (as phase 12 (a));
20. the two-tier cluster, 4 gloo ranks on the card as (node=2, data=2),
   ``cluster_for("h100", 2)``, the data axis pinned to 50/25/25 and the
   node axis (the NIC tier) to rail 50 / xrail 25 / host_tcp 25 at every
   bucket: (a) the ctx's ClusterCommunicator's hierarchical all-reduce,
   all-gather and reduce-scatter at 64 MiB a rank of bfloat16 and of
   float32 (``_pattern`` payloads, [rows, 4096]): bit for bit the exact
   results (the
   flat sum, the node-major gather, segment ``i * 2 + node``), the NIC
   tier's plans on all three routes, K1 launches equal to what the
   executed plans imply, wall time a call; a (data=4) cluster with the
   intra tier alone gives the bare communicator's plan signature and
   bits; (b) Whisper-medium at its published widths and depth, bf16,
   seed 0, 8 rows a rank, 2 flexlink steps on (node=2, data=2) and on
   (data=4): losses equal on every rank, the cluster run within 5e-3 of
   the flat one (the reference's own bound), K1 = the plans', peak
   memory, wall time; then every K1 segment table of (a) and (b) against
   the plain version, bit for bit;
21. live faults on the same 4 ranks and cluster, both tiers pinned as in
   20 and the rail3-degraded NIC tier at the same class shares: (a) 14
   ticks of a 64 MiB bf16 hierarchical all-reduce a rank under
   ``rail3@step2=0.25,rail3@step9=1.0``, a FabricClock on the ctx
   advanced at the top of each tick: every tick exact; every rank commits
   the degrade at tick 5 and the restore at 12 (step + K - 1), the NIC
   tier re-keys twice (``transition:exact``) and the data tier never, the
   clock reports equal on every rank; the plan signature moves at 5 and
   returns to the healthy one at 12; rail3 carries fewer member units
   than each healthy rail in the degraded plans; K1 = the plans' every
   tick; then rail2 flapping every tick over 10 ticks: no re-key,
   suppressed flaps, one signature; (b) Whisper-medium at its published
   widths, depth cut 24 + 24 -> 2 + 2, bf16, seed 0, seq 128, 8 rows a
   rank, ``node1@step1=down``, a snapshot every 3 steps, 6 steps: the
   drop commits at step 4, ranks 2 and 3 leave, ranks 0 and 1 build
   their process groups alone, resume from snapshot 3 on (data=2) and
   run steps 3-5 (7 losses); every param leaf bit-equal to a fresh
   (data=2) launch restoring snapshot 3; K1 = the plans' before the drop
   (the hierarchical legs) and after it (the data axis); peak memory and
   the wall of each part; then every K1 segment table of (a) and (b)
   against the plain version, bit for bit;
22. the pod tier, ``cluster_for("h100", 2, pods=2)``, every tier pinned
   at every size bucket (data 50/25/25, node rail/xrail/host_tcp
   50/25/25, pod spine/xspine/pod_tcp 50/25/25): on 8 gloo ranks sharing
   the card as (pod=2, node=2, data=2), (a) the three-tier all-reduce,
   all-gather and reduce-scatter at 64 MiB a rank of bfloat16 and
   float32 (``_pattern8``, sums exact in bf16), bit for bit the mesh's
   plain all-reduce and all-gather over the (pod, node, data) plane group
   (the reduce-scatter at segment ``(i * 2 + node) * 2 + pod``), the pod
   tier's plans on all three routes, K1 = the plans', wall time a call;
   (b) the rail-local ep_all_to_all of Kimi-K2's [384 x 14, 7168] bf16
   dispatch buffer, bit for bit the flat all_to_all over the plane group,
   and its a2a report (intra, rail-local and spine bytes); (c) Kimi-K2's
   MoE block at its published widths, 48 experts a rank, each rank
   drawing only its own experts (seeded per expert; 4.2 GB a rank),
   forward and the backward to its input, output and input gradient bit
   for bit between the rail-local and the flat dispatch, all_to_alls a
   pass and peak memory; then on 4 gloo ranks (d) Whisper-medium whole
   through the train launcher's rank path with ``--pods 2 --nodes 2
   --mesh-shape 1,1`` (the NIC and spine tiers, no intra tier), phase 20
   (b)'s model, batch, seed and steps: losses within 5e-3 of phase 20
   (b)'s (data=4) ones, every rank's report with the pod tier, K1 = the
   plans'; then every K1 segment table of (a) and (d) against the plain
   version, bit for bit;
23. the dry-run (``python -m repro_torch.launch.dryrun``, no card, no
   rank): glm4-9b ``decode_32k`` on the production mesh (16, 16) and
   ``train_4k --mesh-split 2,4``, both started beside phase 1's build
   and read here, both ``ok``; each record's collective structure,
   argument bytes, the roofline's terms at the H100's datasheet peaks,
   its lowering wall and its run's are printed.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  The launches in that line are the
ranks' own counts from each kernel's path, summed: K1 from phase 7, K2-K4
from the fp8 training run of phase 11 (the bucketed runs' beside them),
K5 and the mixed K1 from phase 10 (c), K7 from phase 13 (0: no path
calls it); K6's row adds phase 15's launches (b, c), phase 18 (b)'s and
phase 19 (d)'s (both ranks), and K1's the flexlink runs of phases 16
(a), 17 (a) and 18 (e), the (model=2) prefill of phase 18 (c), the
serve program's bf16 runs of phase 19 (b) and (c), phase 20's
hierarchical collectives (a) and cluster training run (b), phase 21's
degrade run (a) and elastic run (b), and phase 22's three-tier
collectives (a) and pod training run (d); each rank process sets
its counts to 0 just before that path and reports them just after it.
A K1 or K5 segment-table launch counts once, whatever its segments.
Without a CUDA card, or without the rest of the checkout beside this
file, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import itertools
import json
import os
import re
import pathlib
import shutil
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


def make_case(gen, t_rows, maxb, dtype, n_pads=0, hq=HQ, hkv=HKV, hd=HD):
    """q, pools, block tables (each row its own blocks) and kv_valid."""
    dev = "cuda"
    nb = t_rows * maxb
    q = torch.randn((t_rows, hq, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((nb, BS, hkv, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((nb, BS, hkv, hd), generator=gen, device=dev).to(dtype)
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


def load_baseline(root: pathlib.Path, name: str):
    """The kernel wrapper ``kernels/<name>.py`` of the checkout at ``root``
    (an earlier commit, unpacked with ``git archive``), loaded beside this
    checkout's: it builds that checkout's CUDA source and counts its own
    launches, so no count of this checkout moves."""
    path = root / "src" / "repro_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# SASS opcodes counted per kernel in phase 1: the IEEE division's
# reciprocal and its slow-path check, conversions, shuffles, memory;
# global loads and stores also by width (LDG.128, STG.U8, ...: 32 when
# the opcode names none)
SASS_OPS = ("MUFU", "FCHK", "CALL", "F2FP", "F2F", "SHFL", "LDG", "STG")
SASS_WIDTHS = ("U8", "S8", "U16", "S16", "64", "128")


def sass_counts(lib: pathlib.Path):
    """{kernel: (instructions, {opcode: count for SASS_OPS, and LDG / STG
    by width})} of a built library, read from ``cuobjdump -sass`` (static
    counts: every path of the kernel's code, each instruction once)."""
    from torch.utils.cpp_extension import CUDA_HOME
    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = [0, collections.Counter()]
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)((?:\.\w+)*)", line)
        if name and ins:
            op, mods = ins.group(1), ins.group(2).split(".")
            out[name][0] += 1
            if op in SASS_OPS:
                out[name][1][op] += 1
            if op in ("LDG", "STG"):
                width = next((m for m in mods if m in SASS_WIDTHS), "32")
                out[name][1][f"{op}.{width}"] += 1
    return {k: (n, dict(c)) for k, (n, c) in out.items()}


#: template arguments in a mangled kernel name
_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32",
          "Lb1E": "true", "Lb0E": "false"}


def _short(mangled: str) -> str:
    """A K1-K5 or K7 kernel's name and template arguments, from its
    mangled name."""
    m = re.search(r"segments_kernelI\w*?\d+CopyILi(\d+)EEELi(\d+)E", mangled)
    if m:
        return f"segments_kernel<Copy<{m.group(1)}>, unroll {m.group(2)}>"
    m = re.search(r"segments_kernelI\w*?\d+(Accumulate|Bf16Pack)I(\w+?)EELi"
                  r"(\d+)E", mangled)
    if m:
        args = []
        for tok in re.findall(r"13__nv_bfloat16|6__half|S\d*_|f", m.group(2)):
            args.append(args[-1] if tok.startswith("S") else _TYPES[tok])
        return f"segments_kernel<{m.group(1)}<{', '.join(args)}>, " \
               f"unroll {m.group(3)}>"
    m = re.search(r"\d+(accum_(?:vec|scalar))I(\w+?)EEv", mangled)
    if m:
        args = [_TYPES[t] for t in re.findall(r"13__nv_bfloat16|6__half|f",
                                               m.group(2))]
        args += args[-1:] * (2 - len(args))
        return f"{m.group(1)}<{', '.join(args)}>"
    m = re.search(r"\d+((?:fp8|bf16)_\w+?_kernel)(I\w*?E)?E", mangled)
    if not m:
        return mangled
    args = [_TYPES.get(a, a[2:-1]) for a in re.findall(
        r"13__nv_bfloat16|Lb[01]E|Li\d+E|f", m.group(2) or "")]
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def phase1_card_and_build(baseline=None):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import payload_partition as pp
    sources = [fd.SOURCE, ca.SOURCE, codec.SOURCE, pp.SOURCE]
    sources += [m.SOURCE for m in (baseline or {}).values()]
    t0 = time.perf_counter()
    built = _nvcc.build_all(sources)
    build_s = time.perf_counter() - t0
    for src, (lib, log) in built.items():
        for line in log.splitlines():
            spills = "spill" in line and "0 bytes spill stores, 0 bytes " \
                "spill loads" not in line
            if spills or "registers" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
        print(f"phase 1: built {os.path.relpath(lib, ROOT)} from "
              f"{os.path.relpath(src, ROOT)}")
    sass = [("", codec.SOURCE), ("", ca.SOURCE), ("", pp.SOURCE)]
    if baseline:
        sass += [("baseline ", baseline[name].SOURCE)
                 for name in ("codec", "chunk_accumulate",
                              "payload_partition")]
    for tag, src in sass:
        for kernel, (n, ops) in sorted(sass_counts(built[src][0]).items()):
            print(f"phase 1: {tag}SASS {_short(kernel)}: {n} instructions "
                  f"(static), {ops}")
    smem = {f"{str(dt)[6:]} hd {hd}": fd.smem_bytes(dt, hd)
            for dt in (torch.float32, torch.bfloat16)
            for hd in fd.SUPPORTED_HEAD_DIMS}
    print(f"phase 1: K6 split kernel dynamic shared memory (bytes a CTA of "
          f"128 threads): {smem}")
    print(f"phase 1: card {torch.cuda.get_device_name(0)}; "
          f"{len(built)} kernels built in parallel in {build_s:.1f} s")
    return smi[0]


# (Hq, Hkv, hd) of phase 2: glm4-9b first, then GQA groups 1 (whisper,
# zamba2), 2, 4 (mixtral), 8 (deepseek, qwen2), 12 (starcoder2) and 16 at
# hd 64, kimi-k2's full width (64 heads over 8, hd 112), internvl2's (64
# heads over 8, hd 128) and glm4-9b's shard at (model=2) (16 heads over
# 1, phase 19 (d))
K6_SHAPES = [(HQ, HKV, HD), (16, 16, 64), (8, 4, 128), (32, 8, 128),
             (16, 2, 128), (24, 2, 128), (32, 2, 64), (64, 8, 112),
             (64, 8, 128), (16, 1, 128)]


def phase2_kernel_vs_plain(gen):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for hq, hkv, hd in K6_SHAPES:
        shape_errs = {}
        splits = {}
        for dtype in (torch.float32, torch.bfloat16):
            for t_rows in (1, 8, 32):
                for maxb in (6, 64, 256):
                    n_pads = 0 if t_rows == 1 else 2
                    windows = [None] + ([8 if maxb == 6 else 1000]
                                        if t_rows > 1 else [])
                    case = make_case(gen, t_rows, maxb, dtype, n_pads, hq,
                                     hkv, hd)
                    splits[t_rows, maxb] = fd.split_plan(t_rows, hkv, maxb,
                                                         BS, n_sm)[0]
                    for window in windows:
                        got = fd.paged_flash_decode_pool(*case,
                                                         window=window)
                        want = ref.paged_flash_decode_ref(*case,
                                                          window=window)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        check(err <= ATOL[dtype],
                              f"K6 {dtype} Hq={hq} Hkv={hkv} hd={hd} "
                              f"T={t_rows} maxb={maxb} window={window}: max "
                              f"err {err} > {ATOL[dtype]}")
                        if n_pads:
                            check(bool(torch.all(got[-n_pads:] == 0)),
                                  "K6 padding rows are not exact zeros")
                        check(bool(torch.all(torch.isfinite(got))),
                              "K6 output not finite")
                        errs[dtype] = max(errs[dtype], err)
                        shape_errs[dtype] = max(shape_errs.get(dtype, 0.0),
                                                err)
                    del case
        print(f"phase 2: K6 Hq {hq} Hkv {hkv} (group {hq // hkv}) hd {hd}: "
              f"max abs err f32 {shape_errs[torch.float32]:.3g}, bf16 "
              f"{shape_errs[torch.bfloat16]:.3g}; n_split by (T, maxb) "
              f"{splits}")
    print(f"phase 2: K6 vs plain version at {len(K6_SHAPES)} head shapes, "
          f"block {BS}, T {{1,8,32}} x maxb {{6,64,256}}, with padding rows "
          f"and windows: max abs err f32 {errs[torch.float32]:.3g} (atol "
          f"3e-5), bf16 {errs[torch.bfloat16]:.3g} (atol 2e-2); padding "
          f"rows exact zeros")
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


def phase4_full_width(out_dir: pathlib.Path, baseline=None):
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
    errs, gap = logits_check(cfg, params, gen, baseline)
    rec["logits_rel_l2"] = {**{f"{k} vs dense f32": v
                               for k, v in errs.items()},
                            "kernel vs dense bf16": gap}
    profile_serve(cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches, rec


# phase 4's bounds on the full-width logits' relative L2 error, each the
# value this script measured on an H100 (PERF.md, PR 16; the same to four
# digits in every run) plus a margin: kernel vs dense bf16 0.0513 (+17%),
# either bf16 path vs the float32 run 0.0585 / 0.0589 (+10%), and the
# kernel's distance from float32 over the dense bf16 path's, 0.993 (a
# kernel that drifts moves this one first)
LOGITS_KERNEL_VS_DENSE = 0.06
LOGITS_VS_FLOAT32 = 0.065
LOGITS_KERNEL_OVER_DENSE = 1.05


def _tree(fn, p):
    return {k: _tree(fn, v) for k, v in p.items()} if isinstance(p, dict) \
        else fn(p)


def logits_check(cfg, params, gen, baseline=None):
    """One full-width packed step (2 requests, 32 rows) on the same pool
    contents: with the kernel, with the dense-gather reference path, and
    with the dense path on the same params upcast to float32 (TF32 off).
    Finite logits of the expected shape; the kernel path near the dense
    bf16 path, and each bf16 path's relative L2 error against the float32
    run printed and bounded, so a drift of the kernel shows as its own
    distance from float32.  With ``baseline``, the same step through the
    earlier checkout's K6 too."""
    import dataclasses
    from repro_torch.kernels import ops
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

    def step(impl, p, c, fd=None):
        pcfg = PagedConfig(block_size=BS, n_blocks=12, max_blocks_per_req=6,
                           attn_impl=impl)
        pool = init_paged_pool(c, ctx, pcfg, device=dev)
        saved = ops._fd
        ops._fd = fd or saved
        try:
            logits, _ = paged_decode_step(p, pool, tokens, positions, rows,
                                          tables, sample, c, ctx, pcfg)
        finally:
            ops._fd = saved
        return logits.float()

    out = {"kernel": step("kernel", params, cfg),
           "dense bf16": step("reference", params, cfg)}
    if baseline:
        before = baseline["flash_decode"].launch_count
        out["baseline kernel"] = step("kernel", params, cfg,
                                      baseline["flash_decode"])
        check(baseline["flash_decode"].launch_count == before + cfg.n_layers,
              "the baseline K6 did not run the step")
    params32 = _tree(lambda t: t.float(), params)
    out["dense f32"] = step("reference", params32,
                            dataclasses.replace(cfg, param_dtype="float32"))
    del params32
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((out[a] - out[b]).norm() / out[b].norm()).item()

    k = out["kernel"]
    check(k.shape == (2, cfg.vocab_padded), f"logits shape {k.shape}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "full-width logits not finite")
    errs = {name: rel(name, "dense f32") for name in out
            if name != "dense f32"}
    gap = rel("kernel", "dense bf16")
    print(f"phase 4: full-width logits [2, {cfg.vocab_padded}] finite; "
          f"relative L2 error against the dense float32 run: "
          + ", ".join(f"{n} {e:.4g}" for n, e in errs.items())
          + f"; kernel vs dense bf16 {gap:.4g}"
          + (f", baseline kernel vs dense bf16 "
             f"{rel('baseline kernel', 'dense bf16'):.4g}"
             if baseline else ""))
    check(gap < LOGITS_KERNEL_VS_DENSE, f"full-width logits kernel vs dense "
          f"bf16 rel err {gap} >= {LOGITS_KERNEL_VS_DENSE}")
    for name in ("kernel", "dense bf16"):
        check(errs[name] < LOGITS_VS_FLOAT32, f"full-width logits {name} vs "
              f"dense float32 rel err {errs[name]} >= {LOGITS_VS_FLOAT32}")
    ratio = errs["kernel"] / errs["dense bf16"]
    check(ratio <= LOGITS_KERNEL_OVER_DENSE, f"the kernel path is {ratio:.3f}"
          f" times as far from float32 as the dense bf16 path, above "
          f"{LOGITS_KERNEL_OVER_DENSE}")
    print(f"phase 4: kernel vs dense bf16 < {LOGITS_KERNEL_VS_DENSE}; "
          f"kernel and dense bf16 vs dense float32 < {LOGITS_VS_FLOAT32}; "
          f"kernel's distance from float32 {ratio:.3f} x the dense bf16 "
          f"path's (<= {LOGITS_KERNEL_OVER_DENSE})")
    return errs, gap


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
    k6 = [e for e in kernels if "fd_split_kernel" in e.key
          or "fd_merge_kernel" in e.key]
    k6_ms = sum(dev_us(e) for e in k6) / 1e3
    print(f"phase 4: K6 in the profiled drain: {k6_ms:.3f} ms of device "
          f"time over {sum(e.count for e in k6)} launches, "
          f"{k6_ms / steps:.3f} ms a packed step ({k6_ms / busy_ms:.1%} of "
          f"the device's busy time)")
    host = [e for e in avgs if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"  host self {e.self_cpu_time_total / 1e3:9.2f} ms  "
              f"x{e.count:<6d} {e.key[:100]}")


def _dense_kv(case, expand):
    """SDPA's operands for one K6 case: q [T, Hq, 1, hd], the K/V of each
    row's blocks gathered dense ([T, H, S, hd], H = Hq if ``expand`` else
    Hkv) and the kv_valid mask."""
    q, kp, vp, tables, kv_valid = case
    t_rows, maxb = tables.shape
    flat = (tables[:, :, None].long() * BS +
            torch.arange(BS, device="cuda")).reshape(t_rows, maxb * BS)
    kd = kp.reshape(-1, HKV, HD)[flat].permute(0, 2, 1, 3)
    vd = vp.reshape(-1, HKV, HD)[flat].permute(0, 2, 1, 3)
    if expand:
        kd = kd.repeat_interleave(HQ // HKV, dim=1)
        vd = vd.repeat_interleave(HQ // HKV, dim=1)
    mask = (torch.arange(maxb * BS, device="cuda")[None, :]
            < kv_valid[:, None])[:, None, None, :]
    return q[:, :, None, :], kd.contiguous(), vd.contiguous(), mask


def phase5_times(card):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    key, (mem_bps, bf16_flops) = card_peaks(card)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for maxb in (6, 256, 1024):
        base = make_case(gen, 32, maxb, torch.bfloat16)
        q, kp, vp, tables, kv_valid = base
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
        # every timed call on its own copy of the same inputs
        k = rotations(nbytes)
        cases = [base] + [tuple(x.clone() for x in base)
                          for _ in range(k - 1)]
        n_split = fd.split_plan(32, HKV, maxb, BS, n_sm)[0]
        before = fd.launch_count
        ms = time_ms(lambda i: fd.paged_flash_decode_pool(*cases[i]),
                     sets=k)
        warm_ms = time_ms(lambda: fd.paged_flash_decode_pool(*base))
        want = ref.paged_flash_decode_ref(*base).float()
        fd.launch_count = before    # timing launches are not the path's
        plain_ms = time_ms(lambda i: ref.paged_flash_decode_ref(*cases[i]),
                           sets=k)
        # the library yardsticks: SDPA over the gathered dense K/V with the
        # kv_valid mask (gather and head expansion outside the timing),
        # head-expanded, and unexpanded with enable_gqa where this torch
        # takes it with a mask
        lib = {}
        for name, expand, extra in (("SDPA", True, {}),
                                    ("SDPA enable_gqa", False,
                                     {"enable_gqa": True})):
            try:
                dense = [_dense_kv(c, expand) for c in cases]
                got = F.scaled_dot_product_attention(
                    *dense[0][:3], attn_mask=dense[0][3], **extra)
            except (RuntimeError, TypeError) as exc:
                print(f"phase 5: {name} not taken by torch "
                      f"{torch.__version__}: {str(exc)[:120]}")
                continue
            err = (got[:, :, 0].float() - want).abs().max().item()
            check(err <= ATOL[torch.bfloat16],
                  f"{name} yardstick off the plain version by {err}")
            lib[name] = time_ms(
                lambda i: F.scaled_dot_product_attention(
                    *dense[i][:3], attn_mask=dense[i][3], **extra), sets=k)
            del dense, got
            torch.cuda.empty_cache()
        lib_name = min(lib, key=lib.get)
        # what a plain streaming kernel reaches on as many bytes
        flat = [torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
                for _ in range(k)]
        stream_ms = time_ms(lambda i: flat[i].sum(dtype=torch.float32),
                            sets=k)
        del flat
        rows[maxb] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib[lib_name],
                          library_call=lib_name, library_all=lib,
                          ms_l2_warm=warm_ms, stream_ms=stream_ms,
                          bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                          flops=flops, n_split=n_split, copies=k)
        print(f"phase 5: K6 bf16 T=32 maxb={maxb} ({n_pos} cached positions,"
              f" n_split {n_split}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in lib.items())
              + f", bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
              f"{mem_bps / 1e12:.2f} TB/s, {flops} flop at "
              f"{bf16_flops / 1e12:.0f} TFLOP/s: {key} datasheet); "
              f"{bound_ms / ms:.1%} of bound; operands rotated over {k} "
              f"copies, out of L2 (L2-warm, as PRs 11-14 timed it: "
              f"{warm_ms:.4f} ms); a streaming read of {nbytes} B "
              f"(torch.sum) {stream_ms:.4f} ms, {bound_ms / stream_ms:.1%} "
              f"of bound")
        del cases
        torch.cuda.empty_cache()
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
    stats = {}
    for da, db in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float16, torch.float16),
                   (torch.float32, torch.bfloat16)):
        for lengths in K1_TABLES:
            for offsets in SEG_OFFSETS:
                _check_segments("k1", lengths, (da, db), offsets, gen,
                                stats, "phase 6")
    for dtype in (torch.float32, torch.bfloat16):
        for lengths in K1_TABLES:
            for offsets in SEG_OFFSETS:
                _check_segments("bf16_pack", lengths, (dtype,), offsets, gen,
                                stats, "phase 6")
    torch.cuda.empty_cache()
    for dtype in errs:
        errs[dtype] = max(errs[dtype], stats.get(("k1", dtype), 0.0))
    print(f"phase 6: K1 and K5 segment tables (one launch each) vs plain "
          f"versions pair by pair at {len(K1_TABLES)} tables "
          f"{[len(t) for t in K1_TABLES]} segments, lengths up to "
          f"{max(max(t) for t in K1_TABLES)}, f32/bf16/f16/f32+bf16 (K1) "
          f"and f32/bf16 (K5), every segment aligned, one off, or every "
          f"other one off: bit for bit, NaN at the same places (max abs err "
          f"{_stats_text(stats)})")
    return errs


def _stats_text(stats) -> str:
    """``_same_bits`` stats keyed (kernel, dtype), as text."""
    return ", ".join(f"{k} {str(d)[6:]} {v}" for key, v in stats.items()
                     if key != "nan_bits" for k, d in [key]) + \
        f"; NaNs with other bits {stats.get('nan_bits', {})}"


#: segment tables of phase 6: lengths around the units (8 elements of a
#: bf16/f16 or mixed unit, 4 of f32), the ring's sub-chunk lengths and a
#: long table that takes the long body
K1_TABLES = ((1,), (1000, 7), (131072, 131072), (4096, 1, 8191),
             (9, 8, 7, 16, 15, 17, 131071, 1 << 20), ((1 << 25) + 3,))
#: per segment, how many elements its operands sit past 16-byte
#: alignment: none (vector path), one (scalar path), or every other one
SEG_OFFSETS = {"aligned": lambda j: 0, "off1": lambda j: 1,
               "mixed": lambda j: j % 2}


def _check_segments(kernel, lengths, dtypes, offsets, gen, stats, where):
    """One segment-table launch of K1 (``kernel`` "k1", operand dtypes
    ``dtypes`` = (a, b)) or K5 ("bf16_pack", input dtype ``dtypes[0]``)
    on operands made for ``lengths``, each shifted by SEG_OFFSETS[offsets]
    elements, NaN and inf included: bit for bit with the plain version
    segment by segment, NaN at the same places.  Adds the max abs error to
    ``stats[kernel, dtypes[0]]``; checks that it launched once and that
    each segment took the vector path exactly when its pointers are
    16-byte aligned."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, ref
    shift = SEG_OFFSETS[offsets]
    ins = [[] for _ in dtypes]
    for j, n in enumerate(lengths):
        k = shift(j)
        for col, dt in zip(ins, dtypes):
            x = _codec_input(n + 1, torch.float32, gen,
                             special=col is ins[0]).to(dt)
            col.append(x[k:k + n])
    mod = ca if kernel == "k1" else codec
    counts = ca.launch_count if kernel == "k1" else codec.launch_count
    key = tuple(dtypes) if kernel == "k1" else "bf16_pack"
    launches, paths = counts[key], collections.Counter(mod.segment_paths)
    if kernel == "k1":
        got = ca.chunk_accumulate_segments(*ins)
        want = [ref.chunk_accumulate_ref(a, b) for a, b in zip(*ins)]
    else:
        got = codec.bf16_pack_segments(ins[0])
        want = [ref.bf16_pack_ref(x) for x in ins[0]]
    torch.cuda.synchronize()
    tag = (f"{kernel} segments {lengths} {[str(d)[6:] for d in dtypes]} "
           f"{offsets} ({where})")
    check(counts[key] == launches + 1, f"{tag}: launched "
          f"{counts[key] - launches} times, not once")
    vec = sum(all(t.data_ptr() % 16 == 0 for t in (g, *xs))
              for g, *xs in zip(got, *ins))
    check(mod.segment_paths - paths == collections.Counter(
        {"vector": vec, "scalar": len(lengths) - vec}),
        f"{tag}: segment paths {mod.segment_paths - paths}, the pointers "
        f"say {vec} vector")
    for g, w in zip(got, want):
        _same_bits(g, w, tag, (kernel, dtypes[0]), stats)
    return got


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
    """One rank of phase 7; returns digests, wall times, plans, counts and
    the K1 calls the runs made (``recorded_calls``)."""
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
    _kernel_counts(reset=True)
    out = {"wire": mesh_a.wire, "digest": {}, "wall_s": {}, "plans": {},
           "want_k1": 0, "calls": set()}

    def run(name, fn, plan, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_calls(out["calls"]):
            y = fn()
        torch.cuda.synchronize()
        out["wall_s"][name] = time.perf_counter() - t0
        out["plans"][name] = (plan.chunk_units, plan.staged_substeps)
        if (plan.collective in (Collective.ALL_REDUCE,
                                Collective.REDUCE_SCATTER)
                and "staged" in plan.paths):
            # one launch a ring step, over all its sub-chunks
            out["want_k1"] += n - 1
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
    out["segment_paths"] = _segment_paths()
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
    paths = sum((collections.Counter(r["segment_paths"]) for r in res),
                collections.Counter())
    print(f"phase 7: (c) K1 run bit-identical to the plain-accumulate run "
          f"on all ranks; plan_signature equal on all ranks; K1 launches "
          f"{launches} over 4 ranks = (n-1) a staged reduce (one launch a "
          f"ring step over its sub-chunks); K1 segments by path "
          f"{ {k: v for k, v in paths.items() if k.startswith('k1')} }")
    return launches, res[0]["plans"], set().union(*(r["calls"] for r in res))


def ring_step_times(kernel, lengths, dtypes, gen, card, per_sub=None):
    """One ring step of K1 (``kernel`` "k1", operands ``dtypes`` = (a, b))
    or K5 ("bf16_pack", input ``dtypes[0]``) over sub-chunks of
    ``lengths``, timed as the segment-table launch of this checkout
    against one launch a sub-chunk (``per_sub``: an earlier checkout's
    single-pair wrapper from ``--baseline``, else this checkout's), in
    turns per-sub-chunk, fused, fused, per-sub-chunk, on operand copies
    rotated out of L2.  The operands lie as the ring's do: K1's received
    sub-chunks in buffers of their own and its local ones views of one
    chunk; K5's views of one buffer.  Launch counts are left as they
    were."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec
    key, (mem_bps, _) = card_peaks(card)
    saved = [collections.Counter(ca.launch_count), dict(codec.launch_count),
             collections.Counter(ca.segment_paths),
             collections.Counter(codec.segment_paths)]
    total = sum(lengths)
    size = [torch.finfo(d).bits // 8 for d in dtypes]
    if kernel == "k1":
        nbytes, flops = total * (2 * size[0] + size[1]), total
    else:
        nbytes, flops = total * (size[0] + 2), total
    k = rotations(nbytes)

    def chunk(dt):
        flat = torch.randn(total, generator=gen, device="cuda").to(dt)
        return list(flat.split(list(lengths)))

    if kernel == "k1":
        a = [[torch.randn(n, generator=gen, device="cuda").to(dtypes[0])
              for n in lengths] for _ in range(k)]
        b = [chunk(dtypes[1]) for _ in range(k)]
        one = per_sub or ca.chunk_accumulate
        fused = lambda i: ca.chunk_accumulate_segments(a[i], b[i])  # noqa
        per = lambda i: [one(x, y) for x, y in zip(a[i], b[i])]  # noqa
    else:
        x = [chunk(dtypes[0]) for _ in range(k)]
        one = per_sub or codec.bf16_pack
        fused = lambda i: codec.bf16_pack_segments(x[i])  # noqa: E731
        per = lambda i: [one(t) for t in x[i]]  # noqa: E731
    turns = [time_ms(per, sets=k), time_ms(fused, sets=k),
             time_ms(fused, sets=k), time_ms(per, sets=k)]
    ca.launch_count.clear()
    ca.launch_count.update(saved[0])
    codec.launch_count.update(saved[1])
    for counts, old in ((ca.segment_paths, saved[2]),
                        (codec.segment_paths, saved[3])):
        counts.clear()
        counts.update(old)
    b_s, f_s = nbytes / mem_bps, flops / F32_FLOPS
    ms, per_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    return dict(lengths=list(lengths), ms=ms, per_sub_ms=per_ms,
                per_sub_from="--baseline" if per_sub else "this checkout",
                turns=turns, bound_ms=max(b_s, f_s) * 1e3,
                bound_by="bytes" if b_s >= f_s else "operations",
                rotations=k, bytes=nbytes)


def _ring_step_line(phase, what, row, card):
    key, (mem_bps, _) = card_peaks(card)
    print(f"phase {phase}: {what}, one ring step of {len(row['lengths'])} "
          f"sub-chunks {row['lengths'][:2]}{'...' if len(row['lengths']) > 2 else ''}: "
          f"one segment-table launch {row['ms']:.4f} ms "
          f"({row['bound_ms'] / row['ms']:.1%} of bound), one launch a "
          f"sub-chunk ({row['per_sub_from']}) {row['per_sub_ms']:.4f} ms "
          f"({row['per_sub_ms'] / row['ms']:.2f}x); turns per-sub/fused/"
          f"fused/per-sub " + "/".join(f"{t:.4f}" for t in row["turns"])
          + f"; bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
          f"({row['bytes']} B at {mem_bps / 1e12:.2f} TB/s: {key} "
          f"datasheet); operands rotated over {row['rotations']} copies")


def phase8_k1_times(card, plans, baseline=None):
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import ref
    key, (mem_bps, _) = card_peaks(card)
    units, substeps = plans["b_all_reduce"]
    staged = dict(units).get("staged", 0)
    check(staged > 0, f"the 1 GiB plan {units} has no staged share")
    # the staged segment of (b), its per-rank ring chunk, one sub-chunk
    sub = B_NUMEL * staged // 16 // 4 // substeps
    gen = torch.Generator(device="cuda").manual_seed(8)
    base = (baseline or {}).get("chunk_accumulate")
    rows = {}
    for name, n in (("b_substep", sub), ("chunk_64MiB", 32 * MiB)):
        nbytes = 3 * n * 2
        k = rotations(nbytes)
        a = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(k)]
        b = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(k)]
        before = collections.Counter(ca.launch_count)
        kern = lambda i: ca.chunk_accumulate(a[i], b[i])  # noqa: E731
        turns = None
        if base:
            # the earlier K1 in turns: earlier, this, this, earlier
            old = lambda i: base.chunk_accumulate(a[i], b[i])  # noqa: E731
            turns = [time_ms(old, sets=k), time_ms(kern, sets=k),
                     time_ms(kern, sets=k), time_ms(old, sets=k)]
            ms = (turns[1] + turns[2]) / 2
        else:
            ms = time_ms(kern, sets=k)
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
        old_txt = ""
        if turns:
            old_ms = (turns[0] + turns[3]) / 2
            rows[name].update(baseline_ms=old_ms, turns=turns)
            old_txt = (f", baseline kernel {old_ms:.4f} ms (turns baseline/"
                       f"this/this/baseline "
                       + "/".join(f"{t:.4f}" for t in turns) + ")")
        print(f"phase 8: K1 bf16 n={n} ({name}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, a + b {lib_ms:.4f} ms{old_txt}, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
              f"{mem_bps / 1e12:.2f} TB/s: {key} datasheet); "
              f"{bound_ms / ms:.1%} of bound; operands rotated over {k} "
              f"copies, out of L2")
    rows["ring_step"] = ring_step_times(
        "k1", (sub,) * substeps, (torch.bfloat16, torch.bfloat16), gen,
        card, base.chunk_accumulate if base else None)
    _ring_step_line(8, "K1 bf16 (the staged reduce of phase 7 (b))",
                    rows["ring_step"], card)
    return rows


# -- the wire codecs and the data-parallel train step (phases 9-12) -----------

CODEC_LENGTHS = (1, 127, 1000, (1 << 20) + 7, 1 << 26)
FMTS = ("fp8_e4m3", "fp8_e5m2")


def _codec_input(n, dtype, gen, special):
    """Random values whose 128-element groups span 10 decades; with
    ``special``, a NaN in group 0, group 1 all signed zeros, an inf in
    group 2 and a -inf last."""
    x = torch.randn(n, generator=gen, device="cuda")
    groups = -(-n // 128)
    mag = torch.exp(torch.empty(groups, device="cuda").uniform_(
        -12, 12, generator=gen))
    x *= mag.repeat_interleave(128)[:n]
    if special:
        x[min(5, n - 1)] = float("nan")
        if n > 2 * 128 + 7:
            x[128:256] = torch.tensor([0.0, -0.0] * 64, device="cuda")
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
    axis of these runs has 2).  A staged all-reduce runs n - 1
    reduce-scatter steps and packs the all-gather's source once; with s
    sub-chunks the fp8 codecs launch once a sub-chunk (K2 n x s, K3
    (n-1) x s, K4 n x s gathered rows), while K1 and K5 launch once a
    ring step over all its sub-chunks (K1 n - 1, K5 n); an ortho detour
    encodes and decodes twice.  bf16_pack decodes by a cast, and its
    decode-accumulate is K1 (mixed for a float32 payload)."""
    c = collections.Counter()
    s, op = plan.staged_substeps, plan.collective.value
    for path in plan.paths:
        if path == "primary":
            continue
        if path == "staged":
            # (reduce steps, all-gather sources, gathered rows), a2a's
            # rotations counted as steps without a reduce
            steps, src, rows = {"all_reduce": (n - 1, 1, n),
                                "reduce_scatter": (n - 1, 0, 0),
                                "all_gather": (0, 1, n),
                                "all_to_all": (0, 0, 0)}[op]
            a2a = n - 1 if op == "all_to_all" else 0
            enc, dec, acc = (steps + src) * s + a2a, rows * s + a2a, steps * s
            step_enc, step_acc = steps + src + a2a, steps
        else:
            enc, dec, acc = 2, 2, 0
            step_enc, step_acc = 2, 0
        codec = plan.codec_for(path)
        if codec == "bf16_pack":
            c["bf16_pack"] += step_enc
            c["k1_mixed" if dtype == torch.float32 else "k1"] += step_acc
        elif codec:
            c["fp8_encode"] += enc
            c["fp8_decode"] += dec
            c["fp8_decode_accumulate"] += acc
        elif dtype.is_floating_point and torch.finfo(dtype).bits < 32:
            c["k1"] += step_acc
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
        ca.segment_paths.clear()
        codec.segment_paths.clear()
    mixed = ca.launch_count[ca.MIXED]
    return collections.Counter({**codec.launch_count, "k1_mixed": mixed,
                                "k1": sum(ca.launch_count.values()) - mixed,
                                "k7a": pp.launch_count["extract"],
                                "k7b": pp.launch_count["merge"]})


def _segment_paths():
    """This process's segments of K1 and K5 segment-table launches by
    the path they took (set to 0 by ``_kernel_counts(reset=True)``)."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec
    return {f"{k} {path}": counts[path]
            for k, counts in (("k1", ca.segment_paths),
                              ("k5", codec.segment_paths))
            for path in ("vector", "scalar")}


def vector_path(name: str, args) -> bool:
    """Whether the K2-K4 wrapper call ``name(*args)`` takes its kernel's
    16-byte vector path (csrc/codec.cu): its input operands 16-byte
    aligned (outputs are the wrapper's own) and at least one vector unit
    long (a 128-group for K2; for K3 and K4 the values of one 16-byte
    store of output, 8 bf16 or 4 float32)."""
    if name == "fp8_encode":
        inputs, unit = args[:1], 128
    elif name == "fp8_decode":
        out = args[3] if len(args) > 3 else torch.float32
        inputs, unit = args[:1], 16 // out.itemsize
    else:
        inputs, unit = (args[0], args[2]), 16 // args[2].element_size()
    return (args[0].numel() >= unit
            and all(t.data_ptr() % 16 == 0 for t in inputs))


@contextlib.contextmanager
def recorded_calls(seen: set, paths=None):
    """Within the block, every call of a K1-K5 wrapper adds what its
    kernel was given to ``seen``: (kernel, length, dtype, fp8 format),
    the dtype being the payload's (the input of K2 and K5, the output of
    K3 and K4, the float32 operand of the mixed K1).  A segment-table call
    of K1 or K5 adds ("k1_segments", "k1_mixed_segments" or
    "bf16_pack_segments", the tuple of its segments' lengths, dtype,
    None).  With ``paths`` (a Counter), each K2-K4 call also adds one to
    (kernel, "vector" or "scalar"), the path it takes.  The wrappers and
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
    k1, k1_seg = ca.chunk_accumulate, ca.chunk_accumulate_segments
    k5_seg = codec.bf16_pack_segments

    def wrap(name, fn):
        def call(*args):
            seen.add((name, *keys[name](*args)))
            if paths is not None and name != "bf16_pack":
                paths[name, "vector" if vector_path(name, args)
                      else "scalar"] += 1
            return fn(*args)
        return call

    def k1_call(a, b):
        seen.add(("k1_mixed" if a.dtype != b.dtype else "k1", a.numel(),
                  a.dtype, None))
        return k1(a, b)

    def k1_seg_call(as_, bs):
        seen.add(("k1_mixed_segments" if as_[0].dtype != bs[0].dtype
                  else "k1_segments", tuple(a.numel() for a in as_),
                  as_[0].dtype, None))
        return k1_seg(as_, bs)

    def k5_seg_call(xs):
        seen.add(("bf16_pack_segments", tuple(x.numel() for x in xs),
                  xs[0].dtype, None))
        return k5_seg(xs)

    for name, fn in originals.items():
        setattr(codec, name, wrap(name, fn))
    ca.chunk_accumulate, ca.chunk_accumulate_segments = k1_call, k1_seg_call
    codec.bf16_pack_segments = k5_seg_call
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(codec, name, fn)
        ca.chunk_accumulate, ca.chunk_accumulate_segments = k1, k1_seg
        codec.bf16_pack_segments = k5_seg


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
        seg_paths = _segment_paths()
        plain = routing.execute(plan, x.cpu(), cpu_mesh)
        check(_kernel_counts() == launches, "the CPU run launched kernels")
        rec = {"plan": (plan.chunk_units, plan.path_codecs,
                        plan.staged_substeps),
               "wall_s": wall, "digest": _digest(y),
               "equal_plain": bool(torch.equal(_bits(y.cpu()),
                                               _bits(plain))),
               "launches": dict(launches), "calls": seen,
               "segment_paths": seg_paths,
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
              f"plan's (K1 and K5 segments by path, rank 0: "
              f"{ {k: v for k, v in rec['segment_paths'].items() if v} }); "
              f"wall {max(g[name]['wall_s'] for g in res):.3f} s "
              f"({WALL_NOTE})")
    return launches, calls


# phase 11: full-width glm4-9b with its depth cut to TRAIN_LAYERS.  The
# learning rate is one a 4096-wide model takes in its first steps: the
# launcher's 1e-3 (sized for the reduced config) sends this model's loss
# up, from 12.7 to 18.1 in one step, on this card
TRAIN_LAYERS = 2
#: steps of every training run of phases 11, 13 and 16-18 (3 until the pod
#: tier's phase 22 needed the time; one update already drops glm4-9b's
#: loss from 12.7 to 9.4)
TRAIN_STEPS = 2
TRAIN_LR = 1e-4
#: (name, comm config, bucket_mb): the monolithic runs, then the same
#: model's gradient sync in 64 MiB buckets launched from the backward,
#: uncompressed and under fp8 with error-feedback residuals
TRAIN_RUNS = (("nccl", {"backend": "nccl"}, 0),
              ("flexlink", {}, 0),
              ("fp8", {"compress": "secondary=fp8"}, 0),
              ("flexlink-b64", {}, 64),
              ("fp8-b64-ef", {"compress": "secondary=fp8"}, 64))
LM_HEAD_NUMEL = 4096 * 151552
#: buckets a step of the 64 MiB runs (GradBucketer at full width, depth
#: 2: 3146 MiB of bf16 gradients) and, under fp8, those whose slots attach
#: the codec on the h100 profile at dp = 2 (all but one 8 MiB bucket)
TRAIN_BUCKETS, TRAIN_EF_BUCKETS = 47, 46


@contextlib.contextmanager
def bucket_probe(ctx, log: list, roundtrips: collections.Counter):
    """Within the block, every bucket reduce of ``ctx``'s step adds (its
    issue scope's recorder name, whether it runs on the ctx's side
    stream, the step phase) to ``log``, and every error-feedback
    roundtrip adds one to ``roundtrips["ef"]``; both only look."""
    from repro_torch.kernels import ops
    reduce, roundtrip = ctx.grad_all_reduce, ops.wire_roundtrip

    def logged_reduce(x):
        log.append((ctx.comms()[-1]._active_name,
                    torch.cuda.current_stream() == ctx.side_stream,
                    _step_phase()))
        return reduce(x)

    def counted_roundtrip(x, **kw):
        roundtrips["ef"] += 1
        return roundtrip(x, **kw)

    ctx.grad_all_reduce = logged_reduce
    ops.wire_roundtrip = counted_roundtrip
    try:
        yield
    finally:
        del ctx.grad_all_reduce
        ops.wire_roundtrip = roundtrip


def check_buckets(name, rec, n_buckets, n_ef, steps):
    """A bucketed run's issue log, plan and error-feedback counts, as one
    rank reported them (``train_rank`` / ``tp_train_rank``)."""
    tags = [f"{name}/g{k}" for k in range(n_buckets)]
    check(rec["plan_tags"] == [t.split("/")[1] for t in tags],
          f"{name}: GradBucketer plan {rec['plan_tags']}, want "
          f"{n_buckets} buckets g0..")
    check([t for t, _, _ in rec["bucket_log"]] == tags * steps,
          f"{name}: buckets issued {[t for t, _, _ in rec['bucket_log']]}, "
          f"want {tags} each step")
    check(all(side for _, side, _ in rec["bucket_log"]),
          f"{name}: a bucket ran off the ctx's side stream")
    check({ph for _, _, ph in rec["bucket_log"]} == {"backward"},
          f"{name}: buckets issued outside the backward: "
          f"{ {ph for _, _, ph in rec['bucket_log']} }")
    check(rec["ef_buckets"] == n_ef and rec["roundtrips"] == n_ef * steps,
          f"{name}: {rec['ef_buckets']} error-feedback buckets, "
          f"{rec['roundtrips']} roundtrips; want {n_ef} a step")
    if n_ef:
        check(rec["residual_max"] > 0, f"{name}: residuals stayed 0")


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
        for name, comm, bucket_mb in TRAIN_RUNS:
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = init_params(cfg, gen, "cuda")
            opt_state = init_state(params)
            program, ctx = build_train_program(
                cfg, mesh, comm=CommConfig(profile="h100", **comm),
                opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                total_steps=TRAIN_STEPS), name=name,
                bucket_mb=bucket_mb)
            opt_state = bucketed_opt_state(ctx, bucket_mb, params,
                                           opt_state)
            batches = make_batches(cfg, seq_len=128, batch_per_shard=8)
            calls.clear()
            seen, paths = set(), collections.Counter()
            log, roundtrips = [], collections.Counter()
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with recorded_calls(seen, paths), \
                    bucket_probe(ctx, log, roundtrips):
                params, opt_state, hist = run_loop(
                    program, params, opt_state, batches, ctx,
                    LoopConfig(total_steps=TRAIN_STEPS, log_every=0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            seg_paths = _segment_paths()
            program.close()
            want = collections.Counter()
            for plan, n, dtype, _ in calls:
                want += codec_launches(plan, n, dtype)
            # each error-feedback bucket's roundtrip: one K2, one K4
            want += collections.Counter(fp8_encode=roundtrips["ef"],
                                        fp8_decode=roundtrips["ef"])
            plans = sorted({(p.collective.value, numel, p.chunk_units,
                             p.path_codecs, p.staged_substeps)
                            for p, _, _, numel in calls if p.path_codecs})
            out[name] = {"losses": hist, "wall_s": wall,
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30,
                         "launches": dict(launches), "want": dict(want),
                         "calls": len(calls), "codec_plans": plans,
                         "kernel_calls": seen, "paths": dict(paths),
                         "segment_paths": seg_paths,
                         **bucket_record(ctx, bucket_mb, params, opt_state,
                                         log, roundtrips)}
            del params, opt_state, program, ctx
            torch.cuda.empty_cache()
    finally:
        routing.execute = execute
    return out


def bucketed_opt_state(ctx, bucket_mb, params, opt_state):
    """The opt state a run starts from: under bucketed sync with a lossy
    codec, paired with zero error-feedback residuals (as the launcher
    does)."""
    from repro_torch.train.train_step import ef_init_residuals
    if bucket_mb > 0 and ctx.ef_codec_name():
        return opt_state, ef_init_residuals(params)
    return opt_state


def bucket_record(ctx, bucket_mb, params, opt_state, log, roundtrips):
    """What a bucketed run's checks read: a GradBucketer built here from
    the params (its tags, and how many of its buckets the ctx's slots
    give a lossy codec), the issue log, the roundtrips, the residuals'
    max."""
    if not bucket_mb:
        return {}
    from torch.utils import _pytree as pytree
    from repro_torch.train.bucketer import GradBucketer
    plan = GradBucketer(params, bucket_mb=bucket_mb)
    codec = ctx.ef_codec_name()
    residuals = pytree.tree_leaves(opt_state[1]) if codec else []
    return {"plan_tags": [d["tag"] for d in plan.describe()],
            "ef_buckets": sum(GradBucketer._ef_applies(ctx, b, codec)
                              for b in plan.buckets) if codec else 0,
            "bucket_log": log, "roundtrips": roundtrips["ef"],
            "residual_max": max((float(r.abs().max()) for r in residuals),
                                default=0.0)}


def phase11_training():
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    # two full-width training ranks share the card with this process
    print(f"phase 11: this process holds "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card "
          f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved)")
    t0 = time.perf_counter()
    res = run_ranks(train_rank, 2, backend="gloo", device="cuda",
                    timeout_s=900)
    print(f"phase 11: full-width glm4-9b (d_model 4096, d_ff 13696, vocab "
          f"151552, 32/2 heads; depth cut 40 -> {TRAIN_LAYERS}), bf16, "
          f"seed 0, seq 128, global batch 8, AdamW lr {TRAIN_LR}, 2 gloo "
          f"ranks on one card; "
          f"ranks ran {time.perf_counter() - t0:.1f} s")
    losses = {}
    for name, _, bucket_mb in TRAIN_RUNS:
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
                  f"step's plans (and error-feedback roundtrips) imply "
                  f"{got[name]['want']}")
            if bucket_mb:
                check_buckets(name, got[name], TRAIN_BUCKETS,
                              TRAIN_EF_BUCKETS if "ef" in name else 0,
                              TRAIN_STEPS)
        losses[name] = hist[0]
        rec = res[0][name]
        buckets = (f"{len(rec['plan_tags'])} buckets of {bucket_mb} MiB a "
                   f"step, issued g0.. in order from the backward on the "
                   f"ctx's side stream, {rec['ef_buckets']} with an "
                   f"error-feedback roundtrip (residual max "
                   f"{max(r[name]['residual_max'] for r in res):.3g}); "
                   if bucket_mb else "")
        print(f"phase 11: {name}: losses {hist[0]}; {buckets}"
              f"{rec['calls']} collective calls; launches a rank "
              f"{rec['launches']} (K1 and K5 segments by path: "
              f"{ {k: v for k, v in rec['segment_paths'].items() if v} }); "
              f"{max(r[name]['wall_s'] for r in res):.1f} s for "
              f"{TRAIN_STEPS} steps; peak "
              f"{max(r[name]['peak_gib'] for r in res):.2f} GiB a rank")
    for i in range(TRAIN_STEPS):
        for name in ("flexlink", "flexlink-b64"):
            d = abs(losses[name][i] - losses["nccl"][i])
            check(d < 5e-3, f"step {i}: {name} {losses[name][i]} vs "
                  f"nccl {losses['nccl'][i]}")
        lim = 0.05 * max(abs(losses["nccl"][i]), 1.0)
        for name in ("fp8", "fp8-b64-ef"):
            check(abs(losses[name][i] - losses["nccl"][i]) <= lim,
                  f"step {i}: {name} {losses[name][i]} vs nccl "
                  f"{losses['nccl'][i]} beyond {lim}")
    plans = res[0]["fp8"]["codec_plans"]
    check(any(p[1] == LM_HEAD_NUMEL for p in plans),
          f"the lm_head all-reduce carries no codec: {plans}")
    for op, numel, units, codecs, sub in plans:
        print(f"phase 11: fp8 codec plan: {op} of {numel} elements: units "
              f"{units}, codecs {codecs}, substeps {sub}")
    launches = {name: sum((collections.Counter(r[name]["launches"])
                           for r in res), collections.Counter())
                for name, _, _ in TRAIN_RUNS}
    print(f"phase 11: flexlink and flexlink-b64 within 5e-3 of nccl a "
          f"step, fp8 and fp8-b64-ef within 0.05 max(|loss|, 1); launches "
          f"over 2 ranks, each the sum over the steps' plans (and one K2 "
          f"and one K4 an error-feedback bucket): "
          + ", ".join(f"{name} {dict(launches[name])}"
                      for name, _, _ in TRAIN_RUNS[1:]))
    print(f"phase 11: wall time for {TRAIN_STEPS} steps, the slower rank "
          f"({WALL_NOTE}; no overlap is claimed): "
          + ", ".join(f"{name} {max(r[name]['wall_s'] for r in res):.2f} s"
                      for name, _, _ in TRAIN_RUNS))
    paths = sum((collections.Counter(r["fp8"]["paths"]) for r in res),
                collections.Counter())
    print("phase 11: fp8 run, K2-K4 calls by codec.cu path over 2 ranks: "
          + ", ".join(f"{name} {paths[name, 'vector']} vector / "
                      f"{paths[name, 'scalar']} scalar"
                      for name in ("fp8_encode", "fp8_decode_accumulate",
                                   "fp8_decode")))
    calls = set().union(*(r[name]["kernel_calls"] for r in res
                          for name in ("fp8", "fp8-b64-ef")))
    return launches, plans, calls


# phase 13: tensor-parallel training of full-width glm4-9b (depth cut to
# TRAIN_LAYERS) on (data=2, model=2): 4 gloo ranks on the card.  The h100
# tuner gives the model axis's 4 MiB activation combines the primary route
# only; a TuningProfile pins that slot to three routes, so the staged ring
# (and K1) and the ortho detour run inside the forward, the recompute and
# the backward of every combine
TP_MESH = (2, 2)
TP_RUNS = (("nccl", {"backend": "nccl"}, 0), ("flexlink", {}, 0),
           ("flexlink-b64", {}, 64))
#: buckets a step of the 64 MiB run: GradBucketer on a rank's model-axis
#: shards
TP_BUCKETS = 27
TP_SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}
TP_SEQ = 128
TP_BATCH = 8                   # global: 4 rows a data rank


def _pin_all_reduce(path: str, sizes, ranks: int = 2) -> list:
    """Write the TuningProfile that pins the all-reduce slots of ``ranks``
    ranks at the buckets of payloads of ``sizes`` bytes to TP_SHARES (the
    tuner gives such small payloads the primary route alone, and the
    staged ring, K1, runs only on a staged share); returns the buckets."""
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.communicator import bucket_for
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    prof = TuningProfile(path)
    buckets = sorted({bucket_for(n) for n in sizes})
    for bucket in buckets:
        prof.record("h100", "ring", Collective.ALL_REDUCE, ranks, bucket,
                    SHARE_GRID, TP_SHARES)
    prof.save(path)
    return buckets


def _pin_model_axis(path: str, d_model: int) -> int:
    """Pin the model axis's all-reduce slot (one [4, 128, d_model] bf16
    combine) to TP_SHARES; returns its bucket."""
    nbytes = TP_BATCH // TP_MESH[0] * TP_SEQ * d_model * 2
    return _pin_all_reduce(path, (nbytes,), TP_MESH[1])[0]


def _step_phase() -> str:
    """Where an executed collective runs: the forward, the checkpoint
    recompute (inside the backward, grad mode on) or the backward."""
    if torch._C._current_graph_task_id() == -1:
        return "forward"
    return "recompute" if torch.is_grad_enabled() else "backward"


def _trace_first_step(program, ctx, mesh) -> list:
    """From now on, the program's first ``step`` runs inside a trace scope
    of ``mesh``; the list it returns gets (its log, the program's plan
    signature before the step's Stage-2 observation)."""
    live, step = [], program.step

    def first_traced(*args, **kwargs):
        if live:
            return step(*args, **kwargs)
        with mesh.tracing() as log:
            out = program(*args, **kwargs)
        live.append((log, ctx.plan_signature(program.name)))
        program.observe()
        return out
    program.step = first_traced
    return live


def _lowered_vs_live(lowered, live) -> dict:
    """A lowered step against its live call: whether their traced and
    executed collectives (op, axis, dtype, bytes) agree as multisets and
    their plan signatures are equal, with the lowered log's counts."""
    (log, sig), = live
    low = lowered.log
    return {"traced": collections.Counter(low.traced)
            == collections.Counter(log.traced),
            "executed": collections.Counter(low.executed)
            == collections.Counter(log.executed),
            "signature": lowered.plan_signature == sig,
            "n_traced": len(low.traced), "n_executed": len(low.executed),
            "structure": low.structure(), "lower_s": lowered.lower_s}


def _check_lowered(phase: str, res: list) -> dict:
    """Every rank's lowered step equal to its live one; rank 0's record."""
    for r, got in enumerate(res):
        check(got is not None and got["traced"] and got["executed"]
              and got["signature"], f"{phase}: rank {r}'s lowered step "
              f"differs from its live call: {got}")
    rec = res[0]
    print(f"phase {phase}: lowered on meta = the first live step on every "
          f"rank (traced {rec['n_traced']}, executed {rec['n_executed']} "
          f"calls, plan signatures equal); traced structure "
          f"{rec['structure']}; lowering {rec['lower_s']:.2f} s a rank")
    return rec


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
    from repro_torch.runtime.program import meta_like
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
        for name, comm, bucket_mb in TP_RUNS:
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
                                total_steps=TRAIN_STEPS), name=name,
                bucket_mb=bucket_mb)
            opt_state = bucketed_opt_state(ctx, bucket_mb, params,
                                           opt_state)
            batches = make_batches(cfg, seq_len=TP_SEQ,
                                   batch_per_shard=TP_BATCH)
            lowered = live = None
            if name == "flexlink":
                # the program lowered on meta copies, then its first live
                # step traced: their logs and plan signatures
                first = next(batches)
                batches = itertools.chain([first], batches)
                lowered = program.lower(*meta_like((params, opt_state,
                                                    first)))
                live = _trace_first_step(program, ctx, mesh)
            calls.clear()
            seen = set()
            log, roundtrips = [], collections.Counter()
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with recorded_calls(seen), bucket_probe(ctx, log, roundtrips):
                params, opt_state, hist = run_loop(
                    program, params, opt_state, batches, ctx,
                    LoopConfig(total_steps=TRAIN_STEPS, log_every=0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            seg_paths = _segment_paths()
            rec = {c.axis_name: len(c.recorder(name).issued_calls())
                   for c in ctx.comms()}
            bucket_calls = sum(
                len(c.recorder(f"{name}/g{k}").issued_calls())
                for c in ctx.comms() for k in range(TP_BUCKETS)
                if f"{name}/g{k}" in c._recorders)
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
                "bucket_calls": bucket_calls,
                "kernel_calls": seen, "segment_paths": seg_paths,
                "lowered": (_lowered_vs_live(lowered, live)
                            if lowered is not None else None),
                **bucket_record(ctx, bucket_mb, params, opt_state, log,
                                roundtrips)}
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
    for name, _, bucket_mb in TP_RUNS:
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
            if name != "nccl":
                units = {u for plan in g["model_plans"] for u, _ in plan[0]}
                check(units == {"primary", "staged", "ortho"},
                      f"rank {r}: model-axis plans {g['model_plans']}")
            if bucket_mb:
                # the data axis records one call a bucket, each in its
                # issue scope's sub-recorder
                check(g["recorded"] == {"model": 3, "data": 0}
                      and g["bucket_calls"] == TP_BUCKETS,
                      f"rank {r} {name}: recorded {g['recorded']} and "
                      f"{g['bucket_calls']} calls in bucket scopes, want 3 "
                      f"model-axis calls and one a bucket")
                check_buckets(name, g, TP_BUCKETS, 0, TRAIN_STEPS)
        losses[name] = hist[0]
        rec = res[0][name]
        print(f"phase 13: {name}: losses {hist[0]}; recorded a step "
              f"{rec['recorded']}; model-axis all-reduces executed a step "
              f"{ {k: v // TRAIN_STEPS for k, v in rec['model_exec'].items()} }"
              f"; launches a rank {rec['launches']}; "
              f"{max(r[name]['wall_s'] for r in res):.1f} s for "
              f"{TRAIN_STEPS} steps; peak "
              f"{max(r[name]['peak_gib'] for r in res):.2f} GiB a rank")
    _check_lowered("13", [r["flexlink"]["lowered"] for r in res])
    for i in range(TRAIN_STEPS):
        d = abs(losses["flexlink"][i] - losses["nccl"][i])
        check(d < 5e-3, f"step {i}: flexlink {losses['flexlink'][i]} vs "
              f"nccl {losses['nccl'][i]}")
        d = abs(losses["flexlink-b64"][i] - losses["flexlink"][i])
        check(d < 5e-3, f"step {i}: flexlink-b64 "
              f"{losses['flexlink-b64'][i]} vs flexlink "
              f"{losses['flexlink'][i]}")
    print(f"phase 13: flexlink-b64: {TP_BUCKETS} buckets of "
          f"{TP_RUNS[-1][2]} MiB a step "
          f"(a rank's shards), issued g0.. in order from the backward on "
          f"the ctx's side stream; within 5e-3 of flexlink a step; wall "
          f"time for {TRAIN_STEPS} steps, the slower rank ({WALL_NOTE}; no "
          f"overlap is claimed): "
          + ", ".join(f"{name} {max(r[name]['wall_s'] for r in res):.2f} s"
                      for name, _, _ in TP_RUNS))
    for plan in res[0]["flexlink"]["model_plans"]:
        print(f"phase 13: flexlink model-axis plan: units {plan[0]}, "
              f"substeps {plan[1]}, {plan[2]} elements")
    total = sum((collections.Counter(r[name]["launches"]) for r in res
                 for name, _, _ in TP_RUNS), collections.Counter())
    k1 = sum(collections.Counter(r["flexlink"]["launches"])["k1"]
             for r in res)
    paths = sum((collections.Counter(r["flexlink"]["segment_paths"])
                 for r in res), collections.Counter())
    print(f"phase 13: flexlink within 5e-3 of nccl a step; K1 launches over "
          f"4 ranks {k1} = the sum over the executed plans, (n-1) a staged "
          f"ring (one launch a ring step over its sub-chunks; K1 segments "
          f"by path {paths['k1 vector']} vector / {paths['k1 scalar']} "
          f"scalar); the model axis records 3 calls a step (the "
          f"reference's per-trace count) and executes {per_step} a step")
    calls = set().union(*(r[name]["kernel_calls"] for r in res
                          for name in ("flexlink", "flexlink-b64")))
    # the model-axis combine's staged ring step: its staged segment, one
    # rank's ring chunk of it, cut into the plan's sub-chunks
    units, substeps, numel = [p for p in res[0]["flexlink"]["model_plans"]
                              if "staged" in dict(p[0])][0]
    chunk = numel * dict(units)["staged"] // 16 // TP_MESH[1]
    tp_step = (-(-chunk // substeps),) * substeps
    return k1, {k: total[k] for k in ("k7a", "k7b")}, calls, tp_step


# float32 operations each kernel does per element (abs, max, divide and
# convert for K2; convert and a multiply or fused multiply-add for K3 and
# K4; a convert for K5; a convert and an add for the mixed K1)
CODEC_OPS = {"fp8_encode": 4, "fp8_decode_accumulate": 2, "fp8_decode": 2,
             "bf16_pack": 1, "k1_mixed": 2}
F32_FLOPS = 67e12


#: segment-table calls as ``recorded_calls`` names them -> (kernel of
#: ``_check_segments``, the single-pair kernel's name in the kernels line)
SEGMENT_CALLS = {"k1_segments": ("k1", "k1"),
                 "k1_mixed_segments": ("k1", "k1_mixed"),
                 "bf16_pack_segments": ("bf16_pack", "bf16_pack")}


def phase12_main_path_check(calls, phase="12", required=None):
    """Each K1-K5 wrapper against its plain version at every (length,
    dtype, format) its kernel was given on the main path (phases 7, 10,
    11 and 13; phase 19's serve program in a second call), and each K1
    and K5 segment-table launch at every table of sub-chunk lengths those
    phases gave it.  Aligned and one element off (tables also every other
    segment off), NaN and inf groups included: bit for bit, NaN at the
    same places.  Each name in ``required`` (default: every wrapper and
    segment-table call) must have a recorded call."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, ref
    gen = torch.Generator(device="cuda").manual_seed(121)
    stats, lengths = {}, collections.defaultdict(set)
    tables = collections.defaultdict(set)
    for name, n, dtype, fmt in sorted(calls, key=str):
        if name in SEGMENT_CALLS:
            kernel, single = SEGMENT_CALLS[name]
            dtypes = ((dtype, torch.bfloat16) if name == "k1_mixed_segments"
                      else (dtype, dtype) if kernel == "k1" else (dtype,))
            seg_stats = {}
            for offsets in SEG_OFFSETS:
                _check_segments(kernel, n, dtypes, offsets, gen, seg_stats,
                                "main path")
            stats[single] = max(stats.get(single, 0.0),
                                seg_stats[kernel, dtype])
            for k, v in seg_stats.get("nan_bits", {}).items():
                nan_bits = stats.setdefault("nan_bits", {})
                nan_bits[single] = nan_bits.get(single, 0) + v
            tables[name].add((n, str(dtype)[6:]))
            lengths[single].update(n)
            torch.cuda.empty_cache()
            continue
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
    if required is None:
        required = ("fp8_encode", "fp8_decode_accumulate", "fp8_decode",
                    "bf16_pack", "k1_mixed", "k1", *SEGMENT_CALLS)
    for name in required:
        check(tables[name] if name in SEGMENT_CALLS else lengths[name],
              f"{name}: no call recorded on the main path")
    lengths = {k: sorted(v) for k, v in lengths.items()}
    tables = {k: sorted(v) for k, v in tables.items()}
    print(f"phase {phase}: K1-K5 vs plain versions at every length the main "
          f"path gave them ({lengths}), aligned and one off, NaN and inf "
          f"groups: bit for bit, NaN at the same places (NaNs with other "
          f"bits: {stats.get('nan_bits', {})}); max abs err "
          f"{ {k: v for k, v in stats.items() if k != 'nan_bits'} }")
    print(f"phase {phase}: K1 and K5 segment tables of the main path, each "
          f"launched once aligned, once one element off and once every "
          f"other segment off, bit for bit: {tables}")
    return stats, lengths, tables


def phase12_codec_times(card, plans, lengths, tables, tp_step,
                        baseline=None):
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
            _time_codecs(n, names, gen, shape_name, rows, key, mem_bps,
                         baseline or {})
    for name in CODEC_OPS:
        rows[name]["main"]["where"] = where[name][1]
    _codec_floors(rows, gen)
    # one ring step of each segment-table kernel on its path: K5 and the
    # mixed K1 at phase 10 (c)'s (the longest float32 table recorded),
    # K1 at phase 13's model-axis combine
    base = baseline or {}
    k1_base = base.get("chunk_accumulate")
    k1_one = k1_base.chunk_accumulate if k1_base else None
    for name, seg_name, dtypes, one in (
            ("bf16_pack", "bf16_pack_segments", (torch.float32,),
             base["codec"].bf16_pack if "codec" in base else None),
            ("k1_mixed", "k1_mixed_segments",
             (torch.float32, torch.bfloat16), k1_one)):
        table = max((t for t, dt in tables[seg_name] if dt == "float32"),
                    key=sum)
        rows[name]["ring_step"] = ring_step_times(
            "bf16_pack" if name == "bf16_pack" else "k1", table, dtypes,
            gen, card, one)
        _ring_step_line(12, f"{name} (phase 10 (c))",
                        rows[name]["ring_step"], card)
    check((tp_step, "bfloat16") in tables["k1_segments"],
          f"phase 13's model-axis step {tp_step} is not among the K1 "
          f"tables {tables['k1_segments']}")
    rows["k1"]["ring_step"] = ring_step_times(
        "k1", tp_step, (torch.bfloat16, torch.bfloat16), gen, card, k1_one)
    _ring_step_line(12, "K1 bf16 (phase 13's model-axis combine)",
                    rows["k1"]["ring_step"], card)
    return rows


def _codec_floors(rows, gen):
    """Each kernel's time on one 128-element group, timed like the rest:
    what a call costs in this timing method (launch, first loads, last
    stores) before its bytes count.  A kernel's time at n is at least
    this floor plus its byte bound."""
    from repro_torch.kernels import chunk_accumulate as ca
    from repro_torch.kernels import codec, ref
    xb = torch.randn(128, generator=gen, device="cuda").to(torch.bfloat16)
    xf = torch.randn(128, generator=gen, device="cuda")
    vals, scales = ref.fp8_encode_ref(xb)
    packed = ref.bf16_pack_ref(xf)
    calls = {"fp8_encode": lambda: codec.fp8_encode(xb),
             "fp8_decode_accumulate": lambda: codec.fp8_decode_accumulate(
                 vals, scales, xb, "fp8_e4m3"),
             "fp8_decode": lambda: codec.fp8_decode(
                 vals, scales, "fp8_e4m3", torch.bfloat16),
             "bf16_pack": lambda: codec.bf16_pack(xf),
             "k1_mixed": lambda: ca.chunk_accumulate(xf, packed)}
    for name, fn in calls.items():
        rows[name]["floor_ms"] = time_ms(fn)
    print("phase 12: each kernel's floor, its time on one 128-element "
          "group: " + ", ".join(f"{name} {rows[name]['floor_ms']:.4f} ms"
                                for name in calls))


def _time_codecs(n, names, gen, shape_name, rows, key, mem_bps, base):
    """Time the kernels ``names`` at length ``n`` into rows[name][shape].
    With an earlier checkout's ``base["codec"]`` (and
    ``base["chunk_accumulate"]``), K2-K5 (and the mixed K1) are timed in
    turns with that checkout's kernels on the same operands: earlier,
    this, this, earlier; each time is the mean of its two turns."""
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
    # K2-K4's traffic through PyTorch's own elementwise kernels: integer
    # casts and an add that read and write the same bytes (no scales)
    streams = {
        "fp8_encode": ("int16 -> int8 cast",
                       lambda i: xb[i].view(torch.int16).to(torch.int8)),
        "fp8_decode": ("uint8 -> int16 cast",
                       lambda i: vals[i].view(torch.uint8).to(torch.int16)),
        "fp8_decode_accumulate": (
            "int16 + uint8", lambda i: bb[i].view(torch.int16)
            + vals[i].view(torch.uint8))}
    earlier = {}
    if "codec" in base:
        old = base["codec"]
        earlier.update({
            "fp8_encode": lambda i: old.fp8_encode(xb[i]),
            "fp8_decode_accumulate": lambda i: old.fp8_decode_accumulate(
                vals[i], scales[i], bb[i], "fp8_e4m3"),
            "fp8_decode": lambda i: old.fp8_decode(
                vals[i], scales[i], "fp8_e4m3", torch.bfloat16),
            "bf16_pack": lambda i: old.bf16_pack(xf[i])})
    if "chunk_accumulate" in base:
        earlier["k1_mixed"] = lambda i: base["chunk_accumulate"] \
            .chunk_accumulate(xf[i], packed[i])
    for name in names:
        kern, plain, lib, nbytes = calls[name]
        turns = None
        if name in earlier:
            turns = [time_ms(earlier[name], sets=k), time_ms(kern, sets=k),
                     time_ms(kern, sets=k), time_ms(earlier[name], sets=k)]
            ms = (turns[1] + turns[2]) / 2
        else:
            ms = time_ms(kern, sets=k)
        plain_ms = time_ms(plain, iters=5, warmup=1, sets=k)
        lib_ms = time_ms(lib, sets=k) if lib is not None else None
        stream_ms = (time_ms(streams[name][1], sets=k) if name in streams
                     else None)
        b_s, f_s = nbytes / mem_bps, CODEC_OPS[name] * n / F32_FLOPS
        bound_ms = max(b_s, f_s) * 1e3
        bound_by = "bytes" if b_s >= f_s else "operations"
        rows[name][shape_name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, n=n)
        lib_txt = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        if stream_ms is not None:
            rows[name][shape_name].update(stream_ms=stream_ms,
                                          stream_call=streams[name][0])
            lib_txt += (f", the same traffic through PyTorch "
                        f"({streams[name][0]}) {stream_ms:.4f} ms")
        if turns:
            old_ms = (turns[0] + turns[3]) / 2
            rows[name][shape_name].update(baseline_ms=old_ms, turns=turns)
            lib_txt += (f", baseline kernel {old_ms:.4f} ms ({bound_ms / old_ms:.1%} "
                        f"of bound; this one {old_ms / ms:.2f}x faster; "
                        f"turns baseline/this/this/baseline "
                        + "/".join(f"{t:.4f}" for t in turns) + ")")
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
                                    "library_ms", "baseline_ms", "stream_ms",
                                    "stream_call")
               if k in main},
            "shape": f"n={main['n']} ({main['where']})",
            "n_64MiB": {k: big[k] for k in ("n", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "baseline_ms",
                                             "stream_ms")
                        if k in big},
            "floor_ms": rows["floor_ms"],
            **({"ring_step_phase10c": rows["ring_step"]}
               if "ring_step" in rows else {}),
            "kernel": cuda_name}


# phase 14: K7, the payload split and merge.  No path launches them
# (routing.execute partitions with views and torch.cat, as the reference's
# execute does with lax.dynamic_slice), so they are held against their
# plain versions and timed here only
K7_SPLITS = ((1,), (2, 1), (1, 3, 2), (4, 1, 2, 3), (1,) * 9,
             (1, 2) * 8 + (1,))
K7_BIG = 64 * MiB                      # bytes a timed call copies
#: payloads the paths partition at THREE_ROUTES (bf16): phase 7 (a)'s
#: 256 MiB all-reduce and phase 13's 4 MiB model-axis combine
K7_PAYLOADS = (("phase 7 (a)", 256 * MiB), ("phase 13", 4 * MiB))


def _same_bytes(got, want) -> bool:
    return got.shape == want.shape and torch.equal(got.view(torch.uint8),
                                                   want.view(torch.uint8))


def _k7_cases(dtype, err):
    """K7a and K7b vs plain versions at the reference test's
    cases, at one element off its blocks and at merges of 9 and 17
    segments (ceil(segments / 8) launches); returns the max abs error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import payload_partition as pp
    blk = ref.BLOCK
    i = torch.arange((max(map(sum, K7_SPLITS)) + 1) * blk + 20,
                     device="cuda")
    x = (i % 251).to(dtype) if dtype == torch.uint8 else (i * 0.5).to(dtype)

    def same(got, want, tag):
        torch.cuda.synchronize()
        check(_same_bytes(got, want), f"K7 {tag} {dtype}: not bit-identical "
              f"to its plain version")
        return max(err, (got.float() - want.float()).abs().max().item())

    for n_blocks, start in ((1, 0), (2, 1), (3, 5)):
        want = ref.extract_segment_ref(x[:8 * blk], start, n_blocks)
        err = same(ops.extract_segment(x[:8 * blk], start, n_blocks), want,
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
            before = pp.launch_count["merge"]
            got = ops.merge_segments(segs) if extra == 0 else pp.merge(segs)
            launches = pp.launch_count["merge"] - before
            check(launches == -(-len(sizes) // pp.MAX_SEGMENTS),
                  f"K7 merge of {len(sizes)} segments: {launches} launches")
            err = same(got, ref.merge_segments_ref(segs),
                       f"merge {sizes} + {extra}")
    return err


def _k7_timed(nbytes, k, mem_bps, kern, plain, lib, base=None):
    """One K7 call copying ``nbytes``, timed on ``k`` rotated operand sets
    (``kern(i)``) twice, in turns with the earlier checkout's kernel
    (``base``, --baseline) where given: base, kern, kern, base."""
    seq = [base] * bool(base) + [kern, kern] + [base] * bool(base)
    turns = [time_ms(f, sets=k) for f in seq]
    t = turns[1:-1] if base else turns
    row = dict(ms=(t[0] + t[1]) / 2, turns=turns,
               plain_ms=time_ms(plain, sets=k),
               library_ms=time_ms(lib, sets=k),
               bound_ms=2 * nbytes / mem_bps * 1e3, bound_by="bytes",
               bytes=2 * nbytes, rotations=k)
    if base:
        row["baseline_ms"] = (turns[0] + turns[-1]) / 2
    return row


def _k7_line(what, row, lib_name, card):
    key, (mem_bps, _) = card_peaks(card)
    base = ""
    if "baseline_ms" in row:
        base = (f", baseline {row['baseline_ms']:.4f} ms "
                f"({row['bound_ms'] / row['baseline_ms']:.1%})")
    order = "baseline/this/this/baseline" if base else "this/this"
    print(f"phase 14: {what}: {row['ms']:.4f} ms "
          f"({row['bound_ms'] / row['ms']:.1%} of bound){base}, plain "
          f"{row['plain_ms']:.4f} ms, {lib_name} {row['library_ms']:.4f} ms "
          f"({row['bound_ms'] / row['library_ms']:.1%}); turns {order} "
          + "/".join(f"{t:.4f}" for t in row["turns"])
          + f"; bound {row['bound_ms']:.5f} ms by bytes ({row['bytes']} B "
          f"at {mem_bps / 1e12:.2f} TB/s: {key} datasheet); operands "
          f"rotated over {row['rotations']} copies, out of L2")


def _k7_check(got, want, what):
    torch.cuda.synchronize()
    check(_same_bytes(got, want), f"{what}: not bit-identical")


def phase14_k7(card, baseline=None):
    from repro_torch.core import collectives
    from repro_torch.kernels import payload_partition as pp
    from repro_torch.kernels import ref
    key, (mem_bps, _) = card_peaks(card)
    base = (baseline or {}).get("payload_partition")
    before = dict(pp.launch_count)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        errs[dtype] = _k7_cases(dtype, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(14)
    blk = ref.BLOCK
    rows = {}

    def payloads(n, dtype, k):
        return [torch.randn(n, generator=gen, device="cuda").to(dtype)
                for _ in range(k)]

    for dtype in (torch.float32, torch.bfloat16):
        n = K7_BIG // torch.finfo(dtype).bits * 8         # elements
        nb = n // blk
        k = rotations(2 * K7_BIG)
        # K7a: the second half of a 2n payload; K7b: four segments of
        # 1/2, 1/4, 1/8, 1/8 of n
        xs = payloads(2 * n, dtype, k)
        parts = (nb // 2, nb // 4, nb // 8, nb // 8)
        segs = [[torch.randn(p * blk, generator=gen, device="cuda").to(dtype)
                 for p in parts] for _ in range(k)]
        _k7_check(pp.extract(xs[0], n, n),
                  ref.extract_segment_ref(xs[0], nb, nb),
                  f"K7a 64 MiB {dtype}")
        _k7_check(pp.merge(segs[0]), ref.merge_segments_ref(segs[0]),
                  f"K7b 64 MiB {dtype}")
        tag = f"{str(dtype)[6:]} {n} elements (64 MiB)"
        rows["extract_segment", dtype] = r = _k7_timed(
            K7_BIG, k, mem_bps,
            lambda i: pp.extract(xs[i], n, n),
            lambda i: ref.extract_segment_ref(xs[i], nb, nb),
            lambda i: xs[i][n:2 * n].clone(),
            base and (lambda i: base.extract(xs[i], n, n)))
        _k7_line(f"extract_segment {tag}", r, "x[a:b].clone()", card)
        rows["merge_segments", dtype] = r = _k7_timed(
            K7_BIG, k, mem_bps,
            lambda i: pp.merge(segs[i]),
            lambda i: ref.merge_segments_ref(segs[i]),
            lambda i: torch.cat(segs[i]),
            base and (lambda i: base.merge(segs[i])))
        _k7_line(f"merge_segments {tag}, 4 segments", r, "torch.cat", card)
        for name in ("extract_segment", "merge_segments"):
            rows[name, dtype]["n"] = n
        del xs, segs
        torch.cuda.empty_cache()
    # the route payloads, split as partition_payload splits them
    units = collectives.quantize_shares(THREE_ROUTES, collectives.PATH_ORDER)
    for where, nbytes in K7_PAYLOADS:
        n = nbytes // 2
        unit = n // collectives.CHUNK_GRID
        spans, off = [], 0
        for p in collectives.PATH_ORDER:
            spans.append((p, off * unit, units[p] * unit))
            off += units[p]
        k = rotations(2 * nbytes)
        xs = payloads(n, torch.bfloat16, k)
        segs = [[x[a:a + m].clone() for _, a, m in spans] for x in xs]
        for p, a, m in spans:
            _k7_check(pp.extract(xs[0], a, m), xs[0][a:a + m].clone(),
                      f"K7a {where} {p}")
        _k7_check(pp.merge(segs[0]), xs[0], f"K7b {where}")
        for p, a, m in spans:
            rows["extract_segment", where, p] = r = _k7_timed(
                2 * m, k, mem_bps,
                lambda i: pp.extract(xs[i], a, m),
                lambda i: ref.extract_segment_ref(xs[i], a // blk, m // blk),
                lambda i: xs[i][a:a + m].clone(),
                base and (lambda i: base.extract(xs[i], a, m)))
            r["n"] = m
            _k7_line(f"extract_segment bf16, {where}'s {nbytes // MiB} MiB "
                     f"payload, the {p} segment ({2 * m / MiB:g} MiB at "
                     f"{2 * a / MiB:g} MiB)", r, "x[a:b].clone()", card)
        rows["merge_segments", where] = r = _k7_timed(
            nbytes, k, mem_bps,
            lambda i: pp.merge(segs[i]),
            lambda i: ref.merge_segments_ref(segs[i]),
            lambda i: torch.cat(segs[i]),
            base and (lambda i: base.merge(segs[i])))
        r["n"] = n
        _k7_line(f"merge_segments bf16, {where}'s {nbytes // MiB} MiB "
                 f"payload, " + " + ".join(f"{2 * m / MiB:g}"
                                           for _, _, m in spans)
                 + " MiB", r, "torch.cat", card)
        del xs, segs
        torch.cuda.empty_cache()
    # merges of 9 and 17 segments of 64 MiB bf16 (2 and 3 launches; no
    # path cuts more than 3 route segments)
    n = K7_BIG // 2
    k = rotations(2 * K7_BIG)
    for count in (9, 17):
        part = n // count // 64 * 64
        lengths = [part] * (count - 1) + [n - part * (count - 1)]
        segs = [[torch.randn(m, generator=gen, device="cuda").to(
            torch.bfloat16) for m in lengths] for _ in range(k)]
        want = ref.merge_segments_ref(segs[0])
        b0 = pp.launch_count["merge"]
        out = pp.merge(segs[0])
        _k7_check(out, want, f"K7b {count} segments")
        got = pp.launch_count["merge"] - b0
        check(got == -(-count // pp.MAX_SEGMENTS), f"K7b {count} segments: "
              f"{got} launches")
        rows["merge_segments", count] = r = _k7_timed(
            K7_BIG, k, mem_bps,
            lambda i: pp.merge(segs[i]),
            lambda i: ref.merge_segments_ref(segs[i]),
            lambda i: torch.cat(segs[i]),
            base and (lambda i: base.merge(segs[i])))
        r["n"] = n
        _k7_line(f"merge_segments bf16 {n} elements (64 MiB), {count} "
                 f"segments ({-(-count // pp.MAX_SEGMENTS)} launches)", r,
                 "torch.cat", card)
        del segs, want, out
        torch.cuda.empty_cache()
    # timing and checking launches are not a path's
    pp.launch_count.update(before)
    print(f"phase 14: K7a/K7b vs plain versions in float32, bfloat16 and "
          f"uint8 at the reference test's cases, one element off its blocks "
          f"and merges of 9 and 17 segments (ceil(n / 8) launches), and in "
          f"bf16 at 4, 64 and 256 MiB: bit for bit (max abs err "
          f"{max(errs.values())}); no path launches them (launches 0)")
    return max(errs.values()), rows


_K7_KEYS = ("n", "ms", "baseline_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def _k7_row(name, line, err, rows):
    main = rows[name, torch.bfloat16]

    def pick(row):
        return {k: row[k] for k in _K7_KEYS if k in row}

    out = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/payload_partition.cu",
           "replaces": f"src/repro/kernels/payload_partition.py:{line}",
           "launches": 0,
           "launches_from": "no path calls it: routing.execute slices "
                            "with views, as the reference's does with "
                            "lax.dynamic_slice",
           "max_abs_err": err,
           "max_abs_err_at": "the reference test's cases, one element "
                             "off, merges of 9 and 17 segments (float32, "
                             "bfloat16, uint8), 4 / 64 / 256 MiB (bf16), "
                             "phase 14",
           **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
           **({"baseline_ms": main["baseline_ms"]}
              if "baseline_ms" in main else {}),
           "shape": f"{main['n']} bf16 elements (64 MiB copied)",
           "float32": pick(rows[name, torch.float32]),
           "kernel": {"extract_segment": "K7a",
                      "merge_segments": "K7b"}[name]}
    for where, nbytes in K7_PAYLOADS:
        tag = f"{nbytes // MiB}MiB_three_routes"
        if name == "merge_segments":
            out[tag] = pick(rows[name, where])
        else:
            out[tag] = {p: pick(rows[name, where, p])
                        for p in ("primary", "staged", "ortho")}
    if name == "merge_segments":
        for count in (9, 17):
            out[f"{count}_segments"] = pick(rows[name, count])
    return out


# ---------------------------------------------------------------------------
# phases 15-17: the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

#: phase 15 (a): reduced float32 MoE configs (TF32 off), one packed step's
#: logits through K6 against the dense-gather path; K6's float32 error is
#: at most 3e-5 (phase 2) and the step carries it through 2 layers
MOE_REDUCED_ATOL = 1e-4
#: phase 15 (b, c): one packed step's logits at full width in bf16, the
#: kernel path against the dense-gather path, relative L2, with the MoE
#: routing of the kernel pass pinned to the dense pass's experts (its
#: weights its own).  Phase 4 gives 0.0513 at glm4-9b's 40 layers.
#: Unpinned, a token whose k-th and (k+1)-th router probabilities lie
#: within bf16 noise of each other takes other experts on the two paths,
#: and each such flip moves the rows that attend to it: the first run
#: (PERF.md, PR 20) measured 0.377 unpinned at Mixtral's depth 8, so the
#: unpinned gap is printed with its count of flipped decisions, and the
#: bound holds the pinned one, where only the attention path differs
MOE_LOGITS_KERNEL_VS_DENSE = 0.2
#: (arch, depth kept, requests): the depth cuts of phases 15-17
MOE_SERVE = (("mixtral-8x7b", 8, 8), ("kimi-k2-1t-a32b", 2, 4))
SSM_SERVE = (("mamba2-1.3b", None, 4), ("zamba2-1.2b", None, 4))
MOE_TRAIN_LAYERS = 1
#: AdamW lr of phase 17 (a)'s Mamba2 training: at phase 11's 1e-4 its
#: three steps stay within noise of the initial loss (11.264, 11.237,
#: 11.290 in PR 20's run 2), so they use the CPU tests' 1e-3
SSM_TRAIN_LR = 1e-3
#: phase 17 (a) trains Mamba2 at its widths, depth 48 -> SSM_TRAIN_LAYERS
#: (its full depth until phase 22 needed the time)
SSM_TRAIN_LAYERS = 12
EP_MESH = (2, 2)
#: the shares phase 16 (b) pins the data axis's all_to_all slot to (the
#: ortho share folds into the staged route: primary + staged)
EP_SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}


def _packed_logits(cfg, params, impl, seed=1):
    """One packed step (2 requests, 32 rows, 2 of them padding) on a
    fresh pool, as ``logits_check`` lays it out: float32 logits [2, V]."""
    from repro_torch.models import single_device_ctx
    from repro_torch.models.transformer import (PagedConfig, init_paged_pool,
                                                paged_decode_step)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.tensor([0] * 20 + [1] * 10 + [-1] * 2, device=dev)
    positions = torch.tensor(list(range(20)) + list(range(10)) + [0, 0],
                             device=dev)
    tokens = torch.randint(1, cfg.vocab, (32,), generator=gen, device=dev)
    tables = torch.arange(12, device=dev, dtype=torch.int32).reshape(2, 6)
    sample = torch.tensor([19, 29], device=dev)
    pcfg = PagedConfig(block_size=BS, n_blocks=12, max_blocks_per_req=6,
                       attn_impl=impl)
    pool = init_paged_pool(cfg, single_device_ctx(), pcfg, device=dev)
    logits, _ = paged_decode_step(params, pool, tokens, positions, rows,
                                  tables, sample, cfg, single_device_ctx(),
                                  pcfg)
    return logits.float()


@contextlib.contextmanager
def _routing(record: list, replay: bool = False):
    """Within the block, every MoE ``route`` call appends its experts to
    ``record``; with ``replay``, each call instead takes the experts of
    the recorded call at its place (the top-k weights renormalized from
    its own probabilities at those experts)."""
    from repro_torch.models import moe
    route = moe.route
    recorded = iter(list(record))

    def pinned(x2d, w_router, cfg_moe):
        w, idx, aux = route(x2d, w_router, cfg_moe)
        if not replay:
            record.append(idx)
            return w, idx, aux
        idx = next(recorded)
        probs = torch.softmax(x2d.float() @ w_router.float(), dim=-1)
        w = probs.gather(1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w.to(x2d.dtype), idx, aux

    moe.route = pinned
    try:
        yield record
    finally:
        moe.route = route


def _flips(a: list, b: list) -> int:
    """Tokens whose expert sets differ between two recorded passes."""
    return sum(int((torch.sort(x, 1).values != torch.sort(y, 1).values)
                   .any(1).sum()) for x, y in zip(a, b))


def _drain(engine, work):
    """Submit ``work`` ((prompt, max_new) pairs), drain the engine, and
    return (finished streams, wall seconds, K6 launches in the drain)."""
    from repro_torch.kernels import flash_decode as fd
    for prompt, mnew in work:
        engine.submit(prompt, max_new=mnew)
    torch.cuda.synchronize()
    fd.launch_count = 0
    t0 = time.perf_counter()
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.launch_count
    fin = engine.finished()
    return fin, wall, launches


def phase15_moe_serving(card):
    """(a) reduced float32 mixtral-8x7b and kimi-k2: greedy streams of
    the paged engine through K6 equal those through the dense-gather
    path, K6 launched layers x packed steps, one packed step's logits
    within MOE_REDUCED_ATOL; (b, c) mixtral-8x7b and kimi-k2 at their
    published widths (depth cut), bf16, through the paged engine with
    K6: every request served, K6 launched layers x packed steps, tok/s
    and the median step, and one packed step's logits, kernel against
    dense gather, within MOE_LOGITS_KERNEL_VS_DENSE."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_workload
    from repro_torch.models import init_params, single_device_ctx
    from repro_torch.serving.engine import PagedServeConfig, PagedServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    for arch in ("mixtral-8x7b", "kimi-k2-1t-a32b"):
        cfg = get_config(arch).reduced()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        rng = np.random.default_rng(3)
        work = [(rng.integers(1, cfg.vocab, size=s).tolist(), 6)
                for s in (5, 3, 9, 2, 7, 12)]
        streams = {}
        for impl in ("kernel", "reference"):
            eng = PagedServeEngine(params, cfg, single_device_ctx(),
                                   PagedServeConfig(
                                       max_requests=4, cache_len=96,
                                       kv_block=16, max_tokens_in_flight=16,
                                       min_bucket=4, attn_impl=impl))
            streams[impl], _, n = _drain(eng, work)
            steps = eng.serving_report()["steps"]
            eng.close()
            want = cfg.n_layers * steps if impl == "kernel" else 0
            check(n == want, f"reduced {arch} {impl}: {n} K6 launches, "
                  f"expected {want}")
        check(streams["kernel"] == streams["reference"],
              f"reduced {arch}: kernel and dense-gather streams differ: "
              f"{streams}")
        check(all(len(v) == 6 for v in streams["kernel"].values()),
              f"reduced {arch}: streams of the wrong length")
        err = (_packed_logits(cfg, params, "kernel")
               - _packed_logits(cfg, params, "reference")).abs().max().item()
        check(err < MOE_REDUCED_ATOL, f"reduced {arch}: packed-step logits "
              f"kernel vs dense gather {err} >= {MOE_REDUCED_ATOL}")
        print(f"phase 15 (a): reduced {arch} f32 (TF32 off): paged kernel "
              f"== paged dense gather on {len(work)} greedy streams; "
              f"packed-step logits max abs diff {err:.3g} (< "
              f"{MOE_REDUCED_ATOL})")
        del params
    for arch, depth, n_req in MOE_SERVE:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=depth)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        init_s = time.perf_counter() - t0
        eng = PagedServeEngine(params, cfg, single_device_ctx(),
                               PagedServeConfig(
                                   max_requests=8, cache_len=96,
                                   kv_block=16, max_tokens_in_flight=32,
                                   attn_impl="kernel"))
        work = build_workload(np.random.default_rng(0), n_req, cfg.vocab,
                              12, True)
        fin, wall, n = _drain(eng, work)
        rep = eng.serving_report()
        eng.close()
        steps = rep["steps"]
        tokens = sum(len(v) for v in fin.values())
        check(len(fin) == n_req and all(
            len(fin[r]) == m for r, (_, m) in enumerate(work)),
            f"{arch}: served {len(fin)} of {n_req} requests")
        check(all(0 <= t < cfg.vocab for v in fin.values() for t in v),
              f"{arch}: a token outside the vocabulary")
        check(n == depth * steps, f"{arch}: K6 launched {n} times, "
              f"expected {depth} x {steps}")
        launches[arch] = n
        dense_idx, kern_idx = [], []
        with _routing(dense_idx):
            dense = _packed_logits(cfg, params, "reference")
        with _routing(kern_idx):
            free = _packed_logits(cfg, params, "kernel")
        with _routing(dense_idx, replay=True):
            kern = _packed_logits(cfg, params, "kernel")
        check(kern.shape == (2, cfg.vocab_padded)
              and all(bool(torch.isfinite(t).all())
                      for t in (kern, free, dense)),
              f"{arch}: full-width logits not finite or of shape "
              f"{tuple(kern.shape)}")

        def rel(a):
            return ((a - dense).norm() / dense.norm()).item()

        rel_free, rel_pinned = rel(free), rel(kern)
        flips = _flips(dense_idx, kern_idx)
        check(rel_pinned < MOE_LOGITS_KERNEL_VS_DENSE, f"{arch}: logits "
              f"kernel vs dense bf16 (routing pinned) rel L2 {rel_pinned} "
              f">= {MOE_LOGITS_KERNEL_VS_DENSE}")
        print(f"phase 15 ({'b' if arch == MOE_SERVE[0][0] else 'c'}): "
              f"{arch} at its "
              f"published widths (d_model {cfg.d_model}, {cfg.n_heads}/"
              f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, {cfg.moe.n_experts}"
              f" experts top-{cfg.moe.top_k}, vocab {cfg.vocab}; depth cut "
              f"{full.n_layers} -> {depth}), {cfg.param_dtype}, seed 0, "
              f"{n_params / 1e9:.3f}B params ({init_s:.1f} s to init), "
              f"paged engine with K6: {len(fin)} requests, {tokens} tokens, "
              f"{steps} packed steps, K6 launches {n} = {depth} x {steps}; "
              f"{tokens / wall:.1f} tok/s over {wall:.2f} s, median step "
              f"{rep['step_ms']['median']:.2f} ms; packed-step logits "
              f"kernel vs dense bf16 rel L2 {rel_pinned:.4g} with the "
              f"routing pinned (bound {MOE_LOGITS_KERNEL_VS_DENSE}), "
              f"{rel_free:.4g} unpinned ({flips} of "
              f"{32 * len(dense_idx)} token routings "
              f"flipped); {card}")
        del params, kern, free, dense, eng
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def dp_family_rank(arch, layers, lr, reduced=False, tuning_cache=""):
    """One rank of phases 16 (a), 17 (a) and 18 (e): ``arch`` at its
    published widths (``layers`` deep, an encoder-decoder's encoder too,
    or its full depth with None), or
    its ``reduced()`` config in bf16 (``reduced``), on the (data=2) mesh,
    TRAIN_STEPS steps at AdamW ``lr`` with the ``nccl`` backend and
    ``flexlink`` (its slots warm-started from ``tuning_cache`` when one is
    named), each
    from the seed-0 init; the kernel counts set to 0 just before each run
    and read just after it."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_train_program
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="bfloat16")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        if cfg.encdec is not None:
            cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
                cfg.encdec, n_enc_layers=layers))
    mesh = Mesh((2, 1), ("data", "model"))
    out = {}
    flex = {"tuning_cache": tuning_cache} if tuning_cache else {}
    for name, comm in (("nccl", {"backend": "nccl"}), ("flexlink", flex)):
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        opt_state = init_state(params)
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(profile="h100", **comm),
            opt=AdamWConfig(lr=lr, warmup_steps=1,
                            total_steps=TRAIN_STEPS), name=name)
        batches = make_batches(cfg, seq_len=128, batch_per_shard=8)
        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        params, opt_state, hist = run_loop(
            program, params, opt_state, batches, ctx,
            LoopConfig(total_steps=TRAIN_STEPS, log_every=0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        program.close()
        out[name] = {"losses": hist, "wall_s": wall,
                     "launches": dict(launches),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del params, opt_state, program, ctx
        torch.cuda.empty_cache()
    return out


def _dp_checks(phase, what, res, lr, card):
    """The checks and the line of a data-parallel pair of runs: finite
    losses, equal on both ranks and falling, flexlink bit for bit the
    nccl run's, K1 launched in the flexlink run.  Returns the flexlink
    run's K1 launches over the ranks."""
    runs = ("nccl", "flexlink")
    for name in runs:
        hist = [r[name]["losses"] for r in res]
        check(all(np.isfinite(h).all() for h in hist),
              f"{what} {name}: loss not finite: {hist}")
        check(all(h == hist[0] for h in hist),
              f"{what} {name}: the ranks' losses differ: {hist}")
        check(hist[0][-1] < hist[0][0],
              f"{what} {name}: loss did not fall: {hist[0]}")
    a, b = res[0]["flexlink"]["losses"], res[0]["nccl"]["losses"]
    check(a == b, f"{what}: flexlink losses {a} differ from nccl's {b}")
    k1 = sum(r["flexlink"]["launches"].get("k1", 0) for r in res)
    check(k1 > 0, f"{what}: no K1 launch in the flexlink run")
    print(f"phase {phase}: {what}: seq 128, global batch 8, AdamW lr "
          f"{lr}, 2 gloo ranks on one card; losses nccl == flexlink "
          f"bit for bit {a}; K1 launches over 2 "
          f"ranks {k1}; wall for {TRAIN_STEPS} steps, the slower rank "
          f"({WALL_NOTE}): "
          + ", ".join(f"{n} {max(r[n]['wall_s'] for r in res):.2f} s"
                      for n in runs)
          + f"; peak {max(r[n]['peak_gib'] for r in res for n in runs):.2f}"
          f" GiB a rank; {card}")
    return k1


def ep_rank(pinned: str):
    """One rank of phase 16 (b): reduced kimi-k2 (ep_a2a, 4 experts over
    the data axis, their FFN hidden dim over the model axis) on the
    (data=2, model=2) mesh, TRAIN_STEPS steps with the ``nccl`` backend
    and with ``flexlink`` (the data axis's all_to_all slot pinned by
    ``pinned``),
    from the seed-0 global init cut to this rank's shards; every executed
    collective recorded with its step phase."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.core.communicator import CommConfig
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (build_train_program, local_params,
                                          rank_specs)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    mesh = Mesh(EP_MESH, ("data", "model"))
    calls = []
    execute = routing.execute

    def recorded(plan, x, m, **kw):
        calls.append((plan.axis_name, plan.collective.value, _step_phase(),
                      plan.chunk_units))
        return execute(plan, x, m, **kw)

    routing.execute = recorded
    out = {}
    try:
        for name, comm in (("nccl", {"backend": "nccl"}),
                           ("flexlink", {"tuning_cache": pinned})):
            program, ctx = build_train_program(
                cfg, mesh, comm=CommConfig(profile="h100", **comm),
                opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=TRAIN_STEPS), name=name)
            specs = rank_specs(cfg, ctx)
            params = local_params(init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
                specs, ctx)
            opt_state = init_state(params)
            batches = make_batches(cfg, seq_len=128, batch_per_shard=8)
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, hist = run_loop(
                program, params, opt_state, batches, ctx,
                LoopConfig(total_steps=TRAIN_STEPS, log_every=0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            program.close()
            a2a = [(ph, units) for axis, op, ph, units in calls
                   if op == "all_to_all"]
            out[name] = {
                "losses": hist, "wall_s": wall,
                "a2a": dict(collections.Counter(ph for ph, _ in a2a)),
                "a2a_units": sorted({units for _, units in a2a}),
                "expert_shape": tuple(
                    params["layers"]["moe"]["experts"]["w_gate"].shape)}
            del params, opt_state, program, ctx
            torch.cuda.empty_cache()
    finally:
        routing.execute = execute
    return out


def phase16_moe_training(card):
    """(a) mixtral-8x7b at its published widths (depth cut to 1, bf16) on
    (data=2): nccl and flexlink losses bit for bit, K1 launched; (b)
    reduced kimi-k2 ep_a2a on (data=2, model=2), the data axis's
    all_to_all pinned to primary + staged: nccl and flexlink losses bit
    for bit, the all_to_alls a step (dispatch and return in the forward,
    again in the checkpoint recompute, their transposes in the
    backward)."""
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.communicator import bucket_for
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(dp_family_rank, 2, backend="gloo", device="cuda",
                    timeout_s=900,
                    args=("mixtral-8x7b", MOE_TRAIN_LAYERS, TRAIN_LR))
    print(f"phase 16 (a): ranks ran {time.perf_counter() - t0:.1f} s")
    k1 = _dp_checks("16 (a)", f"mixtral-8x7b at its published widths "
                    f"(depth cut 32 -> {MOE_TRAIN_LAYERS}), bf16, seed 0, "
                    f"mesh (data=2), the loss with the router's aux loss",
                    res, TRAIN_LR, card)
    # the ep dispatch buffer of a data rank: [E * cap, d] float32 with
    # 4 rows x 128 tokens, top-2 of 4 experts at capacity factor 1.25
    cap = int(np.ceil(4 * 128 * 2 / 4 * 1.25))
    nbytes = 4 * cap * 256 * 4
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        prof = TuningProfile(pinned)
        prof.record("h100", "ring", Collective.ALL_TO_ALL, EP_MESH[0],
                    bucket_for(nbytes), SHARE_GRID, EP_SHARES)
        prof.save(pinned)
        t0 = time.perf_counter()
        res = run_ranks(ep_rank, 4, backend="gloo", device="cuda",
                        timeout_s=600, args=(pinned,))
    # one MoE layer: dispatch + return in the forward, the same two in
    # its checkpoint recompute (the combine's backward needs the returned
    # rows), and their two transposes in the backward
    want = {ph: 2 * TRAIN_STEPS for ph in ("forward", "recompute",
                                          "backward")}
    for name in ("nccl", "flexlink"):
        hist = [r[name]["losses"] for r in res]
        check(all(np.isfinite(h).all() for h in hist),
              f"ep {name}: loss not finite: {hist}")
        check(hist[0] == hist[2] and hist[1] == hist[3],
              f"ep {name}: the ranks of one model index differ: {hist}")
        for r, got in enumerate(res):
            check(got[name]["a2a"] == want, f"rank {r} ep {name}: "
                  f"all_to_alls {got[name]['a2a']}, want {want}")
            check(got[name]["expert_shape"] == (1, 2, 256, 256),
                  f"rank {r}: expert shard {got[name]['expert_shape']}")
    for r in range(4):
        check(res[r]["flexlink"]["losses"] == res[r]["nccl"]["losses"],
              f"rank {r} ep: flexlink {res[r]['flexlink']['losses']} vs "
              f"nccl {res[r]['nccl']['losses']}")
    units = res[0]["flexlink"]["a2a_units"]
    check(all({u for u, _ in plan} == {"primary", "staged"}
              for plan in units), f"ep flexlink all_to_all plans {units}")
    print(f"phase 16 (b): reduced kimi-k2 ep_a2a (4 experts over data, "
          f"their hidden dim over model; expert shard a rank "
          f"{res[0]['flexlink']['expert_shape']}), f32, mesh (data=2, "
          f"model=2), 4 gloo ranks on one card, data-axis all_to_all slot "
          f"({bucket_for(nbytes)} B bucket) pinned to {EP_SHARES}: plans "
          f"{units}; losses nccl == flexlink bit for bit on every rank "
          f"{res[0]['flexlink']['losses']}; all_to_alls a step "
          f"{ {k: v // TRAIN_STEPS for k, v in want.items()} } "
          f"on every rank; ranks ran {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    return k1


def phase17_ssm_hybrid(card):
    """(a) mamba2-1.3b and (b) zamba2-1.2b at their published widths and
    depths, bf16, seed 0, served by the wave engine (4 requests: every
    request served, tokens in the vocabulary, a forward's logits finite,
    tok/s); then mamba2-1.3b trained on (data=2): nccl and flexlink
    losses bit for bit, K1 launched."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import build_workload
    from repro_torch.models import init_params, single_device_ctx
    from repro_torch.models.transformer import forward, lm_logits_local
    from repro_torch.serving.engine import ServeConfig, ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    for arch, _, n_req in SSM_SERVE:
        cfg = get_config(arch)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        eng = ServeEngine(params, cfg, single_device_ctx(),
                          ServeConfig(slots=4, cache_len=96))
        work = build_workload(np.random.default_rng(0), n_req, cfg.vocab,
                              12, True)
        fin, wall, _ = _drain(eng, work)
        ticks = eng.comm_report()["serving"]["ticks"]
        eng.close()
        tokens = sum(len(v) for v in fin.values())
        check(len(fin) == n_req and all(
            len(fin[r]) == m for r, (_, m) in enumerate(work)),
            f"{arch}: served {len(fin)} of {n_req} requests")
        check(all(0 <= t < cfg.vocab for v in fin.values() for t in v),
              f"{arch}: a token outside the vocabulary")
        toks = torch.tensor([work[0][0]], device="cuda")
        with torch.no_grad():
            x, _ = forward(params, toks, cfg, single_device_ctx(),
                           remat=False)
            logits = lm_logits_local(params, x, cfg, single_device_ctx())
        check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
              f"{arch}: forward logits not finite")
        ssm = cfg.ssm
        every = cfg.hybrid.attn_every if cfg.hybrid else 0
        extra = (f", a shared attention block after each group of {every} "
                 f"({cfg.n_layers % every} remainder layers)" if every
                 else "")
        print(f"phase 17 ({'a' if cfg.family == 'ssm' else 'b'}): {arch} at "
              f"its published widths and depth (d_model {cfg.d_model}, "
              f"{cfg.n_layers} Mamba2 layers, d_state {ssm.d_state}, "
              f"{ssm.n_heads(cfg.d_model)} heads of {ssm.head_dim}, chunk "
              f"{ssm.chunk}{extra}), bf16, seed 0, {n_params / 1e9:.3f}B "
              f"params; wave engine: {len(fin)} requests, {tokens} tokens "
              f"in {ticks} ticks, {tokens / wall:.1f} tok/s over "
              f"{wall:.2f} s; forward logits finite; {card}")
        del params, eng
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(dp_family_rank, 2, backend="gloo", device="cuda",
                    timeout_s=900, args=("mamba2-1.3b", SSM_TRAIN_LAYERS,
                                         SSM_TRAIN_LR))
    print(f"phase 17 (a): ranks ran {time.perf_counter() - t0:.1f} s")
    return _dp_checks("17 (a)", f"mamba2-1.3b at its published widths "
                      f"(depth cut 48 -> {SSM_TRAIN_LAYERS}), bf16, seed 0, "
                      f"mesh (data=2)", res, SSM_TRAIN_LR, card)


# ---------------------------------------------------------------------------
# phase 18: the vlm and encdec families
# ---------------------------------------------------------------------------

#: (arch, depth kept) of phase 18 (b, c): InternVL2-76B's backbone at its
#: widths, 80 -> 4 layers (5.53B params, 11.1 GB in bf16; 8 until the
#: pod tier's phase 22 needed the time)
VLM_DEPTH = 4
#: phase 18 (c): the prefill program's batch (rows, text tokens; the
#: config's 256 stub patch rows go before the tokens)
PREFILL_BATCH, PREFILL_TOKENS = 2, 32
#: phase 18 (c): last-row logits of the (model=2) prefill against the one
#: rank's, relative L2 over the vocabulary.  Both are bf16 passes of one
#: model; the two-rank run sums each row-parallel combine's two bf16
#: halves (through K1 on the staged route) where the one rank takes one
#: matmul, so the gap is bf16 rounding, as phase 4's 0.0513 at 40 layers
#: is (the bound was set before this phase first ran: PERF.md)
PREFILL_TP_VS_ONE = 0.06
#: phase 18 (e): AdamW lr of Whisper-medium's DP training (1024 wide, as
#: phase 17's Mamba2 at 2048 takes 1e-3)
WHISPER_TRAIN_LR = 1e-3
#: phase 18 (e)'s Whisper depth, encoder and decoder (24 + 24, whole,
#: until phase 22 needed the time; phases 20 (b) and 22 (d) train it whole)
WHISPER_DP_DEPTH = 6


def _serve_zero_cross(eng, work, what):
    """Drain ``work`` through a wave engine of encdec and check its
    cross-attention cache stayed zero (the reference never writes it)."""
    fin, wall, _ = _drain(eng, work)
    check(not bool(eng.cache["xk"].any()) and not bool(
        eng.cache["xv"].any()), f"{what}: the cross-attention cache was "
          f"written")
    eng.close()
    return fin, wall


def _phase18a_reduced():
    """Reduced float32 internvl2 (paged kernel == paged dense gather ==
    wave, K6 launched layers x packed steps, packed-step logits within
    MOE_REDUCED_ATOL) and whisper (wave engine on the card == on the CPU,
    the cross-attention cache zero on both)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, single_device_ctx
    from repro_torch.serving.engine import (PagedServeConfig,
                                            PagedServeEngine, ServeConfig,
                                            ServeEngine)
    from torch.utils import _pytree as pytree
    rng = np.random.default_rng(3)
    cfg = get_config("internvl2-76b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    work = [(rng.integers(1, cfg.vocab, size=s).tolist(), 6)
            for s in (5, 3, 9, 2, 7, 12)]
    streams = {}
    for impl in ("kernel", "reference"):
        eng = PagedServeEngine(params, cfg, single_device_ctx(),
                               PagedServeConfig(max_requests=4, cache_len=96,
                                                kv_block=16,
                                                max_tokens_in_flight=16,
                                                min_bucket=4, attn_impl=impl))
        streams[impl], _, n = _drain(eng, work)
        steps = eng.serving_report()["steps"]
        eng.close()
        want = cfg.n_layers * steps if impl == "kernel" else 0
        check(n == want, f"reduced internvl2 {impl}: {n} K6 launches, "
              f"expected {want}")
    streams["wave"], _, _ = _drain(ServeEngine(
        params, cfg, single_device_ctx(), ServeConfig(slots=4,
                                                      cache_len=96)), work)
    check(streams["kernel"] == streams["reference"] == streams["wave"],
          f"reduced internvl2: greedy streams differ: {streams}")
    check(all(len(v) == 6 for v in streams["wave"].values()),
          "reduced internvl2: streams of the wrong length")
    err = (_packed_logits(cfg, params, "kernel")
           - _packed_logits(cfg, params, "reference")).abs().max().item()
    check(err < MOE_REDUCED_ATOL, f"reduced internvl2: packed-step logits "
          f"kernel vs dense gather {err} >= {MOE_REDUCED_ATOL}")
    print(f"phase 18 (a): reduced internvl2-76b f32 (TF32 off): paged "
          f"kernel == paged dense gather == wave on {len(work)} greedy "
          f"streams; packed-step logits max abs diff {err:.3g} (< "
          f"{MOE_REDUCED_ATOL})")
    cfg = get_config("whisper-medium").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    host = pytree.tree_map(lambda t: t.cpu(), params)
    fin = {}
    for where, p in (("card", params), ("host", host)):
        fin[where], _ = _serve_zero_cross(ServeEngine(
            p, cfg, single_device_ctx(), ServeConfig(slots=4, cache_len=96)),
            work, f"reduced whisper on the {where}")
    check(fin["card"] == fin["host"], f"reduced whisper: streams on the card "
          f"{fin['card']} differ from the CPU's {fin['host']}")
    check(all(len(v) == 6 for v in fin["card"].values()),
          "reduced whisper: streams of the wrong length")
    print(f"phase 18 (a): reduced whisper-medium f32 (TF32 off): wave engine "
          f"on the card == on the CPU on {len(work)} greedy streams; the "
          f"cross-attention cache stays zero on both (the reference's "
          f"served Whisper, pinned)")


def _pin_prefill(path: str, d_model: int):
    """Pin the model axis's all-reduce slots of the prefill's two combine
    sizes (the token embedding's, and the blocks' over the stub rows and
    the tokens, bf16) to TP_SHARES; returns the buckets."""
    return _pin_all_reduce(path, [PREFILL_BATCH * rows * d_model * 2 for rows
                                  in (PREFILL_TOKENS, PREFILL_TOKENS + 256)])


def _pin_data_axis_reduced(path: str):
    """Pin the data axis's all-reduce slots (2 ranks) of every gradient
    leaf size of reduced internvl2-76b in bf16 to TP_SHARES: the h100
    tuner gives such small payloads the primary route only, and the
    staged ring (K1) runs on sub-32-bit payloads alone.  Returns the
    buckets."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("internvl2-76b").reduced(),
                              param_dtype="bfloat16")
    leaves = pytree.tree_leaves(init_params(cfg, torch.Generator(), "cpu"))
    return _pin_all_reduce(path, [t.numel() * t.element_size()
                                  for t in leaves])


def prefill_rank(pinned: str, batch):
    """One rank of phase 18 (c): InternVL2-76B at its widths (depth cut to
    VLM_DEPTH, bf16, seed 0) on the (model=2) mesh, this rank's model-axis
    shards of the global init, through build_prefill_program with the
    model axis pinned by ``pinned``: a warm-up call, then the timed one,
    the kernel counts set to 0 just before it and read just after it,
    every plan it executed recorded."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.core.communicator import CommConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (build_prefill_program,
                                          local_params, rank_specs)
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=VLM_DEPTH)
    mesh = Mesh((1, 2), ("data", "model"))
    program, ctx = build_prefill_program(
        cfg, mesh, comm=CommConfig(profile="h100", tuning_cache=pinned),
        name="prefill")
    params = local_params(init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
        rank_specs(cfg, ctx), ctx)
    gc.collect()
    torch.cuda.empty_cache()
    calls = []
    execute = routing.execute

    def recorded(plan, x, m, **kw):
        calls.append((plan, m.axis_size(plan.axis_name), x.dtype))
        return execute(plan, x, m, **kw)

    routing.execute = recorded
    try:
        program(params, batch)              # warm-up: first-call costs
        torch.cuda.synchronize()
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        logits = program(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
    finally:
        routing.execute = execute
    program.close()
    want = collections.Counter()
    for plan, n, dtype in calls:
        want += codec_launches(plan, n, dtype)
    return {"logits": logits.float().cpu().numpy(), "k1": launches["k1"],
            "k1_want": want["k1"], "wall_s": wall,
            "combines": len(calls),
            "plans": sorted({plan.chunk_units for plan, _, _ in calls}),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _phase18bc_internvl2(card):
    """(b) InternVL2-76B at its widths, depth cut to VLM_DEPTH, through
    the paged engine with K6; (c) the prefill program on the same model,
    on one rank and on (model=2).  Returns (K6 launches of (b), K1
    launches of (c))."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import build_workload
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import init_params, single_device_ctx
    from repro_torch.serving.engine import PagedServeConfig, PagedServeEngine
    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, n_layers=VLM_DEPTH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    init_s = time.perf_counter() - t0
    eng = PagedServeEngine(params, cfg, single_device_ctx(), PagedServeConfig(
        max_requests=8, cache_len=96, kv_block=16, max_tokens_in_flight=32,
        attn_impl="kernel"))
    work = build_workload(np.random.default_rng(0), 8, cfg.vocab, 12, True)
    fin, wall, k6 = _drain(eng, work)
    rep = eng.serving_report()
    eng.close()
    steps = rep["steps"]
    tokens = sum(len(v) for v in fin.values())
    check(len(fin) == 8 and all(len(fin[r]) == m
                                for r, (_, m) in enumerate(work)),
          f"internvl2: served {len(fin)} of 8 requests")
    check(all(0 <= t < cfg.vocab for v in fin.values() for t in v),
          "internvl2: a token outside the vocabulary")
    check(k6 == VLM_DEPTH * steps, f"internvl2: K6 launched {k6} times, "
          f"expected {VLM_DEPTH} x {steps}")
    kern = _packed_logits(cfg, params, "kernel")
    dense = _packed_logits(cfg, params, "reference")
    check(kern.shape == (2, cfg.vocab_padded) and bool(
        torch.isfinite(kern).all()) and bool(torch.isfinite(dense).all()),
        f"internvl2: packed-step logits not finite or of shape "
        f"{tuple(kern.shape)}")
    gap = ((kern - dense).norm() / dense.norm()).item()
    check(gap < LOGITS_KERNEL_VS_DENSE, f"internvl2: packed-step logits "
          f"kernel vs dense bf16 rel L2 {gap} >= {LOGITS_KERNEL_VS_DENSE}")
    print(f"phase 18 (b): internvl2-76b backbone at its published widths "
          f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; depth cut "
          f"{full.n_layers} -> {VLM_DEPTH}), {cfg.param_dtype}, seed 0, "
          f"{n_params / 1e9:.3f}B params ({init_s:.1f} s to init), paged "
          f"engine with K6: {len(fin)} requests, {tokens} tokens, {steps} "
          f"packed steps, K6 launches {k6} = {VLM_DEPTH} x {steps}; "
          f"{tokens / wall:.1f} tok/s over {wall:.2f} s, median step "
          f"{rep['step_ms']['median']:.2f} ms; packed-step logits kernel vs "
          f"dense bf16 rel L2 {gap:.4g} (bound {LOGITS_KERNEL_VS_DENSE}); "
          f"{card}")
    rng = np.random.default_rng(18)
    batch = {"tokens": rng.integers(1, cfg.vocab, (
        PREFILL_BATCH, PREFILL_TOKENS)).astype(np.int32),
        "vis_embed": (rng.standard_normal((
            PREFILL_BATCH, cfg.vlm.n_vis_tokens, cfg.d_model)) * 0.02
        ).astype(np.float32)}
    step, _ = build_prefill_step(cfg, device="cuda")
    step(params, batch)                     # warm-up: first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = step(params, batch).float()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one = one.cpu()
    del params, eng, kern, dense, step
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        buckets = _pin_prefill(pinned, cfg.d_model)
        t0 = time.perf_counter()
        res = run_ranks(prefill_rank, 2, backend="gloo", device="cuda",
                        timeout_s=600, args=(pinned, batch))
        ranks_s = time.perf_counter() - t0
    two = torch.from_numpy(np.concatenate([r["logits"] for r in res], 1))
    check(one.shape == two.shape == (PREFILL_BATCH, cfg.vocab_padded),
          f"prefill logits of shape {tuple(one.shape)} / {tuple(two.shape)}")
    check(bool(torch.isfinite(one).all() and torch.isfinite(two).all()),
          "prefill logits not finite")
    rel = ((two - one).norm() / one.norm()).item()
    check(rel < PREFILL_TP_VS_ONE, f"prefill (model=2) vs one rank: rel L2 "
          f"{rel} >= {PREFILL_TP_VS_ONE}")
    k1 = sum(r["k1"] for r in res)
    for r, got in enumerate(res):
        check(got["k1"] == got["k1_want"] > 0, f"prefill rank {r}: K1 "
              f"launched {got['k1']}, the executed plans imply "
              f"{got['k1_want']}")
        check(got["combines"] == 1 + 2 * VLM_DEPTH, f"prefill rank {r}: "
              f"{got['combines']} model-axis combines, expected "
              f"{1 + 2 * VLM_DEPTH}")
    print(f"phase 18 (c): the prefill program on the same depth-"
          f"{VLM_DEPTH} model, batch {PREFILL_BATCH} x ({cfg.vlm.n_vis_tokens}"
          f" stub patch rows + {PREFILL_TOKENS} tokens), each timed on its "
          f"second call: one rank "
          f"{one_s * 1e3:.1f} ms, peak {one_peak:.2f} GiB; (model=2), 2 gloo "
          f"ranks on the card, model axis pinned to {TP_SHARES} at buckets "
          f"{buckets}, plans {res[0]['plans']}: {res[0]['combines']} "
          f"combines a rank, K1 launches {k1} over 2 ranks (= the plans'), "
          f"slower rank {max(r['wall_s'] for r in res) * 1e3:.1f} ms "
          f"({WALL_NOTE}), peak {max(r['peak_gib'] for r in res):.2f} GiB a "
          f"rank; ranks ran {ranks_s:.1f} s; last-row logits (model=2) vs "
          f"one rank rel L2 {rel:.4g} (bound {PREFILL_TP_VS_ONE}); {card}")
    return k6, k1


def _phase18d_whisper_serve(card, out_dir: pathlib.Path):
    """(d) Whisper-medium at its published widths and depth through the
    serving launcher on the wave engine: 4 requests of 10 tokens, every
    one served, the printed streams in the vocabulary, tok/s."""
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("whisper-medium")
    record = out_dir / "serve_whisper.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", "whisper-medium", "--requests", "4",
                         "--max-new", "10", "--device", "cuda", "--out",
                         str(record)])
    check(rc == 0, f"whisper serve launcher returned {rc}")
    rec = json.loads(record.read_text())
    streams = [json.loads(ln.split(":", 1)[1]) for ln in
               buf.getvalue().splitlines() if ln.startswith("  req ")]
    check(rec["requests"] == 4 and rec["engine"] == "wave"
          and rec["tokens"] == 40, f"whisper: served {rec['requests']} "
          f"requests, {rec['tokens']} tokens on the {rec['engine']} engine")
    check(len(streams) == 4 and all(
        len(v) == 10 and all(0 <= t < cfg.vocab for t in v)
        for v in streams), f"whisper: streams {streams}")
    print(f"phase 18 (d): whisper-medium at its published widths and depth "
          f"(d_model {cfg.d_model}, {cfg.encdec.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, {cfg.n_heads} heads of "
          f"{cfg.head_dim_}, {cfg.encdec.n_frames} frames, vocab "
          f"{cfg.vocab}), {cfg.param_dtype}, seed 0, through the serving "
          f"launcher on the wave engine: {rec['requests']} requests, "
          f"{rec['tokens']} tokens in {rec['serving']['ticks']} ticks, "
          f"{rec['tokens'] / rec['wall_s']:.1f} tok/s over {rec['wall_s']} "
          f"s; tokens in the vocabulary; {card}")


def phase18_vlm_encdec(card, out_dir: pathlib.Path):
    """(a) reduced float32 internvl2 and whisper; (b, c) InternVL2-76B at
    its widths (depth cut) served through K6 and through the prefill
    program on one rank and on (model=2); (d) Whisper-medium served whole
    through the serving launcher; (e) Whisper-medium whole and reduced
    internvl2 trained on (data=2).  Returns (K6 launches of (b), K1
    launches of (c) and of (e)'s two flexlink runs)."""
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    _phase18a_reduced()
    k6, k1_prefill = _phase18bc_internvl2(card)
    gc.collect()
    torch.cuda.empty_cache()
    _phase18d_whisper_serve(card, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    k1 = {"prefill": k1_prefill}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        buckets = _pin_data_axis_reduced(pinned)
        for arch, layers, reduced, lr, what, cache in (
                ("whisper-medium", WHISPER_DP_DEPTH, False, WHISPER_TRAIN_LR,
                 f"whisper-medium at its published widths (depth cut 24 + "
                 f"24 -> {WHISPER_DP_DEPTH} + {WHISPER_DP_DEPTH}), bf16, "
                 f"seed 0, mesh (data=2), stub frames in the batch", ""),
                ("internvl2-76b", None, True, 1e-3,
                 f"reduced internvl2-76b in bf16, seed 0, mesh (data=2), "
                 f"stub patch rows in the batch, the data axis's "
                 f"all-reduce slots at buckets {buckets} pinned to "
                 f"{TP_SHARES}", pinned)):
            t0 = time.perf_counter()
            res = run_ranks(dp_family_rank, 2, backend="gloo", device="cuda",
                            timeout_s=900, args=(arch, layers, lr, reduced,
                                                 cache))
            print(f"phase 18 (e): {arch} ranks ran "
                  f"{time.perf_counter() - t0:.1f} s")
            k1[arch] = _dp_checks("18 (e)", what, res, lr, card)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return k6, k1


# ---------------------------------------------------------------------------
# phase 19: serving across devices
# ---------------------------------------------------------------------------

#: phase 19 (a): reduced float32 archs, the cache's global length and the
#: decode steps; each rank's logits against the local decode within the
#: reference's own bound (tests/test_integration.py)
SERVE_REDUCED = ("glm4-9b", "zamba2-1.2b")
SERVE_REDUCED_SEQ, SERVE_REDUCED_STEPS, SERVE_REDUCED_BATCH = 16, 10, 4
SERVE_LOCAL_ATOL = 2e-3
#: (b): glm4-9b at full width and depth on (model=2): batch 8, a 4096
#: cache (2048 a rank), greedy steps from position 3072 over a filled
#: cache, so both shards' partials carry real keys
SERVE_BATCH, SERVE_SEQ, SERVE_POS, SERVE_STEPS = 8, 4096, 3072, 6
#: (c): batch 1 on (data=2, model=2): a 32768 cache (8192 a rank), steps
#: over a filled cache from a position just below the third shard's end:
#: the owner moves from shard 2 to 3 (data index 1), shards 0-2 hold real
#: keys, so both axes' merges combine partials with mass (6 steps from
#: 3 * 8192 - 4 until phase 22 needed the time)
LONG_SEQ, LONG_POS, LONG_STEPS = 32768, 3 * 8192 - 2, 4
#: (c)'s float32 pass: the same steps on the shards' first 8 layers
#: upcast (four ranks' whole shards in float32 would not fit the card)
LONG_F32_DEPTH = 8
#: (b)-(c): the filled caches' seed, and the positions drawn from one seed
#: (every cache slice of these runs is whole blocks of them)
KV_FILL_SEED, KV_FILL_BLOCK = 1919, 2048
#: (b)-(d): the sharded bf16 run's distance from one rank's float32 run
#: over one rank's bf16 distance (1.046-1.075 over an empty cache): bf16
#: depth and steps move both alike, a wrong combine moves the first
SHARDED_OVER_ONE = 1.2
#: (d): paged at (model=2): 8 requests' prompts packed in one step, then
#: greedy steps of one row a request
PAGED_TP_REQUESTS, PAGED_TP_GEN = 8, 6


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    """Relative L2 error of ``a`` against ``b`` (float64)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fill_kv(cache, cfg, seq_idx: int):
    """Fill a dense cache's ``k``/``v`` [L, B, S_local, kv, hd] with slice
    ``seq_idx`` of one global cache (every row, the global positions
    [seq_idx * S_local, (seq_idx + 1) * S_local)), the same on any mesh and
    on one rank: each KV_FILL_BLOCK positions of a layer drawn from their
    own seed, N(0, (0.02 sqrt(d_model))^2) (the std of the model's own
    K/V: a unit-RMS input through N(0, 0.02^2) weights), rounded to bf16,
    so a float32 cache holds the same values."""
    std = 0.02 * cfg.d_model ** 0.5
    n_layers, b, s_local, heads, hd = cache["k"].shape
    check(s_local % KV_FILL_BLOCK == 0, f"a cache slice of {s_local} "
          f"positions is not whole blocks of {KV_FILL_BLOCK}")
    gen = torch.Generator(device=cache["k"].device)
    for which, leaf in enumerate((cache["k"], cache["v"])):
        for layer in range(n_layers):
            for j in range(0, s_local, KV_FILL_BLOCK):
                blk = (seq_idx * s_local + j) // KV_FILL_BLOCK
                gen.manual_seed(((KV_FILL_SEED * 1000 + layer) * 1000
                                 + blk) * 2 + which)
                x = torch.randn((b, KV_FILL_BLOCK, heads, hd), generator=gen,
                                device=leaf.device) * std
                leaf[layer, :, j:j + KV_FILL_BLOCK] = x.to(
                    torch.bfloat16).to(leaf.dtype)


def _rank_params(cfg, ctx, mesh):
    """This rank's shards of the seed-0 global init, made on the card one
    rank at a time (a full-width tree is made whole before it is cut)."""
    import torch.distributed as dist
    from repro_torch.launch.steps import local_params, rank_specs
    from repro_torch.models.transformer import init_params
    params = None
    for r in range(mesh.world):
        if r == mesh.rank:
            full = init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0), "cuda")
            params = local_params(full, rank_specs(cfg, ctx), ctx)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        dist.barrier()
    return params


def _gather_logits(logits, mesh) -> np.ndarray:
    """Global [B, V] float32 logits on the host from every rank's
    [B_local, V_local] (the rows whole on every rank)."""
    return torch.cat(list(mesh.all_gather(logits.float(), "model")),
                     dim=1).cpu().numpy()


@contextlib.contextmanager
def _executed(calls: list):
    """Record every plan ``routing.execute`` runs in the block."""
    from repro_torch.core import routing
    execute = routing.execute

    def recorded(plan, x, m, **kw):
        calls.append((plan, m.axis_size(plan.axis_name), x.dtype))
        return execute(plan, x, m, **kw)

    routing.execute = recorded
    try:
        yield
    finally:
        routing.execute = execute


def _all_reduces(calls: list) -> int:
    """How many of the recorded plans are all-reduces (the combines; the
    rest are the Q gathers)."""
    return sum(plan.collective.value == "all_reduce" for plan, _, _ in calls)


def _q_ag_counts(ctx) -> collections.Counter:
    """Count the ctx's Q-gather issue scopes and the joins that read their
    results (the instance's methods are wrapped; a program's await_all
    joins no tree and is not counted)."""
    counts = collections.Counter()
    issue, join = ctx.issue, ctx.join_issued

    def counted_issue(tag, **kw):
        counts[f"{tag} issued"] += 1
        return issue(tag, **kw)

    def counted_join(tree):
        counts["joined"] += tree is not None    # not the step's await_all
        return join(tree)

    ctx.issue, ctx.join_issued = counted_issue, counted_join
    return counts


def _serve_reduced_rank(mesh, batch: int):
    """(a) on this rank: reduced float32 glm4-9b and zamba2-1.2b through
    the serve program (tuned, default h100 comm) for SERVE_REDUCED_STEPS
    teacher-forced steps; the largest gap of this rank's logits to (i) the
    decode over a local cache on the same ctx and (ii) one device's local
    decode of the whole batch (its block)."""
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import (build_serve_program,
                                          local_params, rank_specs)
    from repro_torch.models import single_device_ctx
    from repro_torch.models.transformer import (DecodeConfig, decode_step,
                                                init_cache, init_params)
    out = {}
    dp = mesh.axis_size("data")
    rows = batch // dp if batch > 1 else batch
    r0 = mesh.axis_index("data") * rows if batch > 1 else 0
    m = mesh.axis_index("model")
    for arch in SERVE_REDUCED:
        comm_destroy_all()
        cfg = get_config(arch).reduced()
        full = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        toks = np.random.default_rng(19).integers(
            1, cfg.vocab, (batch, SERVE_REDUCED_STEPS)).astype(np.int32)
        program, ctx, dcfg = build_serve_program(
            cfg, mesh, InputShape("a", "decode", SERVE_REDUCED_SEQ, batch),
            comm=CommConfig(profile="h100"), name="serve")
        params = local_params(full, rank_specs(cfg, ctx), ctx)
        counts = _q_ag_counts(ctx)
        cache = init_cache(cfg, ctx, dcfg, rows, device="cuda")
        local = DecodeConfig(SERVE_REDUCED_SEQ, seq_shard=None)
        lcache = init_cache(cfg, ctx, local, rows, device="cuda")
        one = init_cache(cfg, single_device_ctx(), local, batch,
                         device="cuda")
        gaps = {"local": 0.0, "one": 0.0}
        with torch.no_grad():
            for t in range(SERVE_REDUCED_STEPS):
                tok = toks[:, t:t + 1]
                mine = torch.from_numpy(tok[r0:r0 + rows]).to("cuda")
                logits, cache = program.step(params, cache, tok, t)
                lg, lcache = decode_step(params, lcache, mine, t, cfg, ctx,
                                         local)
                og, one = decode_step(full, one, torch.from_numpy(tok).to("cuda"),
                                      t, cfg, single_device_ctx(), local)
                v = logits.shape[1]
                og = og[r0:r0 + rows, m * v:(m + 1) * v]
                check(bool(torch.isfinite(logits).all()),
                      f"19 (a) {arch}: logits not finite")
                gaps["local"] = max(gaps["local"],
                                    (logits - lg).abs().max().item())
                gaps["one"] = max(gaps["one"],
                                  (logits - og).abs().max().item())
        torch.cuda.synchronize()
        program.close()
        out[arch] = {"gaps": gaps, "q_ag": dict(counts),
                     "seq_shard": dcfg.seq_shard,
                     "cache_len_local": dcfg.cache_len_local}
    comm_destroy_all()
    return out


def _paged_tp_inputs(vocab: int):
    """(d)'s packed first step: 8 mixed requests' prompts (the serving
    launcher's workload), one row a prompt token, each request's blocks
    after the last's; and the block tables."""
    from repro_torch.launch.serve import build_workload
    work = build_workload(np.random.default_rng(0), PAGED_TP_REQUESTS, vocab,
                          12, True)
    lens = [len(p) for p, _ in work]
    maxb = -(-(max(lens) + PAGED_TP_GEN) // BS)
    tables = torch.arange(PAGED_TP_REQUESTS * maxb,
                          dtype=torch.int32).reshape(PAGED_TP_REQUESTS, maxb)
    tokens = torch.tensor([t for p, _ in work for t in p])
    row_req = torch.tensor([i for i, n in enumerate(lens) for _ in range(n)])
    positions = torch.tensor([j for n in lens for j in range(n)])
    sample = torch.tensor(np.cumsum(lens) - 1)
    return (tokens, positions, row_req, tables, sample), lens, maxb


def _paged_tp(params, cfg, ctx, mesh=None):
    """(d): the packed first step, then PAGED_TP_GEN greedy steps of one
    row a request, through paged_decode_step with K6 on ``ctx`` (its
    model axis, or one device): the first step's global logits, the
    stream and K6's launches; the counts set to 0 just before and read
    just after."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import (PagedConfig, init_paged_pool,
                                                paged_decode_step)
    packed, lens, maxb = _paged_tp_inputs(cfg.vocab)
    pcfg = PagedConfig(block_size=BS, n_blocks=PAGED_TP_REQUESTS * maxb,
                       max_blocks_per_req=maxb, attn_impl="kernel")
    pool = init_paged_pool(cfg, ctx, pcfg, device="cuda")
    packed = [t.to("cuda") for t in packed]
    tables = packed[3]
    n = PAGED_TP_REQUESTS
    stream, first, seen = [], None, []
    steps = 1 + (PAGED_TP_GEN if mesh is not None else 0)
    torch.cuda.synchronize()
    fd.launch_count = 0
    t0 = time.perf_counter()
    with torch.no_grad(), _k6_inputs(seen if mesh is not None else None):
        for g in range(steps):
            logits, pool = paged_decode_step(params, pool, *packed, cfg, ctx,
                                             pcfg)
            full = (_gather_logits(logits, mesh) if mesh is not None
                    else logits.float().cpu().numpy())
            if g == 0:
                first = full
            tok = torch.from_numpy(full.argmax(-1))
            stream.append(tok.tolist())
            pos = torch.tensor([ln + g for ln in lens], device="cuda")
            packed = [tok.to("cuda"), pos, torch.arange(n, device="cuda"),
                      tables, torch.arange(n, device="cuda")]
    torch.cuda.synchronize()
    out = {"first": first, "stream": stream, "k6": fd.launch_count,
           "steps": steps, "wall_s": time.perf_counter() - t0}
    # every K6 call of the sharded run against its plain version on the
    # same inputs, after the counts were read
    out["k6_err"], out["k6_shapes"] = 0.0, set()
    for args, kw in seen:
        got = fd.paged_flash_decode_pool(*args, **kw)
        want = ref.paged_flash_decode_ref(*args, **kw)
        out["k6_err"] = max(out["k6_err"],
                            (got.float() - want.float()).abs().max().item())
        q, kp, _, tables, _ = args
        out["k6_shapes"].add((q.shape[0], q.shape[1], kp.shape[2],
                              q.shape[2], tables.shape[1], str(q.dtype)[6:]))
    out["k6_checked"] = len(seen)
    return out


@contextlib.contextmanager
def _k6_inputs(seen):
    """Within the block, every K6 call's inputs, cloned, join the list
    ``seen`` (nothing is recorded when it is None); the wrapper and its
    count are untouched."""
    from repro_torch.kernels import flash_decode as fd
    launch = fd.paged_flash_decode_pool

    def recorded(*args, **kw):
        seen.append(([a.clone() for a in args], kw))
        return launch(*args, **kw)

    if seen is not None:
        fd.paged_flash_decode_pool = recorded
    try:
        yield
    finally:
        fd.paged_flash_decode_pool = launch


def serve_tp_rank(pinned: str):
    """One rank of phase 19 on (model=2): (a) reduced float32 glm4-9b and
    zamba2-1.2b at batch SERVE_REDUCED_BATCH; (b) glm4-9b at its published
    widths and depth through the serve program, the model axis pinned by
    ``pinned``, SERVE_STEPS greedy steps (the argmax of the logits
    gathered over the model axis), each step issued and awaited, the
    kernel counts set to 0 just before the run and read just after it,
    every executed plan recorded; (d) paged_decode_step through K6 on the
    same shards."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_serve_program
    from repro_torch.models.transformer import init_cache
    from repro_torch.runtime.program import meta_like
    mesh = Mesh((1, 2), ("data", "model"))
    out = {"a": _serve_reduced_rank(mesh, SERVE_REDUCED_BATCH)}
    cfg = get_config("glm4-9b")
    comm_destroy_all()
    program, ctx, dcfg = build_serve_program(
        cfg, mesh, InputShape("b", "decode", SERVE_SEQ, SERVE_BATCH),
        comm=CommConfig(profile="h100", tuning_cache=pinned), name="serve")
    params = _rank_params(cfg, ctx, mesh)
    cache = init_cache(cfg, ctx, dcfg, SERVE_BATCH, device="cuda")
    _fill_kv(cache, cfg, mesh.axis_index("model"))
    tok = np.random.default_rng(19).integers(
        1, cfg.vocab, (SERVE_BATCH, 1)).astype(np.int32)
    # the program lowered on meta copies of the first step's arguments,
    # before the Q gathers are counted
    lowered = program.lower(*meta_like((params, cache, tok, SERVE_POS)))
    counts = _q_ag_counts(ctx)
    live = []
    stream, calls, ms, k1_calls = [tok[:, 0]], [], [], set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernel_counts(reset=True)
    with _executed(calls), recorded_calls(k1_calls):
        for t in range(SERVE_STEPS):
            t0 = time.perf_counter()
            with mesh.tracing() as log:
                program.issue(params, cache, stream[-1][:, None],
                              SERVE_POS + t)
            if t == 0:
                live.append((log, ctx.plan_signature("serve")))
            logits, cache = program.await_all()[-1]
            full = _gather_logits(logits, mesh)
            ms.append((time.perf_counter() - t0) * 1e3)
            stream.append(full.argmax(-1).astype(np.int32))
    torch.cuda.synchronize()
    launches = _kernel_counts()
    want = collections.Counter()
    for plan, n, dtype in calls:
        want += codec_launches(plan, n, dtype)
    rep = program.report()
    program.close()
    out["b"] = {"stream": np.stack(stream, 1), "last": full, "ms": ms,
                "k1": launches["k1"], "k1_want": want["k1"],
                "k1_calls": k1_calls,
                "combines": _all_reduces(calls), "q_ag": dict(counts),
                "plans": sorted({plan.chunk_units for plan, _, _ in calls}),
                "issued": rep["issued"], "awaits": rep["awaits"],
                "cache_len_local": dcfg.cache_len_local,
                "lowered": _lowered_vs_live(lowered, live),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    out["d"] = _paged_tp(params, cfg, ctx, mesh)
    out["b32"] = _serve_f32(cfg, mesh, pinned, params,
                            out["b"]["stream"][:, :SERVE_STEPS],
                            InputShape("b", "decode", SERVE_SEQ, SERVE_BATCH),
                            SERVE_POS, mesh.axis_index("model"))[-1]
    comm_destroy_all()
    return out


def _serve_f32(cfg, mesh, pinned, params, tokens, shape, pos0: int,
               seq_idx: int):
    """The serve program once more on this rank's shards ``params``
    upcast to float32 (TF32 off), over the same filled cache (its slice
    ``seq_idx``): the global ``tokens`` [B, steps] fed from ``pos0``, free
    of bf16 rounding; every step's global logits."""
    import dataclasses
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch.steps import build_serve_program
    from repro_torch.models.transformer import init_cache
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    params = _tree(lambda t: t.float(), params)
    comm_destroy_all()
    program, ctx, dcfg = build_serve_program(
        cfg, mesh, shape, comm=CommConfig(profile="h100",
                                          tuning_cache=pinned), name="serve")
    cache = init_cache(cfg, ctx, dcfg, tokens.shape[0], device="cuda")
    _fill_kv(cache, cfg, seq_idx)
    out = []
    for t in range(tokens.shape[1]):
        program.issue(params, cache, tokens[:, t:t + 1], pos0 + t)
        logits, cache = program.await_all()[-1]
        out.append(_gather_logits(logits, mesh))
    program.close()
    return out


def _cut(params, depth: int):
    """A dense tree's first ``depth`` layers (views of the stacks)."""
    return {k: _tree(lambda t: t[:depth], v) if k == "layers" else v
            for k, v in params.items()}


def serve_long_rank(pinned: str, tokens):
    """One rank of phase 19 on (data=2, model=2): (a) reduced float32
    glm4-9b and zamba2-1.2b at batch 1 (the cache over data x model); (c)
    glm4-9b at its published widths and depth, batch 1, the model axis
    pinned by ``pinned``, LONG_STEPS steps of ``tokens`` from LONG_POS,
    the kernel counts set to 0 just before the run and read just after
    it, every executed plan recorded; then the same steps on the shards'
    first LONG_F32_DEPTH layers upcast to float32."""
    import dataclasses
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_serve_program
    from repro_torch.models.transformer import init_cache
    mesh = Mesh((2, 2), ("data", "model"))
    out = {"a": _serve_reduced_rank(mesh, 1)}
    cfg = get_config("glm4-9b")
    comm_destroy_all()
    program, ctx, dcfg = build_serve_program(
        cfg, mesh, InputShape("c", "decode", LONG_SEQ, 1),
        comm=CommConfig(profile="h100", tuning_cache=pinned), name="serve")
    params = _rank_params(cfg, ctx, mesh)
    cache = init_cache(cfg, ctx, dcfg, 1, device="cuda")
    # the reference's layout of the batch-1 cache: data major
    seq_idx = (mesh.axis_index("data") * mesh.axis_size("model")
               + mesh.axis_index("model"))
    _fill_kv(cache, cfg, seq_idx)
    counts = _q_ag_counts(ctx)
    logits_all, calls, ms, k1_calls = [], [], [], set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernel_counts(reset=True)
    with _executed(calls), recorded_calls(k1_calls):
        for t in range(LONG_STEPS):
            t0 = time.perf_counter()
            program.issue(params, cache, tokens[:, t:t + 1], LONG_POS + t)
            logits, cache = program.await_all()[-1]
            logits_all.append(_gather_logits(logits, mesh))
            ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = _kernel_counts()
    want = collections.Counter()
    for plan, n, dtype in calls:
        want += codec_launches(plan, n, dtype)
    program.close()
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    c32 = _serve_f32(dataclasses.replace(cfg, n_layers=LONG_F32_DEPTH), mesh,
                     pinned, _cut(params, LONG_F32_DEPTH), tokens,
                     InputShape("c", "decode", LONG_SEQ, 1), LONG_POS,
                     seq_idx)
    comm_destroy_all()
    return dict(out, c32=c32, c={
        "logits": logits_all, "ms": ms,
        "k1": launches["k1"], "k1_want": want["k1"], "k1_calls": k1_calls,
        "combines": _all_reduces(calls),
        "q_ag": dict(counts), "seq_shard": dcfg.seq_shard,
        "plans": sorted({plan.chunk_units for plan, _, _ in calls}),
        "cache_len_local": dcfg.cache_len_local,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def _one_rank_decode(params, cfg, tokens, pos0: int, seq: int):
    """One device's decode over a local cache of ``seq`` filled as the
    sharded runs' (``_fill_kv``), the global ``tokens`` [B, steps] fed from
    ``pos0``: each step's float32 logits on the host."""
    from repro_torch.models import single_device_ctx
    from repro_torch.models.transformer import (DecodeConfig, decode_step,
                                                init_cache)
    dcfg = DecodeConfig(seq, seq_shard=None)
    cache = init_cache(cfg, single_device_ctx(), dcfg, tokens.shape[0],
                       device="cuda")
    _fill_kv(cache, cfg, 0)
    out = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            lg, cache = decode_step(params, cache, torch.from_numpy(
                np.ascontiguousarray(tokens[:, t:t + 1])).to("cuda"), pos0 + t,
                cfg, single_device_ctx(), dcfg)
            out.append(lg.float().cpu().numpy())
    del cache
    return out


def _phase19a_line(mesh: str, res, card):
    """Check and print (a)'s gaps on one mesh (every rank's)."""
    for arch in SERVE_REDUCED:
        local = max(r["a"][arch]["gaps"]["local"] for r in res)
        one = max(r["a"][arch]["gaps"]["one"] for r in res)
        q = res[0]["a"][arch]["q_ag"]
        check(local < SERVE_LOCAL_ATOL, f"19 (a) {arch} on {mesh}: logits vs "
              f"the local-cache decode max abs {local} >= {SERVE_LOCAL_ATOL}")
        # a Mamba2 block at tp > 1 normalises its gated output over each
        # shard's heads (the reference's), so only attention families
        # equal one device's decode
        if arch != "zamba2-1.2b":
            check(one < SERVE_LOCAL_ATOL, f"19 (a) {arch} on {mesh}: logits "
                  f"vs one rank's decode max abs {one} >= "
                  f"{SERVE_LOCAL_ATOL}")
        print(f"phase 19 (a): reduced {arch} f32 (TF32 off) through the "
              f"serve program on {mesh}, seq_shard "
              f"{res[0]['a'][arch]['seq_shard']!r}, cache "
              f"{res[0]['a'][arch]['cache_len_local']} a rank, "
              f"{SERVE_REDUCED_STEPS} steps: every rank's logits vs the "
              f"local-cache decode on the same ranks max abs {local:.3g}, "
              f"vs one rank's local decode {one:.3g} (bound "
              f"{SERVE_LOCAL_ATOL}"
              + ("; not bounded: the SSM's per-shard norm" if arch ==
                 "zamba2-1.2b" else "")
              + f"); Q gathers {q.get('q_ag issued', 0)} issued, "
              f"{q.get('joined', 0)} joined a rank; {card}")


def _one_rank_refs(cfg, run):
    """``run(params, cfg)`` on one rank with the seed-0 weights in bf16,
    then on the same weights upcast to float32 (TF32 off): the two
    results."""
    import dataclasses
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    bf16 = run(params, cfg)
    params = _tree(lambda t: t.float(), params)
    f32 = run(params, dataclasses.replace(cfg, param_dtype="float32"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return bf16, f32


def _vs_float32(what, tp, one, f32, v, bounded=True):
    """Relative L2 of the sharded and of one rank's bf16 logits against
    the float32 run's (over the vocabulary, the largest over the steps
    given), each bounded as phase 4's bf16 paths are (unless
    ``bounded`` is false: (b) and (c), many steps over a filled cache,
    whose float32 check is the sharded program's own float32 run), and
    the first over the second
    below SHARDED_OVER_ONE; and the gap between the two bf16 runs,
    printed."""
    err_tp = max(_rel(g[:, :v], w[:, :v]) for g, w in zip(tp, f32))
    err_one = max(_rel(g[:, :v], w[:, :v]) for g, w in zip(one, f32))
    gap = max(_rel(g[:, :v], w[:, :v]) for g, w in zip(tp, one))
    check(all(bool(np.isfinite(g[:, :v]).all()) for g in tp + one + f32),
          f"{what}: logits not finite")
    for name, err in (("the sharded run", err_tp), ("one rank", err_one)):
        check(not bounded or err < LOGITS_VS_FLOAT32, f"{what}: {name}'s "
              f"bf16 logits vs the float32 run rel L2 {err} >= "
              f"{LOGITS_VS_FLOAT32} (sharded {err_tp}, one rank {err_one})")
    check(err_tp < SHARDED_OVER_ONE * err_one, f"{what}: the sharded run's "
          f"distance from the float32 run {err_tp} is {err_tp / err_one} "
          f"times one rank's {err_one} (bound {SHARDED_OVER_ONE})")
    bound = (f"bound {LOGITS_VS_FLOAT32} each, phase 4's" if bounded else
             "not bounded: phase 4's is one packed step's over a short cache; "
             "the float32 pass holds this run")
    return (f"logits rel L2 vs one rank's float32 run: sharded bf16 "
            f"{err_tp:.4g}, one rank's bf16 {err_one:.4g} ({bound}), "
            f"sharded over one rank {err_tp / err_one:.3f} (bound "
            f"{SHARDED_OVER_ONE}); sharded vs one rank's bf16 {gap:.4g}")


def phase19_serve_sharded(card):
    """(a) reduced float32 glm4-9b and zamba2-1.2b through the serve
    program on (model=2) and on (data=2, model=2), against the local
    decode; (b) glm4-9b whole on (model=2), batch 8, 8 greedy steps; (c)
    the same model, batch 1, the cache over (data=2, model=2); (d)
    paged_decode_step through K6 at (model=2).  (b)-(d) hold the sharded
    bf16 logits and one rank's against one rank's float32 run of the same
    tokens, (b) and (c) also the sharded program in float32 against it
    ((c) on the first LONG_F32_DEPTH layers); each K1 table and K6 call of
    the sharded runs is then held against its plain version.  Returns (K1 launches of (b) and (c), K6
    launches of (d), the K1 bit check's max abs err and tables)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import single_device_ctx
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("glm4-9b")
    d, v = cfg.d_model, cfg.vocab
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        buckets = _pin_all_reduce(pinned, (SERVE_BATCH * d * 2, d * 2))
        t0 = time.perf_counter()
        tp = run_ranks(serve_tp_rank, 2, backend="gloo", device="cuda",
                       timeout_s=900, args=(pinned,))
        tp_s = time.perf_counter() - t0
        b = [r["b"] for r in tp]
        # one rank's references of (b) and (d), before (c)'s ranks

        def refs_bd(params, c):
            return (_one_rank_decode(params, c, b[0]["stream"][:, :-1],
                                     SERVE_POS, SERVE_SEQ)[-1],
                    _paged_tp(params, c, single_device_ctx()))
        (one_b, d_one), (one_b32, d_one32) = _one_rank_refs(cfg, refs_bd)
        long_tokens = np.random.default_rng(191).integers(
            1, cfg.vocab, (1, LONG_STEPS)).astype(np.int32)
        t0 = time.perf_counter()
        lg = run_ranks(serve_long_rank, 4, backend="gloo", device="cuda",
                       timeout_s=900, args=(pinned, long_tokens))
        long_s = time.perf_counter() - t0
    _phase19a_line("(model=2)", tp, card)
    _phase19a_line("(data=2, model=2)", lg, card)
    # (b)
    _check_lowered("19 (b)", [r["lowered"] for r in b])
    check(all(np.array_equal(r["stream"], b[0]["stream"]) for r in b),
          "19 (b): the ranks' greedy streams differ")
    check(all(0 <= t < v for t in b[0]["stream"].ravel()),
          "19 (b): a token outside the vocabulary")
    check(b[0]["last"].shape == (SERVE_BATCH, cfg.vocab_padded),
          f"19 (b): logits of shape {b[0]['last'].shape}")
    vs_b = _vs_float32("19 (b), the last step", [b[0]["last"]], [one_b],
                       [one_b32], v, bounded=False)
    # the sharded program in float32 against one rank's float32 run of the
    # same tokens: the reference's bound, as (a)
    b32 = max(float(np.abs(r["b32"][:, :v] - one_b32[:, :v]).max())
              for r in tp)
    check(b32 < SERVE_LOCAL_ATOL, f"19 (b) float32: the last step's logits "
          f"vs one rank's float32 run max abs {b32} >= {SERVE_LOCAL_ATOL}")
    n_combines = (1 + 2 * cfg.n_layers) * SERVE_STEPS
    for r, got in enumerate(b):
        check(got["k1"] == got["k1_want"] > 0, f"19 (b) rank {r}: K1 "
              f"launched {got['k1']}, the executed plans imply "
              f"{got['k1_want']}")
        check(got["combines"] == n_combines, f"19 (b) rank {r}: "
              f"{got['combines']} model-axis combines, expected {n_combines}")
        check(got["q_ag"].get("q_ag issued") == got["q_ag"].get("joined")
              == cfg.n_layers * SERVE_STEPS, f"19 (b) rank {r}: Q gathers "
              f"{got['q_ag']}, expected {cfg.n_layers} a step")
        check(got["issued"] == got["awaits"] == SERVE_STEPS, f"19 (b) rank "
              f"{r}: {got['issued']} steps issued, {got['awaits']} awaited")
    k1_b = sum(r["k1"] for r in b)
    ms_b = statistics.median(max(r["ms"][t] for r in b)
                             for t in range(1, SERVE_STEPS))
    print(f"phase 19 (b): glm4-9b at its published widths and depth "
          f"({cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads), "
          f"bf16, seed 0, through the serve program on (model=2), 2 gloo "
          f"ranks on the card, batch {SERVE_BATCH}, cache {SERVE_SEQ} "
          f"sequence-sharded over model ({b[0]['cache_len_local']} a rank, "
          f"every KV head), the model axis's all-reduce pinned to "
          f"{TP_SHARES} at buckets {buckets}, plans {b[0]['plans']}: "
          f"the cache filled (seed {KV_FILL_SEED}), {SERVE_STEPS} greedy "
          f"steps from {SERVE_POS} (argmax of the gathered logits), "
          f"streams equal on both ranks, median {ms_b:.1f} ms a step (the "
          f"slower rank, steps 2-{SERVE_STEPS}; first {b[0]['ms'][0]:.1f} "
          f"ms; {WALL_NOTE}), peak {max(r['peak_gib'] for r in b):.2f} GiB "
          f"a rank; {b[0]['combines']} combines a rank, K1 launches {k1_b} "
          f"over 2 ranks (= the plans'); Q gathers "
          f"{b[0]['q_ag']['q_ag issued']} issued, {b[0]['q_ag']['joined']} "
          f"joined, steps {b[0]['issued']} issued / {b[0]['awaits']} awaited "
          f"a rank; last step's {vs_b}; the same {SERVE_STEPS} steps in "
          f"float32 (the shards upcast, TF32 off): last step's logits vs "
          f"one rank's float32 run max abs {b32:.3g} (bound "
          f"{SERVE_LOCAL_ATOL}); ranks ran {tp_s:.1f} s; {card}")
    # (c)
    c = [r["c"] for r in lg]
    def refs_c(params, cf):
        run = _one_rank_decode(params, cf, long_tokens, LONG_POS, LONG_SEQ)
        if cf.param_dtype != "float32":
            return run, None
        return run, _one_rank_decode(
            _cut(params, LONG_F32_DEPTH), dataclasses.replace(
                cf, n_layers=LONG_F32_DEPTH), long_tokens, LONG_POS,
            LONG_SEQ)
    (one_c, _), (one_c32, one_c32_cut) = _one_rank_refs(cfg, refs_c)
    # every rank's logits: a data-axis merge that drops a partial shows on
    # either data index
    vs_c = _vs_float32("19 (c), every rank", [g for r in c for g in
                                             r["logits"]],
                       one_c * len(c), one_c32 * len(c), v, bounded=False)
    c32 = max(float(np.abs(g[:, :v] - w[:, :v]).max())
              for r in lg for g, w in zip(r["c32"], one_c32_cut))
    check(c32 < SERVE_LOCAL_ATOL, f"19 (c) float32 depth {LONG_F32_DEPTH}: "
          f"every rank's logits vs one rank's float32 run max abs {c32} >= "
          f"{SERVE_LOCAL_ATOL}")
    for r, got in enumerate(c):
        check(got["k1"] == got["k1_want"] > 0, f"19 (c) rank {r}: K1 "
              f"launched {got['k1']}, the executed plans imply "
              f"{got['k1_want']}")
        check(got["q_ag"].get("q_ag issued") == got["q_ag"].get("joined")
              == cfg.n_layers * LONG_STEPS, f"19 (c) rank {r}: Q gathers "
              f"{got['q_ag']}")
    k1_c = sum(r["k1"] for r in c)
    ms_c = statistics.median(max(r["ms"][t] for r in c)
                             for t in range(1, LONG_STEPS))
    print(f"phase 19 (c): the same model, batch 1, seq_shard "
          f"{c[0]['seq_shard']!r} on (data=2, model=2), 4 gloo ranks on the "
          f"card, cache {LONG_SEQ} ({c[0]['cache_len_local']} a rank), "
          f"the cache filled (seed {KV_FILL_SEED}), {LONG_STEPS} steps from "
          f"position {LONG_POS} (the owning shard moves 2 -> 3), plans "
          f"{c[0]['plans']}: median {ms_c:.1f} ms a "
          f"step (first {c[0]['ms'][0]:.1f} ms; {WALL_NOTE}), peak "
          f"{max(r['peak_gib'] for r in c):.2f} GiB a rank; "
          f"{c[0]['combines']} combines a rank, K1 launches {k1_c} over 4 "
          f"ranks (= the plans'); the largest over the steps and ranks of "
          f"the {vs_c} (one rank's cache {LONG_SEQ}); the same steps on the "
          f"shards' first {LONG_F32_DEPTH} layers in float32: every rank's "
          f"logits vs one rank's float32 run of those layers max abs "
          f"{c32:.3g} (bound {SERVE_LOCAL_ATOL}); ranks ran {long_s:.1f} s; "
          f"{card}")
    # (d)
    dd = [r["d"] for r in tp]
    k6 = sum(r["k6"] for r in dd)
    for r, got in enumerate(dd):
        check(got["k6"] == cfg.n_layers * got["steps"], f"19 (d) rank {r}: "
              f"K6 launched {got['k6']}, expected {cfg.n_layers} x "
              f"{got['steps']}")
        check(got["k6_checked"] == got["k6"] and got["k6_err"] <= ATOL[
            torch.bfloat16], f"19 (d) rank {r}: {got['k6_checked']} K6 calls "
            f"held against the plain version, max abs err {got['k6_err']} "
            f"(atol {ATOL[torch.bfloat16]})")
    for got in (d_one, d_one32):
        check(got["k6"] == cfg.n_layers, f"19 (d) one rank: K6 launched "
              f"{got['k6']}, expected {cfg.n_layers}")
    check(dd[0]["stream"] == dd[1]["stream"], "19 (d): the ranks' streams "
          "differ")
    vs_d = _vs_float32("19 (d), the packed step", [dd[0]["first"]],
                       [d_one["first"]], [d_one32["first"]], v)
    _, lens, _ = _paged_tp_inputs(cfg.vocab)
    print(f"phase 19 (d): paged_decode_step through K6 on the same model "
          f"at (model=2) (Hq_l {cfg.n_heads // 2}, kv_w 1, group "
          f"{cfg.n_heads // 2}, hd {cfg.head_dim_}): {PAGED_TP_REQUESTS} "
          f"requests' prompts ({sum(lens)} rows) packed in one step, then "
          f"{PAGED_TP_GEN} greedy steps: K6 launches {k6} over 2 ranks "
          f"({cfg.n_layers} x {dd[0]['steps']} a rank), {dd[0]['wall_s']:.2f} "
          f"s a rank ({WALL_NOTE}); every K6 call of both ranks on its own "
          f"inputs vs the plain version (T, Hq_l, kv_w, hd, maxb, dtype "
          f"{sorted(set().union(*(r['k6_shapes'] for r in dd)))}): max abs "
          f"err {max(r['k6_err'] for r in dd):.3g}; the packed step's {vs_d} "
          f"(one rank through K6 in both dtypes); {card}")
    # (b) and (c): every K1 segment table the serve programs launched, bit
    # for bit against the plain version
    k1_err, _, k1_tables = phase12_main_path_check(
        set().union(*(r["k1_calls"] for r in b + c)), phase="19",
        required=("k1",))
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return ({"tp2": k1_b, "model_data": k1_c}, k6,
            k1_err.get("k1", 0.0), k1_tables)


# ---------------------------------------------------------------------------
# phase 20: the two-tier cluster
# ---------------------------------------------------------------------------

#: phase 20: (node, data) of the cluster mesh; the flat run's data axis
CLUSTER_MESH = (2, 2)
#: the NIC tier's pin (rail = primary, xrail = staged, host_tcp = the ortho
#: detour over the data axis); the data axis takes TP_SHARES
NIC_SHARES = {"rail": 50, "xrail": 25, "host_tcp": 25}
#: (a): bytes a rank (256 MiB until phase 22 needed the time)
CLUSTER_BYTES = 64 * MiB
CLUSTER_COLS = 4096
CLUSTER_OPS = ("all_reduce", "all_gather", "reduce_scatter")
#: (b): Whisper-medium rows a rank (global batch 32 on both meshes)
CLUSTER_ROWS = 8
#: (b): the cluster run's losses against the flat run's: the reference's
#: own bound (tests/test_cluster.py test_multi_node_train_matches_single_
#: node)
CLUSTER_VS_FLAT = 5e-3
#: (b): steps of each run (3 until phase 21 needed the time)
CLUSTER_STEPS = 2


def _pin_cluster(path: str) -> str:
    """Pin both tiers of ``cluster_for("h100", 2)`` at every size bucket
    and collective of the hierarchical compositions: the data axis (the
    intra tier, 2 ranks, no ortho axis on (node, data): primary and
    staged) to TP_SHARES, the node axis (the NIC tier) to NIC_SHARES;
    returns the NIC tier's profile name."""
    from repro_torch.cluster.topology import cluster_for
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.communicator import SIZE_BUCKETS
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    nic = cluster_for("h100", CLUSTER_MESH[0]).nic_tier.name
    prof = TuningProfile(path)
    for profile, n, shares in (("h100", CLUSTER_MESH[1], TP_SHARES),
                               (nic, CLUSTER_MESH[0], NIC_SHARES)):
        for op in CLUSTER_OPS:
            for bucket in SIZE_BUCKETS:
                prof.record(profile, "ring", Collective(op), n, bucket,
                            SHARE_GRID, shares)
    prof.save(path)
    return nic


def _cluster_op(comm, op, x):
    if op == "all_gather":
        return comm.all_gather(x, tiled=True)
    return getattr(comm, op)(x)


def cluster_rank(pinned: str):
    """One rank of phase 20 on (node=2, data=2): (a) the ctx's
    ClusterCommunicator's hierarchical collectives at CLUSTER_BYTES of
    bfloat16 and float32 (``_pattern`` payloads, [rows, CLUSTER_COLS]),
    every executed plan and K1 call recorded, the kernel counts set to 0
    just before and read just after; the N=1 parity on (data=4); (b) Whisper-medium whole,
    bf16, seed 0, CLUSTER_STEPS flexlink steps on (node=2, data=2) and then
    on (data=4), the same global batch."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    from repro_torch.cluster.communicator import ClusterCommunicator
    from repro_torch.cluster.topology import cluster_for
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import (CommConfig, FlexCommunicator,
                                               comm_destroy_all)
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_train_program
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    mesh = Mesh(CLUSTER_MESH, ("node", "data"))
    flat = Mesh((4,), ("data",))
    rank, dev = mesh.rank, mesh.device
    comm = CommConfig(profile="h100", tuning_cache=pinned)
    ctx = ParallelCtx(dp_axis="data", node_axis="node",
                      dp_size=CLUSTER_MESH[1], node_size=CLUSTER_MESH[0],
                      comm_config=comm, mesh=mesh)
    cc = ctx._cluster_comm
    out = {"a": {}, "calls": set(), "nic": ctx.cluster.nic_tier.name,
           "axes": [c.axis_name for c in ctx.comms()]}
    for dtype in (torch.bfloat16, torch.float32):
        # [rows, 4096], as phase 7's A_SHAPE: a 1-D payload is one column
        # of the reduce-scatter's column partition, padded to the grain
        x = _pattern(CLUSTER_BYTES // dtype.itemsize, rank, dev).to(
            dtype).reshape(-1, CLUSTER_COLS)
        for op in CLUSTER_OPS:
            calls = []
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with _executed(calls), recorded_calls(out["calls"]):
                y = _cluster_op(cc, op, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            want = collections.Counter()
            for plan, n, dt in calls:
                want += codec_launches(plan, n, dt)
            out["a"][op, str(dtype)[6:]] = {
                "digest": _digest(y), "wall_s": wall,
                "k1": launches["k1"], "k1_want": want["k1"],
                "plans": sorted({(plan.axis_name, plan.collective.value,
                                  plan.chunk_units, plan.staged_substeps)
                                 for plan, _, _ in calls})}
            del y
        del x
    out["signature"] = repr(ctx.plan_signature())
    # N=1: the intra tier alone on (data=4) is the bare communicator
    tuned = CommConfig(profile="h100")
    one = ClusterCommunicator(cluster_for("h100", 1), FlexCommunicator(
        "data", 4, dataclasses.replace(tuned, tag="n1-cluster"), mesh=flat),
        None)
    bare = FlexCommunicator("data", 4, dataclasses.replace(tuned,
                                                           tag="n1-flat"),
                            mesh=flat)
    x = _pattern(CLUSTER_BYTES // 2, rank, dev)
    out["n1"] = {"digests": [_digest(one.all_reduce(x)),
                             _digest(bare.all_reduce(x))],
                 "signatures": [repr(one.plan_signature()),
                                repr((("data", bare.plan_signature()),))]}
    del x, one, bare
    comm_destroy_all()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-medium")
    out["b"] = {}
    for name, m in (("cluster", mesh), ("flat", flat)):
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        opt_state = init_state(params)
        program, tctx = build_train_program(
            cfg, m, comm=comm, opt=AdamWConfig(
                lr=WHISPER_TRAIN_LR, warmup_steps=1,
                total_steps=CLUSTER_STEPS), name=f"whisper-{name}")
        batches = make_batches(cfg, seq_len=128,
                               batch_per_shard=4 * CLUSTER_ROWS)
        calls = []
        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        with _executed(calls), recorded_calls(out["calls"]):
            params, opt_state, hist = run_loop(
                program, params, opt_state, batches, tctx,
                LoopConfig(total_steps=CLUSTER_STEPS, log_every=0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_counts()
        want = collections.Counter()
        for plan, n, dt in calls:
            want += codec_launches(plan, n, dt)
        program.close()
        out["b"][name] = {
            "losses": hist, "wall_s": wall, "k1": launches["k1"],
            "k1_want": want["k1"], "node_size": tctx.node_size,
            "tiers": sorted({plan.axis_name for plan, _, _ in calls}),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del params, opt_state, program, tctx
        comm_destroy_all()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase20_cluster(card):
    """The two-tier cluster on 4 gloo ranks sharing the card, mesh (node=2,
    data=2), profile h100, each tier pinned (``_pin_cluster``): (a) the
    hierarchical all-reduce, all-gather and reduce-scatter at CLUSTER_BYTES
    of bfloat16 and of float32, bit for bit the exact results (the flat sum,
    the node-major gather, segment ``i * 2 + node``), K1 = the plans', and
    the N=1 parity; (b) Whisper-medium trained on (node=2, data=2) and on
    (data=4): losses equal on every rank, the cluster run within
    CLUSTER_VS_FLAT of the flat one, K1 = the plans'.  Every K1 segment
    table is then held against the plain version.  Returns (K1 launches of
    (a) and of (b)'s cluster run over the ranks, the K1 bit check's max
    abs err and tables, and the (data=4) run's losses, which phase 22 (d)
    faces)."""
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        nic = _pin_cluster(pinned)
        t0 = time.perf_counter()
        res = run_ranks(cluster_rank, 4, backend="gloo", device="cuda",
                        timeout_s=1200, args=(pinned,))
        ranks_s = time.perf_counter() - t0
    n, m = CLUSTER_MESH
    check(all(r["nic"] == nic and r["axes"] == ["data", "node"]
              for r in res), f"20: tiers {[r['axes'] for r in res]}")
    check(all(r["signature"] == res[0]["signature"] for r in res),
          "20 (a): plan_signature differs between ranks")
    # (a): the exact results, from the same inputs, here
    k1_a = 0
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        ins = [_pattern(CLUSTER_BYTES // dtype.itemsize, q, dev)
               for q in range(n * m)]
        total = sum(x.float() for x in ins)
        want = {"all_reduce": [_digest(total.to(dtype))] * (n * m),
                "all_gather": [_digest(torch.cat(ins).to(dtype))] * (n * m)}
        segs = total.to(dtype).chunk(n * m)
        want["reduce_scatter"] = [_digest(segs[(r % m) * n + r // m])
                                  for r in range(n * m)]
        del ins, total, segs
        torch.cuda.empty_cache()
        for op in CLUSTER_OPS:
            for r, got in enumerate(res):
                a = got["a"][op, dt]
                check(a["digest"] == want[op][r], f"20 (a) rank {r} {op} "
                      f"{dt}: result differs from the exact one")
                check(a["k1"] == a["k1_want"], f"20 (a) rank {r} {op} {dt}: "
                      f"K1 launched {a['k1']}, the plans say {a['k1_want']}")
                check(a["plans"] == res[0]["a"][op, dt]["plans"],
                      f"20 (a) rank {r} {op} {dt}: other plans")
                k1_a += a["k1"]
            a = res[0]["a"][op, dt]
            routes = {(axis, c): dict(u) for axis, c, u, _ in a["plans"]}
            print(f"phase 20 (a): hierarchical {op}, {CLUSTER_BYTES // MiB} "
                  f"MiB of {dt} a rank: exact on every rank; plans "
                  f"{routes}; K1 over 4 ranks "
                  f"{sum(r['a'][op, dt]['k1'] for r in res)} = the plans'; "
                  f"wall {max(r['a'][op, dt]['wall_s'] for r in res):.3f} s "
                  f"a call, the slower rank ({WALL_NOTE})")
    node_routes = {frozenset(dict(u)) for r in res
                   for (op, dt), a in r["a"].items()
                   for axis, c, u, _ in a["plans"] if axis == "node"}
    check(all(rt == {"primary", "staged", "ortho"} for rt in node_routes),
          f"20 (a): the NIC tier's plans ran routes {node_routes}")
    for r, got in enumerate(res):
        d, sig = got["n1"]["digests"], got["n1"]["signatures"]
        check(d[0] == d[1] and sig[0] == sig[1], f"20 (a) rank {r}: the N=1 "
              f"cluster differs from the bare communicator")
    print(f"phase 20 (a): N=1, the (data=4) cluster with the intra tier "
          f"alone: the bare communicator's plan_signature and bits "
          f"(all-reduce, {CLUSTER_BYTES // MiB} MiB bf16) on every rank")
    # (b)
    b = {name: [r["b"][name] for r in res] for name in ("cluster", "flat")}
    for name, runs in b.items():
        hist = [r["losses"] for r in runs]
        check(all(np.isfinite(h).all() for h in hist),
              f"20 (b) {name}: loss not finite: {hist}")
        check(all(h == hist[0] for h in hist),
              f"20 (b) {name}: the ranks' losses differ: {hist}")
        check(all(r["k1"] == r["k1_want"] for r in runs),
              f"20 (b) {name}: K1 {[r['k1'] for r in runs]}, the plans say "
              f"{[r['k1_want'] for r in runs]}")
    cl, fl = b["cluster"][0], b["flat"][0]
    check(cl["node_size"] == n and cl["tiers"] == ["data", "node"],
          f"20 (b): the cluster run ran {cl['tiers']}")
    gap = float(np.max(np.abs(np.array(cl["losses"])
                              - np.array(fl["losses"]))))
    check(gap <= CLUSTER_VS_FLAT, f"20 (b): cluster losses {cl['losses']} "
          f"vs flat {fl['losses']}: {gap:.3g} > {CLUSTER_VS_FLAT}")
    k1_b = sum(r["k1"] for r in b["cluster"])
    check(k1_b > 0, "20 (b): no K1 launch in the cluster run")
    print(f"phase 20 (b): whisper-medium at its published widths and depth, "
          f"bf16, seed 0, seq 128, {CLUSTER_ROWS} rows a rank, AdamW lr "
          f"{WHISPER_TRAIN_LR}, flexlink, {CLUSTER_STEPS} steps: on (node=2, "
          f"data=2) losses {cl['losses']} (equal on every rank), on "
          f"(data=4) {fl['losses']}, max gap {gap:.3g} (bound "
          f"{CLUSTER_VS_FLAT}); K1 over 4 ranks {k1_b} (cluster) / "
          f"{sum(r['k1'] for r in b['flat'])} (flat) = the plans'; wall, "
          f"the slower rank ({WALL_NOTE}): cluster "
          f"{max(r['wall_s'] for r in b['cluster']):.2f} s, flat "
          f"{max(r['wall_s'] for r in b['flat']):.2f} s; peak "
          f"{max(r['peak_gib'] for r in b['cluster']):.2f} / "
          f"{max(r['peak_gib'] for r in b['flat']):.2f} GiB a rank; ranks "
          f"ran {ranks_s:.1f} s; {card}")
    calls = set().union(*(r["calls"] for r in res))
    check(any(c[0].startswith("k1") for c in calls),
          "20: no K1 call recorded")
    k1_err, _, k1_tables = phase12_main_path_check(
        calls, phase="20", required=tuple(sorted({c[0] for c in calls})))
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return k1_a, k1_b, k1_err.get("k1", 0.0), k1_tables, fl["losses"]


# ---------------------------------------------------------------------------
# phase 21: live faults
# ---------------------------------------------------------------------------

#: (a): a bf16 hierarchical all-reduce of this many bytes a rank, one a
#: tick, under a rail degrade that commits at 2 + K - 1 = 5 and a restore
#: at 9 + K - 1 = 12; then a rail flapping every tick, which never commits
FAULT_BYTES = 64 * MiB
FAULT_SCHEDULE, FAULT_TICKS = "rail3@step2=0.25,rail3@step9=1.0", 14
FLAP_TICKS = 10
FLAP_SCHEDULE = ",".join(f"rail2@step{t}={0.25 if t % 2 else 1.0}"
                         for t in range(1, FLAP_TICKS))
#: (b): Whisper-medium at its widths, encoder and decoder depth cut 24 ->
#: ELASTIC_DEPTH; node 1 lost at step 1 commits at 4, the survivors resume
#: from snapshot 3
ELASTIC_SCHEDULE, ELASTIC_STEPS, ELASTIC_EVERY = "node1@step1=down", 6, 3
ELASTIC_DEPTH = 2          # 4 until the pod tier's phase 22 needed the time


def _pin_faults(path: str) -> str:
    """``_pin_cluster``'s pins, plus the NIC tier degraded by rail3 at
    NIC_SHARES (the same class shares), so (a)'s degrade re-keys
    ``transition:exact``; returns that degraded profile's name."""
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.communicator import SIZE_BUCKETS
    from repro_torch.core.links import PROFILES, degrade_profile
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    nic = _pin_cluster(path)
    sick = degrade_profile(PROFILES[nic], "rail:rail3=0.25").name
    prof = TuningProfile.load(path)
    for op in CLUSTER_OPS:
        for bucket in SIZE_BUCKETS:
            prof.record(sick, "ring", Collective(op), CLUSTER_MESH[0],
                        bucket, SHARE_GRID, NIC_SHARES)
    prof.save(path)
    return sick


def _elastic_cfg():
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium")
    return dataclasses.replace(
        cfg, n_layers=ELASTIC_DEPTH, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=ELASTIC_DEPTH))


def _leaf_digests(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_digests(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _digest(v)
    return out


def _launch_want(calls) -> int:
    want = collections.Counter()
    for plan, n, dt in calls:
        want += codec_launches(plan, n, dt)
    return want["k1"]


def fault_rank(pinned: str, ckpt_dir: str):
    """One rank of phase 21 on (node=2, data=2), ``cluster_for("h100",
    2)``: (a) under FAULT_SCHEDULE (then FLAP_SCHEDULE), a FabricClock on
    the ctx advanced at the top of each tick, then one hierarchical
    all-reduce of FAULT_BYTES of bf16 (``_pattern``) through the ctx's
    ClusterCommunicator, K1 counted and the executed plans recorded a
    tick; (b) Whisper-medium (ELASTIC_DEPTH + ELASTIC_DEPTH layers) from
    seed 0, both tiers pinned as in (a), under ELASTIC_SCHEDULE with
    snapshots every ELASTIC_EVERY steps to ``ckpt_dir``: the lost node's
    ranks leave, the survivors resume on (data=2), K1 counted before and
    after the drop; then, on the survivors, a fresh (data=2) launch
    restoring the same snapshot."""
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.clusters import resolve_faults
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.data.pipeline import make_batches
    from repro_torch.faults import (FabricClock, make_train_resume,
                                    restore_templates)
    from repro_torch.launch.mesh import Mesh, without_node
    from repro_torch.launch.steps import build_train_program, rank_specs
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    mesh = Mesh(CLUSTER_MESH, ("node", "data"))
    rank, dev = mesh.rank, mesh.device
    out = {"a": {}, "calls": set()}
    x = _pattern(FAULT_BYTES // 2, rank, dev).reshape(-1, CLUSTER_COLS)
    for name, schedule, ticks in (("degrade", FAULT_SCHEDULE, FAULT_TICKS),
                                  ("flap", FLAP_SCHEDULE, FLAP_TICKS)):
        comm_destroy_all()
        cluster, profile, tl = resolve_faults(None, CLUSTER_MESH[0], "h100",
                                              fault=schedule)
        ctx = ParallelCtx(dp_axis="data", node_axis="node",
                          dp_size=CLUSTER_MESH[1], node_size=CLUSTER_MESH[0],
                          comm_config=CommConfig(profile=profile,
                                                 tuning_cache=pinned,
                                                 fault=tl.spec()),
                          cluster=cluster, mesh=mesh)
        clock = FabricClock(tl).attach(ctx)
        run = []
        for t in range(ticks):
            committed = [tr["kind"] for tr in clock.advance(t)]
            calls = []
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with _executed(calls), recorded_calls(out["calls"]):
                y = ctx._cluster_comm.all_reduce(x)
            torch.cuda.synchronize()
            run.append({
                "tick": t, "committed": committed, "digest": _digest(y),
                "wall_s": time.perf_counter() - t0,
                "k1": _kernel_counts()["k1"], "k1_want": _launch_want(calls),
                "sig": repr(ctx.plan_signature()),
                "node_layouts": sorted({plan.member_layout
                                        for plan, _, _ in calls
                                        if plan.axis_name == "node"}),
                "origins": {c.axis_name: sorted(
                    {str(sc.origin) for sc in c.slot_controllers()})
                    for c in ctx.comms()}})
            del y
        out["a"][name] = {"ticks": run, "report": json.dumps(
            clock.report(), sort_keys=True, default=str),
            "rekeys": clock.rekeys, "flaps": clock.suppressed_flaps,
            "rekeyed": [sorted(tr.get("rekeyed", {}))
                        for tr in clock.transitions]}
    del x
    comm_destroy_all()
    gc.collect()
    torch.cuda.empty_cache()

    # (b): elastic node loss
    cfg = _elastic_cfg()
    cluster, profile, tl = resolve_faults(None, CLUSTER_MESH[0], "h100",
                                          fault=ELASTIC_SCHEDULE)
    comm = CommConfig(profile=profile, tuning_cache=pinned, fault=tl.spec())
    opt = AdamWConfig(lr=WHISPER_TRAIN_LR, warmup_steps=1,
                      total_steps=ELASTIC_STEPS)

    def batches_fn():
        return make_batches(cfg, seq_len=128,
                            batch_per_shard=4 * CLUSTER_ROWS)

    torch.cuda.reset_peak_memory_stats()
    train_mesh = Mesh(CLUSTER_MESH + (1,), ("node", "data", "model"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    program, ctx = build_train_program(cfg, train_mesh, comm=comm, opt=opt,
                                       name="whisper-elastic",
                                       cluster=cluster)
    specs = rank_specs(cfg, ctx)
    clock = FabricClock(tl).attach(ctx)
    logs, calls, at_drop = [], [], {}
    handler = make_train_resume(cfg, opt=opt, comm_config=comm,
                                mesh=train_mesh, cluster=ctx.cluster,
                                ckpt_dir=ckpt_dir, batches_fn=batches_fn,
                                log=logs.append)

    def on_loss(tr, step):
        # K1 and the executed plans before the drop; the rest after it
        torch.cuda.synchronize()
        at_drop.update(k1=_kernel_counts()["k1"],
                       k1_want=_launch_want(calls),
                       tiers=sorted({p.axis_name for p, _, _ in calls}),
                       wall_s=time.perf_counter() - t0)
        calls.clear()
        _kernel_counts(reset=True)
        t1 = time.perf_counter()
        swap = handler(tr, step)
        at_drop["rebuild_s"] = time.perf_counter() - t1
        return swap

    loop = LoopConfig(total_steps=ELASTIC_STEPS, log_every=0,
                      ckpt_every=ELASTIC_EVERY, ckpt_dir=ckpt_dir,
                      param_specs=specs, faults=clock, on_node_loss=on_loss)
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    with _executed(calls), recorded_calls(out["calls"]):
        params, opt_state, hist = run_loop(program, params,
                                           init_state(params), batches_fn(),
                                           ctx, loop, log=lambda *_: None)
    torch.cuda.synchronize()
    b = {"history": hist, "dropped_at": loop.report.get("dropped_at"),
         "at_drop": at_drop, "logs": logs,
         "transitions": json.dumps(clock.transitions, default=str),
         "wall_s": time.perf_counter() - t0,
         "reattached": clock.ctx is not ctx,
         "mesh": (clock.ctx.mesh.ranks, clock.ctx.mesh.axes)}
    if b["dropped_at"] is None:
        b.update(k1=_kernel_counts()["k1"], k1_want=_launch_want(calls),
                 tiers=sorted({p.axis_name for p, _, _ in calls}),
                 params=_leaf_digests(params))
    program.close()
    del params, opt_state, program, ctx
    survivors = without_node(train_mesh, 1)
    comm_destroy_all()
    gc.collect()
    torch.cuda.empty_cache()
    if dist.get_rank() in survivors:
        # the fresh (data=2) launch at the post-drop topology
        t0 = time.perf_counter()
        fresh = Mesh((CLUSTER_MESH[1], 1), ("data", "model"),
                     ranks=survivors)
        program, ctx = build_train_program(cfg, fresh, comm=comm, opt=opt,
                                           name="whisper-fresh")
        fspecs = rank_specs(cfg, ctx)
        p_tmpl, o_tmpl = restore_templates(cfg, ctx, fspecs)
        params, opt_state, meta = Checkpointer(
            ckpt_dir, ctx=ctx, specs=fspecs).restore(p_tmpl, o_tmpl,
                                                     ELASTIC_EVERY)
        batches = batches_fn()
        fhist = []
        for _ in range(ELASTIC_EVERY, ELASTIC_STEPS):
            params, opt_state, metrics = program.step(params, opt_state,
                                                      next(batches))
            fhist.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        program.close()
        b["fresh"] = {"history": fhist, "meta_step": meta["step"],
                      "params": _leaf_digests(params),
                      "wall_s": time.perf_counter() - t0}
        del params, opt_state, program, ctx
    b["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["b"] = b
    comm_destroy_all()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase21_faults(card):
    """Live faults on 4 gloo ranks sharing the card as (node=2, data=2),
    ``cluster_for("h100", 2)``, both tiers pinned as in phase 20 and the
    rail3-degraded NIC tier at the same class shares: (a) FAULT_TICKS
    ticks of a FAULT_BYTES bf16 hierarchical all-reduce under
    FAULT_SCHEDULE: every tick exact; every rank commits the degrade at
    tick 5 and the restore at 12, the NIC tier re-keys twice
    (``transition:exact``) and the data tier never, the clock reports
    equal on every rank; the plan signature moves at 5 and returns to the
    healthy one at 12; in the degraded plans rail3 carries fewer member
    units than each healthy rail; K1 = the plans' every tick; then a rail
    flapping every tick: no re-key, suppressed flaps, one signature.  (b)
    Whisper-medium (depth ELASTIC_DEPTH + ELASTIC_DEPTH, bf16, seed 0,
    seq 128, 8 rows a rank) under ELASTIC_SCHEDULE: the drop commits at
    step 4, ranks 2 and 3 leave, ranks 0 and 1 resume from snapshot 3 on
    (data=2) and run steps 3-5; every param leaf bit-equal to a fresh
    (data=2) launch from snapshot 3; 7 losses; K1 = the plans' before
    (the hierarchical legs) and after (the data axis).  Every K1 segment
    table against the plain version.  Returns (K1 over the ranks in (a)'s
    degrade run, in (b), the K1 check's max abs err and tables)."""
    from repro_torch.faults import HYSTERESIS_K
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        sick = _pin_faults(pinned)
        t0 = time.perf_counter()
        res = run_ranks(fault_rank, 4, backend="gloo", device="cuda",
                        timeout_s=900, args=(pinned, f"{tmp}/ckpt"))
        ranks_s = time.perf_counter() - t0
    n, m = CLUSTER_MESH
    k = HYSTERESIS_K
    ins = [_pattern(FAULT_BYTES // 2, q, dev) for q in range(n * m)]
    exact = _digest(sum(x.float() for x in ins).to(torch.bfloat16))
    del ins
    torch.cuda.empty_cache()
    # (a)
    deg = [r["a"]["degrade"] for r in res]
    commits = {2 + k - 1: ["degrade"], 9 + k - 1: ["degrade"]}
    for r, run in enumerate(deg):
        ticks = run["ticks"]
        check(all(t["digest"] == exact for t in ticks),
              f"21 (a) rank {r}: a tick's all-reduce is not the exact sum")
        check(all(t["committed"] == commits.get(t["tick"], [])
                  for t in ticks), f"21 (a) rank {r}: commits "
              f"{[(t['tick'], t['committed']) for t in ticks]}")
        check(all(t["k1"] == t["k1_want"] > 0 for t in ticks),
              f"21 (a) rank {r}: K1 {[t['k1'] for t in ticks]}, the plans "
              f"say {[t['k1_want'] for t in ticks]}")
        check(run["rekeys"] == 2 and run["rekeyed"] == [["node"], ["node"]],
              f"21 (a) rank {r}: re-keys {run['rekeys']} {run['rekeyed']}")
        check(run["report"] == deg[0]["report"],
              f"21 (a) rank {r}: the clock's report differs from rank 0's")
        sigs = [t["sig"] for t in ticks]
        check(all(sig == sigs[0] for sig in sigs[:5] + sigs[12:])
              and all(sig == sigs[5] for sig in sigs[5:12])
              and sigs[5] != sigs[0] and sigs == [t["sig"] for t in
                                                  deg[0]["ticks"]],
              f"21 (a) rank {r}: plan signatures move at "
              f"{[t for t in range(1, len(sigs)) if sigs[t] != sigs[t-1]]}")
        for t in ticks:
            sick_tick = 5 <= t["tick"] < 12
            lay = t["node_layouts"]
            if not sick_tick:
                check(lay == [()], f"21 (a) rank {r} tick {t['tick']}: "
                      f"healthy member layout {lay}")
                continue
            rails = [dict(units) for layout in lay for _, units in layout
                     if "rail3" in dict(units)]
            check(rails and all(u["rail3"] < min(
                v for name, v in u.items() if name != "rail3")
                for u in rails), f"21 (a) rank {r} tick {t['tick']}: "
                f"degraded member layout {lay}")
        check(ticks[5]["origins"]["node"] == ["transition:exact"]
              and ticks[12]["origins"]["node"] == ["transition:exact"]
              and all("transition" not in o for t in ticks
                      for o in t["origins"]["data"]),
              f"21 (a) rank {r}: origins {ticks[5]['origins']} / "
              f"{ticks[12]['origins']}")
    flap = [r["a"]["flap"] for r in res]
    for r, run in enumerate(flap):
        sigs = {t["sig"] for t in run["ticks"]}
        check(run["rekeys"] == 0 and run["flaps"] > 0 and len(sigs) == 1
              and all(t["digest"] == exact and t["k1"] == t["k1_want"]
                      for t in run["ticks"]),
              f"21 (a) rank {r} flap: {run['rekeys']} re-keys, "
              f"{run['flaps']} flaps, {len(sigs)} signatures")
    k1_a = sum(t["k1"] for run in deg for t in run["ticks"])
    t0 = deg[0]["ticks"]
    lay = next(layout for layout in t0[5]["node_layouts"] if layout)
    walls = [max(run["ticks"][t]["wall_s"] for run in deg)
             for t in range(FAULT_TICKS)]
    print(f"phase 21 (a): {FAULT_SCHEDULE!r} over {FAULT_TICKS} ticks of a "
          f"{FAULT_BYTES // MiB} MiB bf16 hierarchical all-reduce a rank "
          f"(the NIC tier, its rail3-degraded form too, pinned rail/xrail/"
          f"host_tcp {NIC_SHARES}): every tick exact on every rank; the "
          f"degrade committed at tick {2 + k - 1} and the restore at "
          f"{9 + k - 1} on every rank (K {k}), the NIC tier re-keyed twice "
          f"(transition:exact, to {sick!r} and back), the data tier never; "
          f"clock reports equal on every rank; the plan signature moved at "
          f"ticks 5 and 12, back to the healthy one; degraded member layout "
          f"{lay}; K1 over 4 ranks {k1_a} = the plans' "
          f"({t0[0]['k1']} a tick a rank); wall a tick, the slower rank "
          f"({WALL_NOTE}): median {statistics.median(walls):.3f} s; then "
          f"{FLAP_TICKS} ticks of rail2 flapping every tick: 0 re-keys, "
          f"{flap[0]['flaps']} suppressed flaps, one plan signature, exact")
    # (b)
    b = [r["b"] for r in res]
    commit = 1 + k - 1
    lost, live = [2, 3], [0, 1]
    for r in lost:
        check(b[r]["dropped_at"] == commit and len(b[r]["history"]) == commit
              and "fresh" not in b[r], f"21 (b) rank {r}: dropped at "
              f"{b[r]['dropped_at']}, {len(b[r]['history'])} losses")
    steps_after = ELASTIC_STEPS - ELASTIC_EVERY
    for r in live:
        g = b[r]
        trs = json.loads(g["transitions"])
        check(g["dropped_at"] is None and g["reattached"]
              and trs == [{"kind": "node", "node": 1, "step": commit}]
              and g["mesh"] == (tuple(live), ("data", "model")),
              f"21 (b) rank {r}: {trs}, mesh {g['mesh']}")
        check(any(f"from checkpoint step {ELASTIC_EVERY}" in msg
                  for msg in g["logs"]), f"21 (b) rank {r}: {g['logs']}")
        check(len(g["history"]) == commit + steps_after == 7
              and g["history"][:commit] == b[lost[0]]["history"],
              f"21 (b) rank {r}: losses {g['history']}")
        check(g["history"] == b[live[0]]["history"]
              and np.isfinite(g["history"]).all(),
              f"21 (b) rank {r}: losses differ from rank 0's")
        f = g["fresh"]
        check(f["meta_step"] == ELASTIC_EVERY
              and f["history"] == g["history"][commit:],
              f"21 (b) rank {r}: fresh losses {f['history']}")
        diff = sorted(key for key in f["params"]
                      if f["params"][key] != g["params"].get(key))
        check(not diff and f["params"].keys() == g["params"].keys(),
              f"21 (b) rank {r}: leaves differ from the fresh launch: "
              f"{diff[:5]}")
        d = g["at_drop"]
        check(d["k1"] == d["k1_want"] > 0 and d["tiers"] == ["data", "node"]
              and g["k1"] == g["k1_want"] > 0 and g["tiers"] == ["data"],
              f"21 (b) rank {r}: K1 before {d['k1']} / {d['k1_want']} "
              f"{d['tiers']}, after {g['k1']} / {g['k1_want']} {g['tiers']}")
    for r in lost:
        d = b[r]["at_drop"]
        check(d["k1"] == d["k1_want"] > 0, f"21 (b) rank {r}: K1 before the "
              f"drop {d['k1']}, the plans say {d['k1_want']}")
    k1_b = (sum(g["at_drop"]["k1"] for g in b)
            + sum(b[r]["k1"] for r in live))
    g = b[0]
    print(f"phase 21 (b): whisper-medium at its published widths, depth "
          f"cut 24 + 24 -> {ELASTIC_DEPTH} + {ELASTIC_DEPTH}, bf16, seed 0, "
          f"seq 128, {CLUSTER_ROWS} rows a rank, AdamW lr "
          f"{WHISPER_TRAIN_LR}, flexlink, {ELASTIC_SCHEDULE!r}, a snapshot "
          f"every {ELASTIC_EVERY} steps, {ELASTIC_STEPS} steps on (node=2, "
          f"data=2): the drop committed at step {commit}, ranks 2 and 3 "
          f"left there, ranks 0 and 1 rebuilt their groups alone and "
          f"resumed from snapshot {ELASTIC_EVERY} on (data=2) (rebuild and "
          f"restore {max(b[r]['at_drop']['rebuild_s'] for r in live):.2f} "
          f"s); losses {g['history']} (7: steps "
          f"{list(range(ELASTIC_EVERY, commit))} replayed), equal on both "
          f"survivors; every param "
          f"leaf ({len(g['params'])}) bit-equal to a fresh (data=2) launch "
          f"from snapshot {ELASTIC_EVERY} (its losses "
          f"{g['fresh']['history']}); K1 over 4 ranks "
          f"{sum(x['at_drop']['k1'] for x in b)} before the drop "
          f"(hierarchical legs) + {sum(b[r]['k1'] for r in live)} after "
          f"(the data axis) = the plans'; wall, the slower rank "
          f"({WALL_NOTE}): to the drop "
          f"{max(x['at_drop']['wall_s'] for x in b):.2f} s, the whole run "
          f"{max(b[r]['wall_s'] for r in live):.2f} s, the fresh launch "
          f"{max(b[r]['fresh']['wall_s'] for r in live):.2f} s; peak "
          f"{max(x['peak_gib'] for x in b):.2f} GiB a rank; ranks ran "
          f"{ranks_s:.1f} s; {card}")
    calls = set().union(*(r["calls"] for r in res))
    check(any(c[0].startswith("k1") for c in calls),
          "21: no K1 call recorded")
    k1_err, _, k1_tables = phase12_main_path_check(
        calls, phase="21", required=tuple(sorted({c[0] for c in calls})))
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return k1_a, k1_b, k1_err.get("k1", 0.0), k1_tables


# ---------------------------------------------------------------------------
# phase 22: the pod tier
# ---------------------------------------------------------------------------

#: phase 22 (a)-(c): (pod, node, data) of the three-tier mesh, 8 gloo ranks
POD_MESH = (2, 2, 2)
#: the pod tier's pin (spine = primary, xspine = staged, pod_tcp = the
#: ortho detour over the node axis); the data tier takes TP_SHARES and the
#: node tier NIC_SHARES, as in phase 20
SPINE_SHARES = {"spine": 50, "xspine": 25, "pod_tcp": 25}
POD_BYTES = 64 * MiB
#: (b), (c): the tokens a rank dispatches: Kimi-K2's capacity at 512
#: tokens, top-8 of 384 experts, factor 1.25, is 14 slots an expert
KIMI_TOKENS = 512
#: (c): the seed of expert e's weights is KIMI_SEED + e
KIMI_SEED = 7000
#: (d): the train launcher's rank path on (pod=2, node=2): the inter and
#: pod tiers, no intra tier; its ranks reuse phase 20 (b)'s model, batch,
#: seed and steps, so its losses face phase 20 (b)'s (data=4) ones
POD_TRAIN_DIMS = (2, 2, 1, 1)


def _pin_pod(path: str):
    """Pin every tier of ``cluster_for("h100", 2, pods=2)`` at every size
    bucket of the hierarchical compositions and the all_to_all: the data
    axis (intra, 2 ranks) to TP_SHARES, the node axis (NIC tier) to
    NIC_SHARES, the pod axis (spine tier) to SPINE_SHARES; returns the
    cluster."""
    from repro_torch.cluster.topology import cluster_for
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.communicator import SIZE_BUCKETS
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    cluster = cluster_for("h100", POD_MESH[1], pods=POD_MESH[0])
    prof = TuningProfile(path)
    for profile, shares in (("h100", TP_SHARES),
                            (cluster.nic_tier.name, NIC_SHARES),
                            (cluster.pod_tier.name, SPINE_SHARES)):
        for op in CLUSTER_OPS + ("all_to_all",):
            for bucket in SIZE_BUCKETS:
                prof.record(profile, "ring", Collective(op), 2, bucket,
                            SHARE_GRID, shares)
    prof.save(path)
    return cluster


def _pattern8(numel: int, rank: int, device) -> torch.Tensor:
    """``_pattern`` cut to 0..31: sums over 8 ranks (at most 248) stay
    exact in bfloat16."""
    return _pattern(numel, rank, device) % 32


class _FlatA2A(torch.autograd.Function):
    """The flat all_to_all over the mesh's (pod, node, data) plane group,
    under autograd (an all_to_all of equal blocks is its own transpose);
    ``box[0]`` counts the calls, forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, box):
        ctx.mesh, ctx.box = mesh, box
        box[0] += 1
        return mesh.all_to_all(x, mesh.plane)

    @staticmethod
    def backward(ctx, g):
        ctx.box[0] += 1
        return ctx.mesh.all_to_all(g.contiguous(), ctx.mesh.plane), None, None


def _kimi_block(ctx, dev):
    """Kimi-K2's MoE block at its published widths on this rank of the ep
    span: its own 384 / ep experts, each drawn from seed KIMI_SEED + e
    (never the whole expert tensor), the router from seed 0, the input
    [1, KIMI_TOKENS, 7168] from the rank's seed, all bf16; frozen."""
    from repro_torch.configs import get_config
    cfg = get_config("kimi-k2-1t-a32b")
    d, f, e_all = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    n_local = e_all // ctx.ep_size
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    experts = {k: torch.empty((n_local,) + s, dtype=torch.bfloat16,
                              device=dev) for k, s in shapes.items()}
    g = ctx.ep_index()
    for j in range(n_local):
        gen = torch.Generator(device="cuda").manual_seed(
            KIMI_SEED + g * n_local + j)
        for k, s in shapes.items():
            experts[k][j] = (torch.randn(s, generator=gen, device=dev)
                             * 0.02).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    router = (torch.randn((d, e_all), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(100 + ctx.mesh.rank)
    x = torch.randn((1, KIMI_TOKENS, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    cot = torch.randn((1, KIMI_TOKENS, d), generator=gen, device=dev)
    return cfg, {"w_router": router, "experts": experts}, x, cot


def pod_rank(pinned: str):
    """One rank of phase 22 (a)-(c) on (pod=2, node=2, data=2): (a) the
    ctx's ClusterCommunicator's three-tier all-reduce, all-gather and
    reduce-scatter at POD_BYTES of bfloat16 and float32 (``_pattern8``,
    [rows, CLUSTER_COLS]) beside the mesh's plain all-reduce / all-gather
    over the plane group, every executed plan and K1 call recorded, the
    kernel counts set to 0 just before each call and read just after; (b)
    the rail-local ep_all_to_all of a [384 x cap, 7168] bf16 buffer beside
    the flat all_to_all over the plane group; (c) Kimi-K2's MoE block,
    forward and the backward to its input, with the rail-local dispatch
    and then the flat one."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe as M
    from repro_torch.models.tp import ParallelCtx
    p, n, m = POD_MESH
    mesh = Mesh(POD_MESH, ("pod", "node", "data"))
    rank, dev = mesh.rank, mesh.device
    pod, node, i = mesh.coords
    ctx = ParallelCtx(dp_axis="data", node_axis="node", pod_axis="pod",
                      dp_size=m, node_size=n, pod_size=p,
                      comm_config=CommConfig(profile="h100",
                                             tuning_cache=pinned),
                      mesh=mesh)
    cc = ctx._cluster_comm
    out = {"a": {}, "calls": set(), "plane": mesh.plane,
           "axes": [c.axis_name for c in ctx.comms()],
           "ep": (ctx.ep_axes, ctx.ep_size, ctx.ep_index()),
           "pod_tier": ctx.cluster.pod_tier.name}
    for dtype in (torch.bfloat16, torch.float32):
        x = _pattern8(POD_BYTES // dtype.itemsize, rank, dev).to(
            dtype).reshape(-1, CLUSTER_COLS)
        s = mesh.all_reduce(x, mesh.plane)
        plain = {"all_reduce": _digest(s),
                 "all_gather": _digest(mesh.all_gather(x, mesh.plane)),
                 "reduce_scatter": _digest(
                     s.chunk(p * n * m)[(i * n + node) * p + pod])}
        del s
        for op in CLUSTER_OPS:
            calls = []
            torch.cuda.synchronize()
            _kernel_counts(reset=True)
            t0 = time.perf_counter()
            with _executed(calls), recorded_calls(out["calls"]):
                y = _cluster_op(cc, op, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _kernel_counts()
            want = collections.Counter()
            for plan, k, dt in calls:
                want += codec_launches(plan, k, dt)
            out["a"][op, str(dtype)[6:]] = {
                "digest": _digest(y), "plain": plain[op], "wall_s": wall,
                "k1": launches["k1"], "k1_want": want["k1"],
                "plans": sorted({(plan.axis_name, plan.collective.value,
                                  plan.chunk_units, plan.staged_substeps)
                                 for plan, _, _ in calls})}
            del y
        del x
    out["signature"] = repr(ctx.plan_signature())
    gc.collect()
    torch.cuda.empty_cache()
    # (b): Kimi-K2's dispatch buffer, arbitrary values
    cfg_k = get_config("kimi-k2-1t-a32b")
    cap = M.capacity_of(KIMI_TOKENS, cfg_k.moe)
    gen = torch.Generator(device="cuda").manual_seed(200 + rank)
    buf = torch.randn((cfg_k.moe.n_experts * cap, cfg_k.d_model),
                      generator=gen, device=dev).to(torch.bfloat16)
    calls = []
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    with _executed(calls):
        rail = cc.ep_all_to_all(buf, 0, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flat = mesh.all_to_all(buf, mesh.plane)
    torch.cuda.synchronize()
    out["b"] = {"cap": cap, "shape": tuple(buf.shape),
                "digests": [_digest(rail), _digest(flat)],
                "wall_s": [t1 - t0, time.perf_counter() - t1],
                "k1": _kernel_counts()["k1"],
                "legs": sorted((plan.axis_name, plan.chunk_units)
                               for plan, _, _ in calls),
                "report": cc.a2a_report()}
    del buf, rail, flat
    gc.collect()
    torch.cuda.empty_cache()
    # (c): Kimi-K2's MoE block, rail-local then flat dispatch
    torch.cuda.reset_peak_memory_stats()
    cfg, params, x0, cot = _kimi_block(ctx, dev)
    out["c"] = {"n_local": params["experts"]["w_gate"].shape[0],
                "expert_shape": tuple(params["experts"]["w_gate"].shape)}
    rail_a2a = ctx.ep_all_to_all
    box = [0]
    for name in ("rail", "flat"):
        if name == "flat":
            ctx.ep_all_to_all = (
                lambda v, split_axis=0, concat_axis=0:
                _FlatA2A.apply(v, mesh, box))
        calls = []
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _executed(calls):
            y, aux = M.moe_block(params, x, cfg, ctx)
            fwd = (len(calls), box[0])
            loss = (y.float() * cot).sum() + aux
            (gx,) = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        a2a = [plan.axis_name for plan, _, _ in calls
               if plan.collective.value == "all_to_all"]
        out["c"][name] = {
            "y": _digest(y), "grad": _digest(gx), "aux": float(aux.detach()),
            "finite": bool(torch.isfinite(y).all()
                           and torch.isfinite(gx).all()),
            "wall_s": time.perf_counter() - t0,
            "a2a_fwd": fwd[0] if name == "rail" else fwd[1],
            "a2a_all": len(a2a) if name == "rail" else box[0],
            "legs": dict(collections.Counter(a2a))}
        del x, y, aux, loss, gx
    ctx.ep_all_to_all = rail_a2a
    out["c"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, x0, cot
    comm_destroy_all()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pod_train_rank(pinned: str):
    """One rank of phase 22 (d): the train launcher's rank path
    (``launch.train.train_rank``) with ``--arch whisper-medium --pods 2
    --nodes 2 --mesh-shape 1,1``: phase 20 (b)'s model, batch, seed, lr
    and steps, flexlink, the node and pod tiers pinned by ``pinned``;
    every executed plan and K1 call recorded, the counts set to 0 just
    before and read just after."""
    sys.path.insert(0, str(SRC))
    import types
    from repro_torch.launch import train as T
    args = types.SimpleNamespace(
        arch="whisper-medium", smoke=False, cluster="", nodes=2, pods=2,
        degrade="", fault="", device="cuda", backend="flexlink",
        timing="sim", secondary_algo="ring", tuning_cache=pinned,
        compress="", lr=WHISPER_TRAIN_LR, steps=CLUSTER_STEPS,
        bucket_mb=0.0, seq_len=128, batch=4 * CLUSTER_ROWS, ckpt_dir="",
        ckpt_every=0)
    calls, seen = [], set()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    with _executed(calls), recorded_calls(seen):
        res = T.train_rank(args, POD_TRAIN_DIMS, 4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = collections.Counter()
    for plan, k, dt in calls:
        want += codec_launches(plan, k, dt)
    return {"losses": res["history"], "tiers": res["tiers"],
            "rollup": sorted(res["cluster"]["rollup"]),
            "topology": res["cluster"]["topology"], "wall_s": wall,
            "k1": _kernel_counts()["k1"], "k1_want": want["k1"],
            "legs": sorted({plan.axis_name for plan, _, _ in calls}),
            "calls": seen,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase22_pod(card, flat_losses):
    """The three-tier cluster of ``cluster_for("h100", 2, pods=2)``, every
    tier pinned (``_pin_pod``): on 8 gloo ranks sharing the card as (pod=2,
    node=2, data=2), (a) the three-tier all-reduce, all-gather and
    reduce-scatter at POD_BYTES of bfloat16 and float32, bit for bit the
    mesh's plain all-reduce / all-gather over the plane (the
    reduce-scatter at segment ``(i * 2 + node) * 2 + pod``), K1 = the
    plans'; (b) the rail-local ep_all_to_all at Kimi-K2's dispatch width,
    bit for bit the flat all_to_all, with its a2a report; (c) Kimi-K2's
    MoE block at its published widths, 48 experts a rank, forward and
    input gradient bit for bit between the rail-local and the flat
    dispatch; then on 4 gloo ranks (d) Whisper-medium through the train
    launcher's rank path on (pod=2, node=2), within CLUSTER_VS_FLAT of
    phase 20 (b)'s (data=4) losses ``flat_losses``, every rank's report
    with a pod tier, K1 = the plans'.  Every K1 segment table is then held
    against the plain version.  Returns (K1 launches of (a) and of (d)
    over the ranks, the K1 bit check's max abs err and tables)."""
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    p, n, m = POD_MESH
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pinned = f"{tmp}/pinned.json"
        cluster = _pin_pod(pinned)
        t0 = time.perf_counter()
        res = run_ranks(pod_rank, p * n * m, backend="gloo", device="cuda",
                        timeout_s=900, args=(pinned,))
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = run_ranks(pod_train_rank, 4, backend="gloo", device="cuda",
                          timeout_s=900, args=(pinned,))
        train_s = time.perf_counter() - t0
    check(all(r["axes"] == ["data", "node", "pod"]
              and r["plane"] == ("pod", "node", "data")
              and r["pod_tier"] == cluster.pod_tier.name for r in res),
          f"22: tiers {[r['axes'] for r in res]}")
    check(all(tuple(r["ep"][0]) == ("pod", "node", "data")
              and r["ep"][1] == 8 and r["ep"][2] == q
              for q, r in enumerate(res)), "22: the ep span or index")
    check(all(r["signature"] == res[0]["signature"] for r in res),
          "22 (a): plan_signature differs between ranks")
    k1_a = 0
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for op in CLUSTER_OPS:
            for r, got in enumerate(res):
                a = got["a"][op, dt]
                check(a["digest"] == a["plain"], f"22 (a) rank {r} {op} "
                      f"{dt}: differs from the mesh's plain {op} over the "
                      f"plane")
                check(a["k1"] == a["k1_want"], f"22 (a) rank {r} {op} {dt}: "
                      f"K1 launched {a['k1']}, the plans say {a['k1_want']}")
                check(a["plans"] == res[0]["a"][op, dt]["plans"],
                      f"22 (a) rank {r} {op} {dt}: other plans")
                k1_a += a["k1"]
            a = res[0]["a"][op, dt]
            routes = {(axis, c): dict(u) for axis, c, u, _ in a["plans"]}
            print(f"phase 22 (a): three-tier {op}, {POD_BYTES // MiB} MiB of "
                  f"{dt} a rank on (pod=2, node=2, data=2): bit for bit the "
                  f"plain one over the plane on every rank; plans "
                  f"{routes}; K1 over 8 ranks "
                  f"{sum(r['a'][op, dt]['k1'] for r in res)} = the plans'; "
                  f"wall {max(r['a'][op, dt]['wall_s'] for r in res):.3f} s "
                  f"a call, the slower rank ({WALL_NOTE})")
    pod_routes = {frozenset(dict(u)) for r in res
                  for (op, dt), a in r["a"].items()
                  for axis, c, u, _ in a["plans"] if axis == "pod"}
    check(all(rt == {"primary", "staged", "ortho"} for rt in pod_routes),
          f"22 (a): the pod tier's plans ran routes {pod_routes}")
    # (b)
    for r, got in enumerate(res):
        b = got["b"]
        check(b["digests"][0] == b["digests"][1], f"22 (b) rank {r}: the "
              f"rail-local all_to_all differs from the flat one")
        check(b["k1"] == 0, f"22 (b) rank {r}: {b['k1']} K1 launches in an "
              f"all_to_all")
        check({axis for axis, _ in b["legs"]} == {"data", "node", "pod"},
              f"22 (b) rank {r}: legs {b['legs']}")
    b = res[0]["b"]
    rep = b["report"]
    check(rep["intra_bytes"] > 0 and rep["rail_local_bytes"]
          + rep["spine_bytes"] > 0, f"22 (b): a2a report {rep}")
    print(f"phase 22 (b): rail-local ep_all_to_all of a {list(b['shape'])} "
          f"bf16 buffer ({b['shape'][0] * b['shape'][1] * 2 / 1e6:.1f} MB "
          f"a rank, cap {b['cap']} at {KIMI_TOKENS} tokens, top-8 of 384) on "
          f"(pod=2, node=2, data=2): bit for bit the flat all_to_all over "
          f"the plane group on every rank; legs "
          f"{sorted(set(b['legs']), key=str)}; a2a "
          f"report (rank 0): intra {rep['intra_bytes']} B, rail-local "
          f"{rep['rail_local_bytes']} B, spine {rep['spine_bytes']} B "
          f"({rep['source']}); wall rail-local "
          f"{max(r['b']['wall_s'][0] for r in res):.3f} s, flat "
          f"{max(r['b']['wall_s'][1] for r in res):.3f} s, the slower rank "
          f"({WALL_NOTE})")
    # (c)
    from repro_torch.configs import get_config
    n_local = get_config("kimi-k2-1t-a32b").moe.n_experts // (p * n * m)
    for r, got in enumerate(res):
        c = got["c"]
        check(c["rail"]["finite"] and c["flat"]["finite"],
              f"22 (c) rank {r}: not finite")
        check(c["rail"]["y"] == c["flat"]["y"], f"22 (c) rank {r}: the MoE "
              f"output differs between the rail-local and flat dispatch")
        check(c["rail"]["grad"] == c["flat"]["grad"], f"22 (c) rank {r}: the "
              f"input gradient differs between the dispatches")
        check(c["rail"]["aux"] == c["flat"]["aux"], f"22 (c) rank {r}: aux")
        check(c["n_local"] == n_local and c["rail"]["a2a_fwd"] == 6
              and c["rail"]["a2a_all"] == 12 and c["flat"]["a2a_fwd"] == 2
              and c["flat"]["a2a_all"] == 4,
              f"22 (c) rank {r}: {c['n_local']} experts, all_to_alls "
              f"{c['rail']} / {c['flat']}")
    c = res[0]["c"]
    print(f"phase 22 (c): Kimi-K2's MoE block at its published widths "
          f"(d_model 7168, 384 experts, d_ff 2048, top-8, bf16), experts "
          f"{list(c['expert_shape'])} a rank over (pod=2, node=2, data=2) "
          f"(ep 8, each drawn from its own seed), {KIMI_TOKENS} tokens a "
          f"rank, forward and input gradient (weights frozen): output and "
          f"gradient bit for bit between the rail-local and the flat "
          f"dispatch on every rank; all_to_alls a pass: rail-local "
          f"{c['rail']['a2a_fwd']} legs forward, "
          f"{c['rail']['a2a_all'] - c['rail']['a2a_fwd']} backward "
          f"({c['rail']['legs']}), flat {c['flat']['a2a_fwd']} forward, "
          f"{c['flat']['a2a_all'] - c['flat']['a2a_fwd']} backward; wall "
          f"{max(r['c']['rail']['wall_s'] for r in res):.2f} s / "
          f"{max(r['c']['flat']['wall_s'] for r in res):.2f} s, the slower "
          f"rank; peak {max(r['c']['peak_gib'] for r in res):.2f} GiB a "
          f"rank")
    # (d)
    hist = [r["losses"] for r in train]
    check(all(np.isfinite(h).all() for h in hist), f"22 (d): loss not "
          f"finite: {hist}")
    check(all(h == hist[0] for h in hist), f"22 (d): the ranks' losses "
          f"differ: {hist}")
    for r, got in enumerate(train):
        check(got["tiers"] == {"node": "inter", "pod": "pod"}
              and got["rollup"] == ["inter", "pod"]
              and got["topology"] == cluster.describe(),
              f"22 (d) rank {r}: tiers {got['tiers']}, rollup "
              f"{got['rollup']}")
        check(got["k1"] == got["k1_want"], f"22 (d) rank {r}: K1 "
              f"{got['k1']}, the plans say {got['k1_want']}")
        check(got["legs"] == ["node", "pod"], f"22 (d) rank {r}: legs "
              f"{got['legs']}")
    gap = float(np.max(np.abs(np.array(hist[0]) - np.array(flat_losses))))
    check(gap <= CLUSTER_VS_FLAT, f"22 (d): pod losses {hist[0]} vs (data=4) "
          f"{flat_losses}: {gap:.3g} > {CLUSTER_VS_FLAT}")
    k1_d = sum(r["k1"] for r in train)
    check(k1_d > 0, "22 (d): no K1 launch")
    print(f"phase 22 (d): whisper-medium at its published widths and depth "
          f"through the train launcher's rank path (--pods 2 --nodes 2 "
          f"--mesh-shape 1,1: the NIC and spine tiers, no intra tier), bf16, "
          f"seed 0, seq 128, {CLUSTER_ROWS} rows a rank, {CLUSTER_STEPS} "
          f"steps: losses {hist[0]} (equal on every rank), phase 20 (b)'s "
          f"(data=4) {list(flat_losses)}, max gap {gap:.3g} (bound "
          f"{CLUSTER_VS_FLAT}); each rank's report has the pod tier; K1 over "
          f"4 ranks {k1_d} = the plans'; wall "
          f"{max(r['wall_s'] for r in train):.2f} s, the slower rank "
          f"({WALL_NOTE}); peak {max(r['peak_gib'] for r in train):.2f} GiB "
          f"a rank; ranks ran {ranks_s:.1f} s (a-c) and {train_s:.1f} s (d); "
          f"{card}")
    calls = set().union(*(r["calls"] for r in res + train))
    check(any(c[0].startswith("k1") for c in calls),
          "22: no K1 call recorded")
    k1_err, _, k1_tables = phase12_main_path_check(
        calls, phase="22", required=tuple(sorted({c[0] for c in calls})))
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return k1_a, k1_d, k1_err.get("k1", 0.0), k1_tables


# ---------------------------------------------------------------------------
# phase 23: the dry-run
# ---------------------------------------------------------------------------

#: the dry-runs of phase 23: name -> their ``launch/dryrun.py`` flags
DRYRUNS = {"glm4-9b decode_32k single": ["--arch", "glm4-9b", "--shape",
                                         "decode_32k", "--mesh", "single"],
           "glm4-9b train_4k (data=2, model=4)": [
               "--arch", "glm4-9b", "--shape", "train_4k",
               "--mesh-split", "2,4"]}


class DryRuns:
    """Phase 23's dry-runs (``python -m repro_torch.launch.dryrun`` for
    each of DRYRUNS), started side by side beside phase 1's build: they
    need no card and no rank (meta tensors on a dry mesh), so their wall
    hides under the phases before them.  Stopped at exit whatever
    happens."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=str(SRC))
        self.tmp = tempfile.mkdtemp(dir=ROOT)
        self.procs = {name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
             "--out", f"{self.tmp}/{i}"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, (name, flags) in enumerate(DRYRUNS.items())}
        atexit.register(self.stop)

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase23_dryrun(card, runs: DryRuns):
    """Every record of ``runs`` ``ok``, its lines printed."""
    recs = {}
    try:
        for i, (name, p) in enumerate(runs.procs.items()):
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"23: {name}: exit {p.returncode}\n"
                  f"{out[-2000:]}\n{err[-2000:]}")
            files = list(pathlib.Path(f"{runs.tmp}/{i}").glob("*.json"))
            check(len(files) == 1, f"23: {name}: records {files}")
            recs[name] = (json.loads(files[0].read_text()),
                          re.search(r"wall=([0-9.]+)s", out).group(1))
    finally:
        runs.stop()
    for name, (rec, wall) in recs.items():
        check(rec.get("ok") is True, f"23: {name}: not ok: {rec}")
        r, mem = rec["roofline"], rec["memory_analysis"]
        print(f"phase 23: {name}: {rec['chips']} ranks, structure "
              f"{rec['collective_structure']}; argument bytes "
              f"{mem['argument_size_in_bytes']}, output bytes "
              f"{mem['output_size_in_bytes']} a rank; roofline at the "
              f"H100 datasheet peaks: t_compute {r['t_compute']:.6g} s, "
              f"t_memory {r['t_memory']:.6g} s, t_collective "
              f"{r['t_collective']:.6g} s, dominant {r['dominant']}; "
              f"lowered in {rec['lower_s']} s, {wall} s the run (beside "
              f"phase 1's build, on the host of the card {card}, which no "
              f"dry-run touches)")
    return recs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--baseline", type=pathlib.Path, default=None,
        help="an earlier checkout (git archive of a commit, unpacked): its "
             "K6 also runs phase 4's logits step, its K1-K5 are timed in "
             "turns with this checkout's in phases 8 and 12, its K7 in "
             "phase 14")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    baseline = None
    if args.baseline is not None:
        baseline = {name: load_baseline(args.baseline.resolve(), name)
                    for name in ("flash_decode", "codec",
                                 "chunk_accumulate", "payload_partition")}
    # float32 references run in full float32 on the card (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    marks = [("start", t_start)]
    dryruns = DryRuns()

    def mark(name):
        """Each phase's wall time, printed together at the end."""
        marks.append((name, time.perf_counter()))

    card = phase1_card_and_build(baseline)
    mark("1")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase2_kernel_vs_plain(gen)
    mark("2")
    phase3_reduced_parity()
    mark("3")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        launches, serve_rec = phase4_full_width(pathlib.Path(tmp),
                                                baseline)
    mark("4")
    times = phase5_times(card)
    mark("5")
    main_row, long_row, longer_row = times[6], times[256], times[1024]
    k1_errs = phase6_k1_vs_plain()
    mark("6")
    k1_launches, plans, k1_calls = phase7_collectives()
    mark("7")
    k1_rows = phase8_k1_times(card, plans, baseline)
    mark("8")
    k1_main, k1_big = k1_rows["b_substep"], k1_rows["chunk_64MiB"]
    codec_errs = phase9_codecs_vs_plain()
    mark("9")
    bf16_launches, bf16_calls = phase10_codec_collectives()
    mark("10")
    train_launches, train_plans, train_calls = phase11_training()
    mark("11")
    fp8_launches = train_launches["fp8"]
    tp_k1, k7_launches, tp_calls, tp_step = phase13_tp_training()
    mark("13")
    path_errs, path_lengths, path_tables = phase12_main_path_check(
        k1_calls | train_calls | bf16_calls | tp_calls)
    codec_rows = phase12_codec_times(card, train_plans, path_lengths,
                                     path_tables, tp_step, baseline)
    mark("12")
    k7_err, k7_rows = phase14_k7(card, baseline)
    mark("14")
    moe_k6 = phase15_moe_serving(card)
    mark("15")
    moe_k1 = phase16_moe_training(card)
    mark("16")
    ssm_k1 = phase17_ssm_hybrid(card)
    mark("17")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        vlm_k6, vlm_k1 = phase18_vlm_encdec(card, pathlib.Path(tmp))
    mark("18")
    serve_k1, serve_k6, serve_k1_err, serve_tables = phase19_serve_sharded(
        card)
    mark("19")
    (cluster_k1, cluster_train_k1, cluster_k1_err, cluster_tables,
     flat_losses) = phase20_cluster(card)
    mark("20")
    fault_k1, elastic_k1, fault_k1_err, fault_tables = phase21_faults(card)
    mark("21")
    pod_k1, pod_train_k1, pod_k1_err, pod_tables = phase22_pod(card,
                                                               flat_losses)
    mark("22")
    phase23_dryrun(card, dryruns)
    mark("23")
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
        "library_call": main_row["library_call"],
        "n_split": main_row["n_split"],
        "ms_l2_warm": main_row["ms_l2_warm"],
        "shape": "T=32 Hq=32 Hkv=2 hd=128 block=16 maxb=6 bf16",
        **{f"maxb{m}": {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "n_split", "ms_l2_warm", "stream_ms")}
           for m, row in ((256, long_row), (1024, longer_row))},
        "stream_ms": main_row["stream_ms"],
        "logits_rel_l2": serve_rec["logits_rel_l2"],
        "launches_moe_serve": {
            f"{arch} depth {depth}": moe_k6[arch]
            for arch, depth, _ in MOE_SERVE},
        "launches_moe_serve_from": "phase 15 (b, c): layers x packed steps",
        f"launches_vlm_serve_internvl2_depth{VLM_DEPTH}": vlm_k6,
        "launches_vlm_serve_from": "phase 18 (b): layers x packed steps",
        "launches_serve_paged_glm4_tp2": serve_k6,
        "launches_serve_paged_from": "phase 19 (d): 2 ranks, layers x steps "
                                     "each",
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
        **{k: k1_main[k] for k in ("baseline_ms",) if k in k1_main},
        "shape": f"n={k1_main['n']} bf16 (one staged sub-chunk of the "
                 f"1 GiB all-reduce on 4 ranks)",
        "chunk_64MiB": {k: k1_big[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "baseline_ms")
                        if k in k1_big},
        "max_abs_err_main_path": path_errs["k1"],
        "segment_tables": path_tables["k1_segments"],
        "ring_step_phase7b": k1_rows["ring_step"],
        "ring_step_phase13": codec_rows["k1"]["ring_step"],
        "launches_train_flexlink": train_launches["flexlink"]["k1"],
        "launches_train_flexlink_b64": train_launches["flexlink-b64"]["k1"],
        "launches_train_tp_flexlink": tp_k1,
        "launches_train_mixtral_dp_flexlink": moe_k1,
        "launches_train_mamba2_dp_flexlink": ssm_k1,
        "launches_train_whisper_dp_flexlink": vlm_k1["whisper-medium"],
        "launches_train_internvl2_reduced_dp_flexlink":
            vlm_k1["internvl2-76b"],
        "launches_prefill_internvl2_tp2": vlm_k1["prefill"],
        "launches_serve_glm4_tp2": serve_k1["tp2"],
        "launches_serve_glm4_model_data": serve_k1["model_data"],
        "max_abs_err_serve": serve_k1_err,
        "segment_tables_serve": serve_tables.get("k1_segments", []),
        "launches_cluster_collectives": cluster_k1,
        "launches_train_whisper_cluster_flexlink": cluster_train_k1,
        "launches_cluster_from": "phase 20 (a, b): 4 ranks on (node=2, "
                                 "data=2)",
        "max_abs_err_cluster": cluster_k1_err,
        "segment_tables_cluster": cluster_tables.get("k1_segments", []),
        "launches_fault_degrade": fault_k1,
        "launches_elastic": elastic_k1,
        "launches_fault_from": "phase 21 (a) degrade run, (b) elastic run "
                               "(before and after the drop), 4 ranks on "
                               "(node=2, data=2)",
        "max_abs_err_fault": fault_k1_err,
        "segment_tables_fault": fault_tables.get("k1_segments", []),
        "launches_pod_collectives": pod_k1,
        "launches_train_whisper_pod_flexlink": pod_train_k1,
        "launches_pod_from": "phase 22 (a) 8 ranks on (pod=2, node=2, "
                             "data=2), (d) 4 ranks on (pod=2, node=2)",
        "max_abs_err_pod": pod_k1_err,
        "segment_tables_pod": pod_tables.get("k1_segments", []),
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
                                  "bound_by", "library_ms")},
            "segment_tables": path_tables["k1_mixed_segments"],
            "ring_step_phase10c": codec_rows["k1_mixed"]["ring_step"]},
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
    next(r for r in kernels if r["name"] == "bf16_pack")["segment_tables"] = \
        path_tables["bf16_pack_segments"]
    for row in kernels:
        if row["name"] in ("fp8_encode", "fp8_decode_accumulate",
                           "fp8_decode"):
            row["launches_train_fp8_b64_ef"] = \
                train_launches["fp8-b64-ef"][row["name"]]
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
    print("chip_smoke: wall s by phase " + json.dumps(
        {name: round(t - marks[i][1], 1)
         for i, (name, t) in enumerate(marks[1:])}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
