"""k1_roofline_pct: K1's least time over its summed device time in the
traced steps.  The least time is the bytes of the lengths the staged ring
hands K1 (each ring step reads a received and a local chunk and writes
their sum: 3 x element size x (N - 1) x ceil(staged length / N) a call),
at the chip's HBM bandwidth (bench/peaks.json).  The mean over ranks."""

import math

from bench.metrics._common import is_k1, mean, traced


def k1_bytes(call) -> float:
    n_elems = call["nbytes"] // call["elem"]
    unit = math.ceil(n_elems / call["grain"])
    staged = call["units"].get("staged", 0) * unit
    ranks = call["ranks"]
    return 3.0 * call["elem"] * (ranks - 1) * math.ceil(staged / ranks)


def read(run):
    bw = run["peaks"].get("hbm_bytes_per_s")
    per = []
    for t in traced(run):
        us = sum(op[2] for op in t["ops"] if is_k1(op[0]))
        if not us or not bw:
            continue
        nbytes = sum(k1_bytes(c) for calls in t["sync_calls"] for c in calls
                     if c["units"] is not None)
        per.append(100.0 * (nbytes / bw) / (us / 1e6))
    return mean(per)
