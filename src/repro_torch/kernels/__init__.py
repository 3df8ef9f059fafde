"""Hand-written Hopper kernels and their plain PyTorch versions (ports of
``src/repro/kernels/``).  CUDA sources live in ``csrc/`` and are built on
first use (kernels/_nvcc.py).

With ``REPRO_TORCH_KERNEL_LOG=<path>`` in its environment, a process that
imports this package appends one JSON line to ``path`` when it exits: its
pid, :func:`launch_counts` and, when it used a CUDA card, its peak
allocated card memory.  Spawned ranks inherit the variable, so a run over
many processes (``launch.mesh.run_ranks``) leaves a line for each; that
is how ``chip_smoke.py`` counts the launches of a run it starts as a
subprocess.
"""

import atexit
import json
import os
import sys

LOG_ENV = "REPRO_TORCH_KERNEL_LOG"


def launch_counts() -> dict:
    """This process's kernel launches by kernel, from each wrapper's own
    counter (0 for a kernel whose module was never imported): ``k1``
    (K1, mixed float32 + bf16 apart as ``k1_mixed``), the codec's K2-K5
    by name, ``k6``, ``k7a`` / ``k7b``, ``k8`` (its three launches, norm,
    finalize and update, together) and ``k9`` (its forward, dQ and dK/dV
    launches together)."""
    mods = {name: sys.modules.get(f"{__name__}.{name}")
            for name in ("chunk_accumulate", "codec", "flash_decode",
                         "payload_partition", "adamw", "flash_attention")}
    out = {"k1": 0, "k1_mixed": 0, "fp8_encode": 0,
           "fp8_decode_accumulate": 0, "fp8_decode": 0, "bf16_pack": 0,
           "k6": 0, "k7a": 0, "k7b": 0, "k8": 0, "k9": 0}
    ca = mods["chunk_accumulate"]
    if ca is not None:
        out["k1_mixed"] = ca.launch_count[ca.MIXED]
        out["k1"] = sum(ca.launch_count.values()) - out["k1_mixed"]
    if mods["codec"] is not None:
        out.update(mods["codec"].launch_count)
    if mods["flash_decode"] is not None:
        out["k6"] = mods["flash_decode"].launch_count
    if mods["payload_partition"] is not None:
        pp = mods["payload_partition"].launch_count
        out["k7a"], out["k7b"] = pp["extract"], pp["merge"]
    if mods["adamw"] is not None:
        out["k8"] = sum(mods["adamw"].launch_count.values())
    if mods["flash_attention"] is not None:
        out["k9"] = sum(mods["flash_attention"].launch_count.values())
    return out


def _log_at_exit(path: str) -> None:
    import torch
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else None)
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "launches": launch_counts(),
                            "peak_bytes": peak}) + "\n")


if os.environ.get(LOG_ENV):
    atexit.register(_log_at_exit, os.environ[LOG_ENV])
