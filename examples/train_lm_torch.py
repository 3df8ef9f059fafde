"""End-to-end training example on the PyTorch port: a small LM on the
synthetic corpus with the FlexLink backend on a (2 data x 4 model) mesh.

Default is a fast CI-sized model; ``--big`` trains a ~100M-param config.
Loss must fall; the script checks it.

Port of ``examples/train_lm.py``: the same configs, optimizer, batches and
printed lines, on 8 ranks (``launch.mesh.run_ranks``) through the port's
``build_train_step``, which takes the global batch and cuts each rank's
rows itself.  ``--dist nccl`` (the default) puts one rank on each of 8
cards; ``--dist gloo`` puts every rank on card 0, its wire through host
memory; ``--device cpu --dist gloo`` runs on the CPU.  Without a card
``--device cuda`` exits 2, and so does ``--dist nccl`` with fewer than 8
cards.  The communicator's profile is ``h100``, as the port's launcher
uses (the reference's example uses ``tpu_v5e``).  Every rank draws the
global weights from a seeded ``torch.Generator`` and keeps its model-axis
shards; :func:`main` also takes a GLOBAL params tree (the reference's
``init_params`` through ``convert.params_from_reference``, as the tests
hand it).

Run:  PYTHONPATH=src python examples/train_lm_torch.py --dist gloo --steps 60
"""

import argparse
import sys

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.communicator import CommConfig
from repro_torch.data.pipeline import make_batches
from repro_torch.launch.mesh import Mesh, device_error, run_ranks
from repro_torch.launch.steps import (build_train_step, local_params,
                                      rank_specs)
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_state

#: (data, model)
MESH = (2, 4)


def lm_config(big: bool) -> ArchConfig:
    """``lm-100m`` (~100M params) with ``big``, else ``lm-mini``."""
    if big:
        return ArchConfig("lm-100m", "dense", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=4, d_ff=3072, vocab=32000,
                          param_dtype="float32")
    return ArchConfig("lm-mini", "dense", n_layers=4, d_model=256,
                      n_heads=8, n_kv_heads=4, d_ff=1024, vocab=2048,
                      param_dtype="float32")


def train_rank(cfg: ArchConfig, steps: int, device: str, params=None):
    """One rank of the (data, model) mesh: ``steps`` flexlink train steps
    from seed 0's global weights (or ``params``), this rank's shards of
    them; the per-step losses."""
    mesh = Mesh(MESH, ("data", "model"), device=device)
    step, ctx = build_train_step(
        cfg, mesh, comm=CommConfig(backend="flexlink", profile="h100"),
        opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps),
        device=mesh.device)
    if params is None:
        params = init_params(cfg, torch.Generator(
            device=mesh.device).manual_seed(0), mesh.device)
    else:
        params = pytree.tree_map(lambda t: t.to(mesh.device), params)
    params = local_params(params, rank_specs(cfg, ctx), ctx)
    opt_state = init_state(params)
    batches = make_batches(cfg, seq_len=128, batch_per_shard=8)
    losses = []
    for _ in range(steps):
        params, opt_state, m = step(params, opt_state, next(batches))
        losses.append(float(m["loss"]))
    return losses


def main(argv=None, *, params=None):
    """Trains; returns every rank's losses, by rank.  Exits 2 when the
    device or the backend cannot hold the 8 ranks."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank; without a CUDA card "
                         "'cuda' exits 2 (pass 'cpu' to train on the CPU)")
    ap.add_argument("--dist", choices=["gloo", "nccl"], default="nccl",
                    help="process-group backend: nccl = one card per rank, "
                         "gloo = host-memory wire")
    args = ap.parse_args(argv)
    world = int(np.prod(MESH))
    err = device_error(args.device, args.dist, world)
    if err:
        print(f"error: {err}", file=sys.stderr)
        raise SystemExit(2)

    cfg = lm_config(args.big)
    device = "cuda" if args.device.startswith("cuda") else "cpu"
    ranks = run_ranks(train_rank, world, backend=args.dist, device=device,
                      timeout_s=3600, args=(cfg, args.steps, device, params))
    losses = ranks[0]
    for i, loss in enumerate(losses):
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {loss:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training must reduce loss: {losses}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} "
          f"steps on a (2x4) mesh with the FlexLink backend")
    return ranks


if __name__ == "__main__":
    main()
