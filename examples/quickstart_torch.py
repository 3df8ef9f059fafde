"""Quickstart: FlexLink on the PyTorch port.

1. Tune shares for an 8-GPU H800 AllGather (Algorithm 1 on the calibrated
   timing model) and print the predicted bandwidth win over NCCL.  The
   GB/s are the H800 timing model's prediction, not a measurement.
2. Run an actual multi-path all-gather on 8 ranks, a (4, 2) mesh
   ("x", "y"), and verify on every rank that it is bit-identical to the
   single-path all-gather of the same shard.

Port of ``examples/quickstart.py``: each rank is a process
(``launch.mesh.run_ranks``).  ``--dist nccl`` (the default) puts one rank
on each of 8 cards; ``--dist gloo`` puts every rank on card 0, its wire
through host memory; ``--device cpu --dist gloo`` runs on the CPU.
Without a card ``--device cuda`` exits 2, and so does ``--dist nccl``
with fewer than 8 cards: nothing falls back.

Run:  PYTHONPATH=src python examples/quickstart_torch.py --dist gloo
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import collectives as mp
from repro_torch.core.simulator import MiB, PathTimingModel
from repro_torch.core.topology import Collective
from repro_torch.core.tuner import initial_tune
from repro_torch.launch.mesh import Mesh, device_error, run_ranks

#: (x, y) of the data plane's mesh: 8 ranks
MESH = (4, 2)
#: rows of each rank's shard of the [4 * 6, 5] payload
ROWS = 6


def tune():
    """Stage 1 on the H800 timing model; prints the predicted line and
    returns the TuneResult."""
    model = PathTimingModel("h800")
    payload = 256 * MiB
    res = initial_tune(["nvlink", "pcie", "rdma"], "nvlink",
                       lambda fr: model.measure(Collective.ALL_GATHER, 8,
                                                payload, fr))
    nccl = model.nccl_baseline_GBps(Collective.ALL_GATHER, 8, payload)
    flex = model.algbw_GBps(Collective.ALL_GATHER, 8, payload,
                            res.fractions())
    print(f"8-GPU AllGather 256MB: NCCL {nccl:.1f} GB/s -> FlexLink "
          f"{flex:.1f} GB/s (+{(flex/nccl-1)*100:.0f}%), shares {res.shares}")
    print("  (both GB/s predicted by the calibrated H800 timing model, "
          "not measured)")
    return res


def gather_rank(shares, device):
    """One rank of the data plane: its x-row shard of the payload through
    ``flex_all_gather`` (three routes, the ortho detour over y) and
    through the mesh's single-path all-gather; both as numpy, with the
    whole payload."""
    mesh = Mesh(MESH, ("x", "y"), device=device)
    x = torch.arange(MESH[0] * ROWS * 5, dtype=torch.float32,
                     device=mesh.device).reshape(MESH[0] * ROWS, 5)
    i = mesh.axis_index("x")
    shard = x[i * ROWS:(i + 1) * ROWS].contiguous()
    got = mp.flex_all_gather(shard, mesh, "x", shares=shares,
                             ortho_name="y", tiled=True)
    want = mesh.all_gather(shard, "x").reshape(x.shape)
    return {"flex": got.cpu().numpy(), "single": want.cpu().numpy(),
            "x": x.cpu().numpy()}


def main(argv=None):
    """Both stages; returns each rank's ``gather_rank`` result.  Exits 2
    when the device or the backend cannot hold the 8 ranks."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank; without a CUDA card "
                         "'cuda' exits 2 (pass 'cpu' to run on the CPU)")
    ap.add_argument("--dist", choices=["gloo", "nccl"], default="nccl",
                    help="process-group backend: nccl = one card per rank, "
                         "gloo = host-memory wire")
    args = ap.parse_args(argv)
    world = int(np.prod(MESH))
    err = device_error(args.device, args.dist, world)
    if err:
        print(f"error: {err}", file=sys.stderr)
        raise SystemExit(2)

    # -- 1. control plane: Stage-1 tuning -----------------------------------
    res = tune()

    # -- 2. data plane: lossless multi-path collective ----------------------
    shares = {"primary": res.shares["nvlink"], "staged": res.shares["pcie"],
              "ortho": res.shares["rdma"]}
    device = "cuda" if args.device.startswith("cuda") else "cpu"
    out = run_ranks(gather_rank, world, backend=args.dist,
                    device=device, args=(shares, device))
    for r, o in enumerate(out):
        if not (np.array_equal(o["flex"], o["single"])
                and np.array_equal(o["single"], o["x"])):
            raise RuntimeError(f"rank {r}: the multi-path all_gather "
                               f"differs from the single-path one")
    print("multi-path all_gather == single-path reference (bit-exact) -- "
          "lossless, as advertised.")
    return out


if __name__ == "__main__":
    main()
