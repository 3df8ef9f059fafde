"""End-to-end serving example on the PyTorch port: batched requests
through the wave engine on a reduced zamba2 (hybrid SSM+attention) model
— the architecture family where decode state handling is most
interesting.

Port of ``examples/serve_decode.py``: the same model, engine settings,
seeded prompts and printed lines, on the card (``--device cpu`` for the
CPU; without a card ``--device cuda`` exits 2).  The weights are drawn
from a seeded ``torch.Generator``; :func:`main` also takes a params tree
(the reference's ``init_params`` through ``convert.params_from_reference``,
as the tests hand it).

Run:  PYTHONPATH=src python examples/serve_decode_torch.py
"""

import argparse
import sys

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.launch.mesh import device_error
from repro_torch.models.tp import single_device_ctx
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ServeConfig, ServeEngine

#: requests served, and the tokens each asks for
REQUESTS, MAX_NEW = 7, 10


def main(argv=None, *, params=None):
    """Serves the seven requests; returns the finished streams by request
    id.  ``params``: a GLOBAL params tree of the reduced config (moved to
    the device), else seed 0's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card 'cuda' exits 2 "
                         "(pass 'cpu' to serve on the CPU)")
    args = ap.parse_args(argv)
    err = device_error(args.device)
    if err:
        print(f"error: {err}", file=sys.stderr)
        raise SystemExit(2)
    device = torch.device(args.device)

    cfg = get_config("zamba2-1.2b").reduced()
    ctx = single_device_ctx()
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    else:
        params = pytree.tree_map(lambda t: t.to(device), params)
    engine = ServeEngine(params, cfg, ctx, ServeConfig(slots=3, cache_len=96))

    rng = np.random.default_rng(1)
    rids = []
    for _ in range(REQUESTS):
        prompt = rng.integers(1, cfg.vocab,
                              size=int(rng.integers(3, 9))).tolist()
        rids.append(engine.submit(prompt, max_new=MAX_NEW))

    engine.run_until_drained()
    fin = engine.finished()
    engine.close()
    if len(fin) != REQUESTS:
        raise RuntimeError(f"{len(fin)} of {REQUESTS} requests finished")
    for rid in rids:
        print(f"request {rid}: {fin[rid]}")
    print(f"served {len(fin)} requests in waves over {cfg.name} (reduced)")
    return fin


if __name__ == "__main__":
    main()
