"""Faults planted under the timed path, for the checks that ``correct``
catches them (``bench/tests``, ``bench/calibrate.py``).  A command-line
run never plants one.

* ``unchanged``: the optimizer returns the state it was given;
* ``half_batch``: the step trains on the first half of each sequence,
  the loss a mean over those tokens alone;
* ``no_exchange``: the gradient all-reduce across ranks is left out;
* ``grad_altered``: the gradient of one leaf (the first ``w_down``) is
  doubled where the optimizer takes it.

Each patches the program's modules in the process it runs in (every rank
plants its own) and restores them on leaving.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "no_exchange", "grad_altered")


def _doubled_w_down(tree):
    done = False

    def walk(node):
        nonlocal done
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "w_down" and not done:
                out[k], done = v * 2, True
            else:
                out[k] = v
        return {k: out[k] for k in node}
    return walk(tree)


@contextlib.contextmanager
def planted(fault: str):
    if not fault:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    from repro_torch.launch import steps as ST
    from repro_torch.models import tp as TP
    from repro_torch.optim import adamw as AW
    from repro_torch.train import train_step as TS
    saved = [(TS, "apply_updates", TS.apply_updates),
             (ST, "local_batch", ST.local_batch),
             (TP.ParallelCtx, "grad_all_reduce",
              TP.ParallelCtx.grad_all_reduce)]
    apply_updates, local_batch = TS.apply_updates, ST.local_batch
    if fault == "unchanged":
        def frozen(params, grads, state, cfg, **kw):
            return params, state, {"grad_norm": AW.global_norm(grads),
                                   "lr": 0.0}
        TS.apply_updates = frozen
    elif fault == "half_batch":
        def half(batch, ctx, device):
            out = local_batch(batch, ctx, device)
            cut = out["tokens"].shape[1] // 2
            return {k: v[:, :cut] for k, v in out.items()}
        ST.local_batch = half
    elif fault == "no_exchange":
        TP.ParallelCtx.grad_all_reduce = lambda self, grads: grads
    else:
        def altered(params, grads, state, cfg, **kw):
            return apply_updates(params, _doubled_w_down(grads), state, cfg,
                                 **kw)
        TS.apply_updates = altered
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
