"""AdamW with decoupled weight decay + global-norm clipping + LR schedules.

Port of ``src/repro/optim/adamw.py``.  The optimizer state is a tree
matching the params; moments are kept in float32 even for bf16 params.
The reference builds new arrays every step; here the update runs IN
PLACE on the params and moments, leaf by leaf and in slices of at most
``UPDATE_SLICE`` elements, so the float32 temporaries stay a few hundred
MiB even for a 151552 x 4096 embedding.  The per-element formula and its
order of operations are the reference's (``apply_updates``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

#: elements per in-place update slice (64 MiB of float32 a temporary)
UPDATE_SLICE = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    mu: Any                    # first moment (float32 tree)
    nu: Any                    # second moment (float32 tree)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio, in float32 as the
    reference computes it."""
    f = np.float32
    s = f(step)
    warm = s / f(max(cfg.warmup_steps, 1))
    prog = (s - f(cfg.warmup_steps)) / f(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = np.clip(prog, f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog))
    decay = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * cos
    return float(f(cfg.lr) * (warm if s < cfg.warmup_steps else decay))


def init_state(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=pytree.tree_map(zeros, params),
                      nu=pytree.tree_map(zeros, params))


def _slices(x: torch.Tensor):
    """Views of ``x``'s flat elements, UPDATE_SLICE at a time (``x``
    contiguous, so in-place writes to a slice land in ``x``)."""
    return x.view(-1).split(UPDATE_SLICE)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    total = None
    for leaf in pytree.tree_leaves(tree):
        for part in leaf.reshape(-1).split(UPDATE_SLICE):
            sq = torch.sum(torch.square(part.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                  *, decay_mask=None) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step, in place on ``params`` and the moments of
    ``state``.  decay_mask: tree of bools — False leaves skip weight decay
    (the default decays leaves of 2 or more dims).  Returns (params,
    new state, {"grad_norm", "lr"}).  A ``meta`` step counter (a step
    lowered by the dry-run) counts as 0: the schedule changes no shape."""
    step = (0 if state.step.device.type == "meta" else int(state.step)) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    f = np.float32
    bc1 = float(f(1.0) - f(b1) ** f(step))
    bc2 = float(f(1.0) - f(b2) ** f(step))

    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_m = pytree.tree_leaves(state.mu)
    flat_v = pytree.tree_leaves(state.nu)
    flat_d = ([p.ndim >= 2 for p in flat_p] if decay_mask is None
              else pytree.tree_leaves(decay_mask))
    for p, g, m, v, dm in zip(flat_p, flat_g, flat_m, flat_v, flat_d):
        wd = cfg.weight_decay if dm else 0.0
        for ps, gs, ms, vs in zip(_slices(p),
                                  g.reshape(-1).split(UPDATE_SLICE),
                                  _slices(m), _slices(v)):
            gf = gs.float() * scale
            ms.mul_(b1).add_(gf, alpha=1 - b1)       # b1 m + (1 - b1) g
            vs.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            u = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
            if wd:
                u.add_(ps.float(), alpha=wd)
            ps.copy_(ps.float() - lr * u)
    new_state = AdamWState(torch.tensor(step, dtype=torch.int32,
                                        device=state.step.device),
                           state.mu, state.nu)
    params = pytree.tree_unflatten(flat_p, spec)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
