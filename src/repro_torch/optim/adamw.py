"""AdamW with decoupled weight decay + global-norm clipping + LR schedules.

Port of ``src/repro/optim/adamw.py``.  The optimizer state is a tree
matching the params; moments are kept in float32 even for bf16 params.
The reference builds new arrays every step; here the update runs IN
PLACE on the params and moments, in two passes over the whole tree
(``kernels/ops.py``): the global norm, then the update.  On the card
both are kernel K8 (``kernels/csrc/adamw.cu``: one norm launch and one
finalize, then one update launch, a table of up to 16 leaves of one
dtype pair a launch); on the CPU, and for the dry-run's ``meta`` tensors,
the plain version (``kernels/ref.py``: leaf by leaf, in slices of at most
``UPDATE_SLICE`` elements).  The per-element formula and its order of
operations are the reference's (``apply_updates``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops
from repro_torch.runtime import spans


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return ops.adamw_global_norm(pytree.tree_leaves(tree), 1.0)[0]


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                  *, decay_mask=None) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step, in place on ``params`` and the moments of
    ``state``.  decay_mask: tree of bools — False leaves skip weight decay
    (the default decays leaves of 2 or more dims).  Returns (params,
    new state, {"grad_norm", "lr"}).  A ``meta`` step counter (a step
    lowered by the dry-run) counts as 0: the schedule changes no shape.
    The span ``adamw`` holds it, the global norm included."""
    with spans.span("adamw"):
        return _apply_updates(params, grads, state, cfg, decay_mask)


def _apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                   decay_mask):
    step = (0 if state.step.device.type == "meta" else int(state.step)) + 1
    lr = lr_schedule(cfg, step)
    f = np.float32
    bc1 = float(f(1.0) - f(cfg.beta1) ** f(step))
    bc2 = float(f(1.0) - f(cfg.beta2) ** f(step))

    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_d = ([p.ndim >= 2 for p in flat_p] if decay_mask is None
              else pytree.tree_leaves(decay_mask))
    gnorm, scale = ops.adamw_global_norm(flat_g, cfg.grad_clip)
    ops.adamw_update(flat_p, flat_g, pytree.tree_leaves(state.mu),
                     pytree.tree_leaves(state.nu),
                     [cfg.weight_decay if dm else 0.0 for dm in flat_d],
                     scale, lr=lr, b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
                     bc1=bc1, bc2=bc2)
    new_state = AdamWState(torch.tensor(step, dtype=torch.int32,
                                        device=state.step.device),
                           state.mu, state.nu)
    params = pytree.tree_unflatten(flat_p, spec)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
