"""Plain AdamW (Loshchilov & Hutter) with global-norm clipping, linear
warm-up and cosine decay, on float32 leaves.

The parameters are stored in the configuration's type after every update
(``stored``: bfloat16 for a bf16 model), as a model without a float32
master copy keeps them; the moments stay float32.  Weight decay applies to
the matrices, not to the norms' scales or to biases.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Path = Tuple[str, ...]


def lr_at(opt: Dict, step: int) -> float:
    warm = max(opt["warmup_steps"], 1)
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / warm
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    decay = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * decay


def decays(path: Path) -> bool:
    """Whether weight decay applies to the leaf at ``path``."""
    name = path[-1]
    return not (name.startswith("ln") or name.endswith("norm")
                or name in ("bq", "bk", "bv"))


def global_norm(grads: Sequence[torch.Tensor]) -> float:
    return math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))


@torch.no_grad()
def update(paths: Sequence[Path], params: Sequence[torch.Tensor],
           grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
           nu: Sequence[torch.Tensor], step: int, opt: Dict,
           stored: torch.dtype) -> None:
    """One step (``step`` counts from 1), in place."""
    scale = min(1.0, opt["grad_clip"] / (global_norm(grads) + 1e-9))
    lr = lr_at(opt, step)
    b1, b2 = opt["beta1"], opt["beta2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for path, p, g, m, v in zip(paths, params, grads, mu, nu):
        g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m / bc1) / ((v / bc2).sqrt() + opt["eps"])
        if decays(path):
            u.add_(p, alpha=opt["weight_decay"])
        p.sub_(lr * u)
        p.copy_(p.to(stored))
