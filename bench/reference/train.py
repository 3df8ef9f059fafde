"""The reference's first training steps, and the control's.

From the benchmark's seeded weights (``bench/weights.py``) and the same
global batches the program trained on, it runs the steps in float32 with
TF32 off: the loss of each step, the norm of each leaf's gradient at step
1 (before clipping), and the norm of each leaf's change after the last
step.  On several ranks each rank computes its own rows and the gradients
are summed with a plain ``torch.distributed.all_reduce`` in float32.

The control is the same computation with every projection's and expert's
matrix product taken on float8 (e4m3) operands, each scaled to its own
largest magnitude: the step below the bfloat16 the configuration states.
The ``bf16`` variant takes those products on bfloat16 operands with a
bfloat16 result, as the program's GEMMs do: a witness of how far
bfloat16 alone moves the numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from bench import weights as W
from bench.reference import adamw, model

F8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at a per-tensor scale, its gradient passed
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a), _fp8(b))


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of bfloat16 operands, rounded to bfloat16, its
    gradient taken in float32 on those operands."""
    out = torch.matmul(a.to(torch.bfloat16).float(),
                       b.to(torch.bfloat16).float())
    return out + (out.detach().to(torch.bfloat16).float() - out.detach())


VARIANTS = {"reference": torch.matmul, "control": fp8_matmul,
            "bf16": bf16_matmul}


def norm(x: torch.Tensor) -> float:
    """The L2 norm, accumulated in float64."""
    flat = x.detach().reshape(-1)
    return float(sum(c.double().pow(2).sum() for c in flat.split(1 << 26))) \
        ** 0.5


def name(path) -> str:
    return "/".join(path)


def run(cfg: Dict, opt: Dict, seed: int, batches: Sequence[Dict],
        device, *, rank: int = 0, world: int = 1,
        variant: str = "reference",
        on_grads: Optional[Callable[[List[str], List[torch.Tensor]],
                                    None]] = None) -> Dict:
    """Train ``len(batches)`` steps on the global ``batches`` (each
    ``{"tokens", "labels"}`` [global rows, S]); rank ``rank`` of ``world``
    takes its block of rows.  Returns ``losses``, ``grad_norms`` (step 1)
    and ``change_norms`` (after the last step), by leaf name.
    ``on_grads(names, grads)`` sees the summed step-1 gradients, before
    clipping, to judge another run's against them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = VARIANTS[variant]
    stored = getattr(torch, cfg["torch_dtype"])
    paths, params = [], []
    for path, x in W.leaves(cfg, seed, device):
        paths.append(path)
        params.append(x.float().requires_grad_(True))
    tree = W.nest(zip(paths, params))
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, b in enumerate(batches, 1):
        rows = b["tokens"].shape[0] // world
        mine = slice(rank * rows, (rank + 1) * rows)
        loss = model.loss(tree, b["tokens"][mine], b["labels"][mine], cfg,
                          mm) / world
        grads = list(torch.autograd.grad(loss, params))
        loss = loss.detach()
        if world > 1:
            for g in grads:
                dist.all_reduce(g)
            dist.all_reduce(loss)
        losses.append(float(loss))
        if step == 1:
            grad_norms = {name(p): norm(g) for p, g in zip(paths, grads)}
            if on_grads is not None:
                on_grads([name(p) for p in paths], grads)
        adamw.update(paths, params, grads, mu, nu, step, opt, stored)
        del grads
    del mu, nu
    change = {}
    for (path, x0), p in zip(W.leaves(cfg, seed, device), params):
        change[name(path)] = norm(p.detach() - x0.float())
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
