"""The training step: forward + backward + gradient sync + AdamW, built for
a ParallelCtx and run on every rank by the launcher.

Port of ``src/repro/train/train_step.py`` for the dense step on a
(data, model) mesh.  Params are replicated over the data axis, so every
gradient reduces over it through ``ctx.grad_all_reduce``: the FlexLink
communicator's multi-path all-reduce, the "DP gradient all-reduce" the
paper targets, with wire codecs on the secondary routes under
``--compress``.  The local loss is pre-scaled by 1/(dp nodes pods), not
by tp, so the reduce lands on the global-mean gradient.  The reference's
``jax.value_and_grad`` inside ``shard_map(check_vma=False)`` is each
rank's ``torch.autograd.grad`` over its local param leaves, through the
model axis's differentiable combines, whose backward is the reference's
transpose: sharded leaves get tp times their gradient and replicated
leaves each model rank's own partial gradient, and neither reduces over
the model axis, as in the reference.  ``metrics_reduce`` sums over the
data axis only; the loss is the same on every rank of a model line.  The
optimizer updates the params and moments in place.

Bucketed, overlapped gradient sync (``bucket_mb > 0``) and its
error-feedback residuals are not ported yet and raise (ROADMAP queue 1
item 8); ep_a2a expert grads come with the MoE family (item 9).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx
from repro_torch.models.transformer import lm_loss
from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_updates

_BUCKETED = ("bucketed gradient sync (bucket_mb > 0) is not ported yet: "
             "ROADMAP queue 1 item 8")


def sync_grads(grads, cfg: ArchConfig, ctx: ParallelCtx, *,
               bucket_mb: float = 0.0):
    """Reduce every gradient over the data axis through the ctx — the
    monolithic per-leaf sync, one RoutePlan per leaf."""
    if bucket_mb > 0:
        raise NotImplementedError(_BUCKETED)
    return ctx.grad_all_reduce(grads)


def make_train_step(cfg: ArchConfig, ctx: ParallelCtx, opt: AdamWConfig,
                    *, remat=True, bucket_mb: float = 0.0):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) for this rank's batch shard; params and the optimizer state
    are updated in place and returned."""
    if bucket_mb > 0:
        raise NotImplementedError(_BUCKETED)
    denom = (max(ctx.dp_size, 1) * max(ctx.node_size, 1)
             * max(ctx.pod_size, 1))

    def step(params, opt_state: AdamWState,
             batch: Dict[str, torch.Tensor]):
        leaves, spec = pytree.tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = lm_loss(params, batch, cfg, ctx, remat=remat) / denom
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = sync_grads(pytree.tree_unflatten(list(grads), spec), cfg,
                           ctx, bucket_mb=bucket_mb)
        params, opt_state, om = apply_updates(params, grads, opt_state, opt)
        # ONE small reduce for every metric: the loss (pre-scaled per rank,
        # so the sum is the global mean) and the optimizer metrics, which
        # every rank holds alike after the sync (their mean is the value)
        metrics = ctx.metrics_reduce({"loss": loss.detach()}, om)
        return params, opt_state, metrics

    return step
