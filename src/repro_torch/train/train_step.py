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

With ``bucket_mb > 0`` the sync is bucketed (DESIGN.md §11,
train/bucketer.py) and launched FROM the backward, the way DDP's reducer
overlaps it: a tensor hook on each param leaf hands the leaf's complete
gradient to the step's :class:`~repro_torch.train.bucketer.BucketSync`
(and returns None, so the gradients ``torch.autograd.grad`` returns are
unchanged), which issues each bucket under ``ctx.issue`` as soon as it
and every bucket before it are complete; ``ctx.await_all`` joins them
before the optimizer.  The reference's XLA scheduler gives that overlap
to its post-backward loop; the tags, plans, windows and recorders here
are that loop's.  Every rank builds the same graph, so the engine runs
the model axis's backward combines and the data axis's bucket reduces in
the same order on every rank.  With a lossy wire codec
(``ctx.ef_codec_name()``) the opt state is ``(AdamWState, residuals)``:
the error-feedback residuals ride the optimizer state.  ep_a2a expert
leaves are sharded over the data axis, and the backward all_to_all has
already summed their gradients over it: the sync takes them through
``ctx.expert_grad_reduce`` (the identity on a (data, model) mesh), not
the data all-reduce, monolithic and bucketed alike.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx
from repro_torch.models.transformer import lm_loss
from repro_torch.optim.adamw import AdamWConfig, apply_updates
from repro_torch.train.bucketer import (BucketSync, GradBucketer,
                                        is_expert_param, tree_paths,
                                        tree_rebuild)


def _ep(cfg) -> bool:
    return cfg.moe is not None and cfg.moe.impl == "ep_a2a"


def sync_grads(grads, cfg: ArchConfig, ctx: ParallelCtx, *,
               bucket_mb: float = 0.0, residuals=None, ef_codec: str = ""):
    """Reduce every gradient through the ctx.

    ``bucket_mb > 0``: the bucketed path after the backward (one RoutePlan
    per size-targeted bucket, reverse leaf order); the caller owns the
    ``ctx.await_all`` barrier, and with ``ef_codec`` + ``residuals`` gets
    ``(synced, new_residuals)``.  ``bucket_mb = 0``: the monolithic
    per-leaf reduce, one RoutePlan per leaf."""
    if bucket_mb > 0:
        return GradBucketer(grads, bucket_mb=bucket_mb, ep=_ep(cfg)).sync(
            grads, ctx, residuals=residuals, codec=ef_codec)
    if not _ep(cfg):
        return ctx.grad_all_reduce(grads)
    return tree_rebuild(grads, [
        ctx.expert_grad_reduce(g) if is_expert_param(path)
        else ctx.grad_all_reduce(g) for path, g in tree_paths(grads)])


def backward_issuing(loss: torch.Tensor, leaves, run: BucketSync):
    """``torch.autograd.grad(loss, leaves)``, each leaf's gradient handed
    to ``run.ready`` by a tensor hook the moment the backward completes
    it (the hook fires once, with the summed gradient).  Returns the
    gradients; an exception in a hook fails the call."""
    handles = [p.register_hook(lambda g, i=i: run.ready(i, g))
               for i, p in enumerate(leaves)]
    try:
        return torch.autograd.grad(loss, leaves)
    finally:
        for h in handles:
            h.remove()


def make_train_step(cfg: ArchConfig, ctx: ParallelCtx, opt: AdamWConfig,
                    *, remat=True, bucket_mb: float = 0.0):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) for this rank's batch shard; params and the optimizer state
    are updated in place and returned.

    With a lossy wire codec configured AND bucketed sync, the opt_state
    is the tuple ``(AdamWState, residuals)`` (``ef_init_residuals``);
    otherwise the bare AdamWState."""
    denom = (max(ctx.dp_size, 1) * max(ctx.node_size, 1)
             * max(ctx.pod_size, 1))
    ef_codec = ctx.ef_codec_name() if bucket_mb > 0 else ""
    bucketer = None     # the bucket plan, made by the first call

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        nonlocal bucketer
        residuals = None
        if ef_codec:
            opt_state, residuals = opt_state
        if bucket_mb > 0:
            if bucketer is None:
                bucketer = GradBucketer(params, bucket_mb=bucket_mb,
                                        ep=_ep(cfg))
            leaves = bucketer.leaves(params)
        else:
            leaves, spec = pytree.tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = lm_loss(params, batch, cfg, ctx, remat=remat) / denom
            if bucketer is None:
                grads = torch.autograd.grad(loss, leaves)
            else:
                run = bucketer.start(ctx, residuals=residuals,
                                     codec=ef_codec)
                backward_issuing(loss, leaves, run)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if bucketer is None:
            grads = sync_grads(pytree.tree_unflatten(list(grads), spec),
                               cfg, ctx)
        elif ef_codec:
            grads, residuals = ctx.await_all(run.result())
        else:
            grads = ctx.await_all(run.result())
        params, opt_state, om = apply_updates(params, grads, opt_state, opt)
        # ONE small reduce for every metric: the loss (pre-scaled per rank,
        # so the sum is the global mean) and the optimizer metrics, which
        # every rank holds alike after the sync (their mean is the value)
        metrics = ctx.metrics_reduce({"loss": loss.detach()}, om)
        if ef_codec:
            return params, (opt_state, residuals), metrics
        return params, opt_state, metrics

    return step


def ef_init_residuals(params):
    """Zero error-feedback residuals matching a parameter tree (this
    rank's shards on a model axis) — what the launchers pair with the
    fresh AdamW state when a lossy codec is on."""
    return pytree.tree_map(torch.zeros_like, params)
