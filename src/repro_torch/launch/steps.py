"""Step builders: wire a step function to the rank's mesh and its
ParallelCtx (and therefore to the FlexLink RoutePlan engine).

Port of ``src/repro/launch/steps.py`` for the train and prefill steps
on a (data, model) mesh and a (node, data, model) cluster mesh.  The
reference wraps each step in ``shard_map`` and ``jax.jit``; here each
rank runs the step eagerly on its own shard: the builder's callable takes
the GLOBAL batch (numpy, as ``data.pipeline.make_batches`` yields it) and
moves this rank's rows of it to the rank's device, split over data (over
``node * dp + data`` on a cluster mesh) and the same on every rank of a
model line, the ``in_specs=P("data", None)`` (``P(("node", "data"),
None)``) of the reference.  A mesh with a node axis gets the cluster
wiring: the train and prefill builders pass ``cluster=`` to the ctx.  The
params and the optimizer state it takes are RANK-LOCAL: whole on a mesh
without a model axis, this rank's ``param_specs`` shards on one with it
(``convert.shard_params``; ``rank_specs`` / ``local_params``), the
reference's in_specs: the expert dim of ep_a2a MoE experts shards over
the ctx's ep span, the data axis (``ctx.ep_spec_axis()``), as the
reference's ``param_specs(cfg, data_axis=...)``.  ``bucket_mb > 0``
builds the bucketed step (train/train_step.py): its buckets go out from
the backward, and under a lossy wire codec its optimizer state is
``(AdamWState, residuals)``, the residuals param-shaped and sharded like
the params (the reference's ``osp = (osp, psp)``).  Communicators are
memoized per (axis, config, mesh) by ``comm_init_rank``, so a rebuilt
step after a Stage-2 share move runs against the SAME balancer state.

Two tiers, as in the reference:

* ``build_train_step`` / ``build_prefill_step`` / ``build_serve_step`` —
  one step callable + ctx (+ the DecodeConfig for serving);
* ``build_train_program`` / ``build_prefill_program`` /
  ``build_serve_program`` — a
  :class:`~repro_torch.runtime.program.StepProgram` around the same
  builder: the plan-keyed executable cache plus a per-program Stage-2
  replay recorder.

The prefill step runs this rank's rows of a batch, the frontend stubs
(``vis_embed``, ``enc_embed``) included, through ``forward`` without a
gradient and returns the last position's local-vocab logits
``[B_local, V_local]`` (the reference's ``out_specs=P(batch, "model")``).
The serve step is one ``decode_step`` of the ``DecodeConfig`` that
``launch/shapes.decode_config`` gives an input shape on this mesh: the KV
cache sequence-sharded over the model axis for a batch of several rows
(split over data), over data x model for batch 1.  It takes RANK-LOCAL
params and a RANK-LOCAL cache (``init_cache`` at ``cache_len_local`` on
the rank's device, updated in place), the GLOBAL token ``[B, 1]`` (numpy
or a CPU tensor; this rank's rows go to its device per
``input_partition_specs``) and the position as a host int, and returns
this rank's local-vocab logits ``[B_local, V_local]`` and the cache,
under ``torch.no_grad()``.  Each build returns a fresh closure (the
reference's fresh ``jax.jit``); nothing is compiled.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.convert import shard_params, spec_axes
from repro_torch.core.communicator import CommConfig
from repro_torch.launch import shapes as SH
from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx
from repro_torch.models.transformer import (decode_step, forward,
                                            lm_logits_local, param_specs)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.program import StepProgram
from repro_torch.train.train_step import make_train_step


def make_ctx(mesh, comm: Optional[CommConfig] = None,
             cluster=None) -> ParallelCtx:
    """The ctx of one rank's mesh (a ``launch.mesh.Mesh`` over the axes
    ``("data", "model")`` or ``("node", "data", "model")``), or of one
    device when ``mesh`` is None.  A node axis wider than 1 gets the
    cluster wiring (DESIGN.md §9); ``cluster`` names the ClusterTopology,
    synthesized from the comm profile (``cluster_for``) when None."""
    comm = comm or CommConfig()
    if mesh is None:
        return ParallelCtx(comm_config=comm, cluster=cluster)

    def size(a):
        return mesh.axis_size(a) if a in mesh.axes else 1
    dp, tp, nodes = size("data"), size("model"), size("node")
    return ParallelCtx(tp_axis="model" if tp > 1 else None,
                       dp_axis="data" if dp > 1 else None,
                       node_axis="node" if nodes > 1 else None,
                       tp_size=tp, dp_size=dp, node_size=nodes,
                       comm_config=comm, cluster=cluster, mesh=mesh)


def rank_specs(cfg: ArchConfig, ctx: ParallelCtx):
    """The ``param_specs`` tree of a rank of ``ctx``: the ctx's ep span is
    the expert-dim axis (the reference's steps.py:83)."""
    return param_specs(cfg, data_axis=ctx.ep_spec_axis() or "data")


def local_params(params, specs, ctx: ParallelCtx):
    """This rank's shards of a GLOBAL tree by ``specs`` (the tree itself
    when no axis of the ctx shards a leaf)."""
    data = ctx.ep_size > 1 and "data" in spec_axes(specs)
    if ctx.tp_size <= 1 and not data:
        return params
    return shard_params(params, specs, ctx.tp_index(), ctx.tp_size,
                        dp_index=ctx.dp_index() if data else 0,
                        dp=ctx.dp_size if data else 1)


def local_batch(batch: Dict[str, np.ndarray], ctx: ParallelCtx,
                device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, as tensors on ``device``: shard
    ``node * dp + data`` of ``dp * nodes`` (``shapes.batch_axes``'
    outermost-major order)."""
    dp = max(ctx.dp_size, 1)
    shards = dp * max(ctx.node_size, 1)
    i = ctx.node_index() * dp + (ctx.mesh.axis_index(ctx.dp_axis)
                                 if dp > 1 else 0)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % shards:
            raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not divide "
                             f"over {shards} data ranks")
        rows = v.shape[0] // shards
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[i * rows:(i + 1) * rows])).to(device)
    return out


def _train_builder(cfg: ArchConfig, mesh, *, comm: Optional[CommConfig],
                   opt: Optional[AdamWConfig], remat, bucket_mb: float,
                   device, cluster=None):
    ctx = make_ctx(mesh, comm, cluster=cluster)
    opt = opt or AdamWConfig()
    dev = mesh.device if mesh is not None else torch.device(device)

    def builder():
        step = make_train_step(cfg, ctx, opt, remat=remat,
                               bucket_mb=bucket_mb)

        def sharded(params, opt_state, batch):
            return step(params, opt_state, local_batch(batch, ctx, dev))
        return sharded

    return builder, ctx


def build_train_step(cfg: ArchConfig, mesh=None, *,
                     comm: Optional[CommConfig] = None,
                     opt: Optional[AdamWConfig] = None, remat=True,
                     bucket_mb: float = 0.0, device="cuda", cluster=None):
    """One train-step callable (global numpy batch in) and its ctx.
    ``device`` places the batch when ``mesh`` is None (one device)."""
    builder, ctx = _train_builder(cfg, mesh, comm=comm, opt=opt, remat=remat,
                                  bucket_mb=bucket_mb, device=device,
                                  cluster=cluster)
    return builder(), ctx


def build_train_program(cfg: ArchConfig, mesh=None, *,
                        comm: Optional[CommConfig] = None,
                        opt: Optional[AdamWConfig] = None, remat=True,
                        name: str = "", bucket_mb: float = 0.0,
                        device="cuda", cluster=None):
    """The train step as a StepProgram: plan-keyed executable cache +
    isolated Stage-2 replay recorder."""
    builder, ctx = _train_builder(cfg, mesh, comm=comm, opt=opt, remat=remat,
                                  bucket_mb=bucket_mb, device=device,
                                  cluster=cluster)
    return StepProgram(builder, ctx, name=name), ctx


def _prefill_builder(cfg: ArchConfig, mesh, *, comm: Optional[CommConfig],
                     remat, device, cluster=None):
    ctx = make_ctx(mesh, comm, cluster=cluster)
    dev = mesh.device if mesh is not None else torch.device(device)

    def builder():
        def prefill(params, batch):
            b = local_batch(batch, ctx, dev)
            with torch.no_grad():
                x, _ = forward(params, b["tokens"], cfg, ctx,
                               vis_embed=b.get("vis_embed"),
                               enc_embed=b.get("enc_embed"), remat=remat)
                return lm_logits_local(params, x[:, -1:], cfg, ctx)[:, 0]
        return prefill

    return builder, ctx


def build_prefill_step(cfg: ArchConfig, mesh=None, *,
                       comm: Optional[CommConfig] = None, remat=True,
                       device="cuda", cluster=None):
    """Forward-only prefill (global numpy batch in): this rank's
    last-position local-vocab logits, and the ctx."""
    builder, ctx = _prefill_builder(cfg, mesh, comm=comm, remat=remat,
                                    device=device, cluster=cluster)
    return builder(), ctx


def build_prefill_program(cfg: ArchConfig, mesh=None, *,
                          comm: Optional[CommConfig] = None, remat=True,
                          name: str = "", device="cuda", cluster=None):
    """The prefill step as a StepProgram."""
    builder, ctx = _prefill_builder(cfg, mesh, comm=comm, remat=remat,
                                    device=device, cluster=cluster)
    return StepProgram(builder, ctx, name=name), ctx


def _serve_builder(cfg: ArchConfig, mesh, shape: SH.InputShape, *,
                   comm: Optional[CommConfig], device):
    ctx = make_ctx(mesh, comm)
    dcfg = SH.decode_config(cfg, shape, tp=ctx.tp_size, dp=ctx.dp_size)
    split = SH.input_partition_specs(cfg, shape, tp=ctx.tp_size,
                                     dp=ctx.dp_size)["token"][0]
    dev = mesh.device if mesh is not None else torch.device(device)

    def builder():
        def serve(params, cache, token, pos: int):
            token = np.array(token)           # numpy or a CPU tensor
            tok = (local_batch({"token": token}, ctx, dev)["token"]
                   if split else torch.from_numpy(token).to(dev))
            with torch.no_grad():
                return decode_step(params, cache, tok, int(pos), cfg, ctx,
                                   dcfg)
        return serve

    return builder, ctx, dcfg


def build_serve_step(cfg: ArchConfig, mesh, shape: SH.InputShape, *,
                     comm: Optional[CommConfig] = None, device="cuda"):
    """One-token decode over a seq_len KV cache (decode_32k / long_500k):
    the step callable, its ctx and its DecodeConfig."""
    builder, ctx, dcfg = _serve_builder(cfg, mesh, shape, comm=comm,
                                        device=device)
    return builder(), ctx, dcfg


def build_serve_program(cfg: ArchConfig, mesh, shape: SH.InputShape, *,
                        comm: Optional[CommConfig] = None, name: str = "",
                        device="cuda"):
    """The serve step as a StepProgram, its ctx and its DecodeConfig."""
    builder, ctx, dcfg = _serve_builder(cfg, mesh, shape, comm=comm,
                                        device=device)
    return StepProgram(builder, ctx, name=name), ctx, dcfg
