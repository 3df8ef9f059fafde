"""Step builders: wire a step function to the rank's mesh and its
ParallelCtx (and therefore to the FlexLink RoutePlan engine).

Port of ``src/repro/launch/steps.py`` for the train step on a (data,
model) mesh.  The reference wraps each step in ``shard_map`` and
``jax.jit``; here each rank runs the step eagerly on its own shard: the
builder's callable takes the GLOBAL batch (numpy, as
``data.pipeline.make_batches`` yields it) and moves this rank's rows of
it to the rank's device, split over data and the same on every rank of
a model line, the ``in_specs=P("data", None)`` of the reference.  The
params and the optimizer state it takes are RANK-LOCAL: whole on a mesh
without a model axis, this rank's ``param_specs`` shards on one with it
(``convert.shard_params``), the reference's in_specs.  Communicators are
memoized per (axis, config, mesh) by ``comm_init_rank``, so a rebuilt
step after a Stage-2 share move runs against the SAME balancer state.

Two tiers, as in the reference:

* ``build_train_step``    — one step callable + ctx;
* ``build_train_program`` — a :class:`~repro_torch.runtime.program.StepProgram`
  around the same builder: the plan-keyed executable cache plus a
  per-program Stage-2 replay recorder.

Each build returns a fresh closure (the reference's fresh ``jax.jit``);
nothing is compiled.  The prefill and serve programs of the reference
come with the serving-across-devices slice (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.communicator import CommConfig
from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.program import StepProgram
from repro_torch.train.train_step import make_train_step


def make_ctx(mesh, comm: Optional[CommConfig] = None) -> ParallelCtx:
    """The ctx of one rank's mesh (a ``launch.mesh.Mesh`` over the axes
    ``("data", "model")``), or of one device when ``mesh`` is None."""
    comm = comm or CommConfig()
    if mesh is None:
        return ParallelCtx(comm_config=comm)
    dp = mesh.axis_size("data") if "data" in mesh.axes else 1
    tp = mesh.axis_size("model") if "model" in mesh.axes else 1
    return ParallelCtx(tp_axis="model" if tp > 1 else None,
                       dp_axis="data" if dp > 1 else None,
                       tp_size=tp, dp_size=dp, comm_config=comm, mesh=mesh)


def local_batch(batch: Dict[str, np.ndarray], ctx: ParallelCtx,
                device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, as tensors on ``device``."""
    dp = max(ctx.dp_size, 1)
    i = ctx.mesh.axis_index(ctx.dp_axis) if dp > 1 else 0
    out = {}
    for k, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not divide "
                             f"over {dp} data ranks")
        rows = v.shape[0] // dp
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[i * rows:(i + 1) * rows])).to(device)
    return out


def _train_builder(cfg: ArchConfig, mesh, *, comm: Optional[CommConfig],
                   opt: Optional[AdamWConfig], remat, bucket_mb: float,
                   device):
    ctx = make_ctx(mesh, comm)
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
                     bucket_mb: float = 0.0, device="cuda"):
    """One train-step callable (global numpy batch in) and its ctx.
    ``device`` places the batch when ``mesh`` is None (one device)."""
    builder, ctx = _train_builder(cfg, mesh, comm=comm, opt=opt, remat=remat,
                                  bucket_mb=bucket_mb, device=device)
    return builder(), ctx


def build_train_program(cfg: ArchConfig, mesh=None, *,
                        comm: Optional[CommConfig] = None,
                        opt: Optional[AdamWConfig] = None, remat=True,
                        name: str = "", bucket_mb: float = 0.0,
                        device="cuda"):
    """The train step as a StepProgram: plan-keyed executable cache +
    isolated Stage-2 replay recorder."""
    builder, ctx = _train_builder(cfg, mesh, comm=comm, opt=opt, remat=remat,
                                  bucket_mb=bucket_mb, device=device)
    return StepProgram(builder, ctx, name=name), ctx
