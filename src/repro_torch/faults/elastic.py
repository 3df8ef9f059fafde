"""Elastic node loss — rebuild the cluster minus a node, resume from the
latest checkpoint (DESIGN.md §14).

Port of ``src/repro/faults/elastic.py``.  A ``node<i>@stepN=down`` event
commits through the FabricClock like any other transition, but its
application is the training loop's job, not a communicator profile swap:
the world the program was built for no longer exists.  In the reference
one process drops the node by building a smaller device mesh; here every
rank is a process, so the handler built here runs on every rank and

1. on a rank of the lost node returns :class:`NodeLeft`, and ``run_loop``
   stops there (a dead node calls nothing more);
2. on a survivor drops the node from the :class:`ClusterTopology` (same
   node profile, same NIC-tier profile name, so TuningProfile keys of the
   surviving fabric line up and the rebuilt plans warm-start), and builds
   the mesh over the survivors alone (``Mesh(..., ranks=...)``: process
   groups that only the survivors join) and the StepProgram at the
   post-drop shape; a 2 -> 1 drop collapses to a flat (data, model) mesh
   with no cluster tier;
3. restores params and optimizer state from the latest Checkpointer
   snapshot that every survivor sees (this rank's shards, on a model
   axis; the survivors agree on its step) and restarts the data
   stream from its origin: exactly what a fresh launch at the post-drop
   topology would do, the bit-identity contract elastic resume is held
   to.

On a survivor the handler returns ``(program, ctx, params, opt_state,
batches, resume_step)``, the tuple ``run_loop`` swaps in mid-flight.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.cluster.topology import ClusterTopology, drop_node


@dataclasses.dataclass(frozen=True)
class NodeLeft:
    """What the handler returns on a rank of the lost node: ``run_loop``
    leaves its loop at ``step``."""

    node: int
    step: int


#: the reference's refusal of a node-loss schedule without snapshots
NEEDS_CKPT = ("elastic node loss needs --ckpt-dir: resume is only defined "
              "from a Checkpointer snapshot")


def restore_templates(cfg, ctx, specs,
                      opt_state_wrap: Optional[Callable] = None):
    """(params, opt_state) trees with the launch-time structure at this
    rank's LOCAL shapes (its shards on a model axis, as ``specs`` and
    ``ctx`` cut them), on the ctx mesh's device: the templates
    Checkpointer.restore fills in.  No weights are drawn: the shapes come
    from a meta-device init.  ``opt_state_wrap`` re-applies any
    launcher-side wrapping (the error-feedback residual pair of DESIGN.md
    §12)."""
    from repro_torch.launch.steps import local_params
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import init_state
    device = ctx.mesh.device if ctx.mesh is not None else "cpu"
    shapes = local_params(init_params(cfg, None, "meta"), specs, ctx)
    params = pytree.tree_map(lambda t: torch.empty_like(t, device=device),
                             shapes)
    opt_state = init_state(params)
    if opt_state_wrap is not None:
        opt_state = opt_state_wrap(params, opt_state)
    return params, opt_state


def _agreed_step(mesh, ckpt_dir: str) -> Optional[int]:
    """The snapshot step every survivor resumes from: the least of their
    ``latest_step()``s (None when one of them sees no snapshot), each read
    after a barrier over ``mesh``.  A surviving writer enters the barrier
    only after its last save, so every survivor sees that snapshot; a
    writer on the lost node may finish its last save while the survivors
    read, so that some see it and others not, and the least step is then
    one they all hold."""
    def least(x: torch.Tensor) -> torch.Tensor:
        # the max of the negated values over every axis in turn: a
        # reduction over the whole mesh, which each rank leaves only
        # once every rank has entered it
        for axis in mesh.axes:
            x = mesh.all_reduce(x, axis, "max")
        return x
    least(torch.zeros(1, dtype=torch.int64, device=mesh.device))
    latest = Checkpointer(ckpt_dir).latest_step()
    got = -int(least(torch.tensor(
        [-(-1 if latest is None else latest)], dtype=torch.int64,
        device=mesh.device)).item())
    return None if got < 0 else got


def make_train_resume(cfg, *, opt, comm_config, mesh,
                      cluster: ClusterTopology, ckpt_dir: str,
                      batches_fn: Callable, bucket_mb: float = 0.0,
                      log: Callable = print):
    """Build the ``run_loop`` ``on_node_loss`` handler for one rank of a
    training launch on the (node, data, model) ``mesh`` of ``cluster``.
    ``batches_fn`` returns a FRESH batch iterator (stream position 0, the
    fresh-launch contract); the data and model dims survive the drop."""
    if not ckpt_dir:
        raise ValueError(NEEDS_CKPT)
    from repro_torch.launch.mesh import without_node
    dp, tp = mesh.axis_size("data"), mesh.axis_size("model")

    def handler(transition: Dict, step: int) -> Union[NodeLeft, Tuple]:
        from repro_torch.launch.mesh import Mesh
        from repro_torch.launch.steps import build_train_program, rank_specs
        node = int(transition["node"])
        survivors = drop_node(cluster, node)
        ranks = without_node(mesh, node)
        if dist.get_rank() not in ranks:
            log(f"elastic: node{node} down at step {step}: this rank "
                f"leaves")
            return NodeLeft(node, step)
        device = mesh.device.type
        if survivors.n_nodes > 1:
            new_mesh = Mesh((survivors.n_nodes, dp, tp),
                            ("node", "data", "model"), device=device,
                            ranks=ranks)
            new_cluster: Optional[ClusterTopology] = survivors
        else:
            # the cluster tier degenerates: one node is a flat mesh
            new_mesh = Mesh((dp, tp), ("data", "model"), device=device,
                            ranks=ranks)
            new_cluster = None
        resume_step = _agreed_step(new_mesh, ckpt_dir)
        if resume_step is None:
            raise RuntimeError(
                f"node{node} lost at step {step} but {ckpt_dir!r} holds "
                f"no snapshot — set --ckpt-every below the fault horizon")
        program, ctx = build_train_program(
            cfg, new_mesh, comm=comm_config, opt=opt,
            name=f"train-drop{node}", bucket_mb=bucket_mb,
            device=new_mesh.device, cluster=new_cluster)
        specs = rank_specs(cfg, ctx)
        wrap = None
        if bucket_mb > 0 and ctx.ef_codec_name():
            from repro_torch.train.train_step import ef_init_residuals
            wrap = lambda p, o: (o, ef_init_residuals(p))  # noqa: E731
        p_tmpl, o_tmpl = restore_templates(cfg, ctx, specs, wrap)
        params, opt_state, meta = Checkpointer(
            ckpt_dir, ctx=ctx, specs=specs).restore(p_tmpl, o_tmpl,
                                                    resume_step)
        log(f"elastic: node{node} down at step {step} -> resume "
            f"{survivors.name} ({survivors.n_nodes} node(s)) from "
            f"checkpoint step {resume_step}")
        return (program, ctx, params, opt_state, batches_fn(),
                int(meta.get("step", resume_step)))

    return handler
