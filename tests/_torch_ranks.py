"""Rank-side halves of the port's multi-rank tests.

``launch.mesh.run_ranks`` starts every rank as a fresh interpreter that
imports the function it runs, so these functions live in a module that
imports only the port: no rank ever imports JAX.  Each takes case lists
of plain data (numpy global inputs, option dicts) made by the test module
and returns plain data (numpy arrays, tuples), one answer per case.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collectives as cx
from repro_torch.core import routing
from repro_torch.launch.mesh import Mesh

#: mesh name -> (shape, axes); the test modules share these
MESHES = {"2d": ((4, 2), ("data", "model")), "1d": ((8,), ("data",)),
          "2x4": ((2, 4), ("data", "model"))}


def local_block(x: np.ndarray, spec: str, mesh: Mesh) -> np.ndarray:
    """This rank's block of a global array: ``spec`` names the mesh axes
    dim 0 (and dim 1) split over, like a shard_map PartitionSpec."""
    for dim, axis in enumerate({"none": (), "data": ("data",),
                                "data,model": ("data", "model")}[spec]):
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        size = x.shape[dim] // n
        x = np.take(x, range(i * size, (i + 1) * size), axis=dim)
    return x


def as_bits(y: torch.Tensor) -> np.ndarray:
    """Exact, dtype-neutral form: float32 values (bf16 widens exactly)."""
    return y.float().numpy() if y.is_floating_point() else y.numpy()


def _collective(op, x, mesh, kw):
    if op == "flex_all_reduce":
        return routing.flex_all_reduce(x, mesh, "data", **kw)
    if op == "flex_all_gather":
        return routing.flex_all_gather(x, mesh, "data", tiled=True, **kw)
    if op == "flex_reduce_scatter":
        return routing.flex_reduce_scatter(x, mesh, "data", **kw)
    if op == "flex_all_to_all":
        return routing.flex_all_to_all(x, mesh, "data", **kw)
    if op == "ring_all_gather":
        return cx.ring_all_gather(x, mesh, "data", **kw)
    if op == "ring_all_reduce":
        return cx.ring_all_reduce(x, mesh, "data", **kw)
    if op == "tree_all_reduce":
        return cx.tree_all_reduce(x, mesh, "data", **kw)
    raise ValueError(op)


def collectives(cases):
    """Every case of tests/test_torch_collectives.py on this rank; also
    the rank's mesh coordinates."""
    meshes = {k: Mesh(*v, device="cpu") for k, v in MESHES.items()}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}
    for name, c in cases.items():
        mesh = meshes[c["mesh"]]
        x = torch.from_numpy(local_block(c["x"], c["in_spec"], mesh))
        x = x.to(getattr(torch, c["dtype"]))
        out[name] = as_bits(_collective(c["op"], x, mesh, c["kw"]))
    return out


def codec_collectives(cases):
    """Every case of tests/test_torch_codec_collectives.py on this rank: a
    plan with wire codecs through ``routing.execute``, or the butterfly
    all-reduce with a codec."""
    from repro_torch.core.topology import Collective
    meshes = {k: Mesh(*v, device="cpu") for k, v in MESHES.items()}
    out = {}
    for name, c in cases.items():
        mesh = meshes[c["mesh"]]
        x = torch.from_numpy(local_block(c["x"], c["in_spec"], mesh))
        x = x.to(getattr(torch, c["dtype"]))
        if c["op"] == "tree_all_reduce":
            y = cx.tree_all_reduce(x, mesh, "data", codec=c["codec"])
        else:
            plan = routing.build_plan(
                Collective(c["op"]), "data", c["shares"], "model",
                staged_substeps=c["substeps"],
                path_codecs={"staged": c["codec"], "ortho": c["codec"]})
            y = routing.execute(plan, x, mesh)
        out[name] = as_bits(y)
    return out


def plain_signature(sig):
    """A plan signature with its enums and plans as plain tuples, so two
    packages' (or two ranks') signatures compare with ``==``."""
    def plan(p):
        return tuple((f, getattr(p, f).value if f == "collective"
                      else getattr(p, f)) for f in p.__dataclass_fields__)
    return tuple((op, bucket, plan(p)) for op, bucket, p in sig)


class SkewClock:
    """A rank's step clock: each step lasts what its slowest active path
    would take, with the primary ``1 + rank`` times slower than its share
    says — every rank reads another wall time for the same step, and
    alone would drain the primary at its own pace."""

    def __init__(self, ctx, rank: int):
        self.ctx, self.factor = ctx, 1.0 + rank
        self.t, self.ticks = 0.0, 0

    def __call__(self) -> float:
        self.ticks += 1
        if self.ticks % 2 == 0:
            dur = 0.0
            for comm in self.ctx.comms():
                for sc in comm._slots.values():
                    dur += max((f * (self.factor if p == "nvlink" else 1.0)
                                for p, f in sc.fractions().items() if f > 0),
                               default=0.0)
            self.t += 1e-3 * max(dur, 1e-6)
        return self.t


def communicator(tuning_cache, payloads, steps, save_dir):
    """tests/test_torch_communicator.py on this rank: the communicator's
    data plane on the (4, 2) mesh, warm-started from ``tuning_cache``;
    then a measured-timing data-parallel StepProgram loop on the (8,)
    mesh whose ranks each read a skewed clock."""
    from repro_torch.core.balancer import LoadBalancer
    from repro_torch.core.communicator import CommConfig, comm_init_rank
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.runtime.program import StepProgram
    meshes = {k: Mesh(*v, device="cpu") for k, v in MESHES.items()}
    comm = comm_init_rank("data", 4, CommConfig(profile="h800",
                                                tuning_cache=tuning_cache),
                          ortho_name="model", mesh=meshes["2d"])
    out = {}
    for name, (op, x, in_spec, kw) in payloads.items():
        x = torch.from_numpy(local_block(x, in_spec, meshes["2d"]))
        out[name] = as_bits(getattr(comm, op)(x, **kw))
    out["signature"] = plain_signature(comm.plan_signature())

    mesh = meshes["1d"]
    ctx = ParallelCtx(dp_axis="data", dp_size=8, mesh=mesh,
                      comm_config=CommConfig(profile="h800",
                                             timing="measured",
                                             tuning_cache=tuning_cache))
    prog = StepProgram(lambda: ctx.grad_all_reduce, ctx, name="dp",
                       clock=SkewClock(ctx, mesh.rank))
    grads = {"w": torch.full((64, 8), float(mesh.rank)),
             "b": torch.arange(8, dtype=torch.float32) * (mesh.rank + 1)}
    sigs, summed = [], None
    for step in range(steps):
        summed = prog(grads)
        prog.observe()
        if step == 0:
            # a short window so the loop moves shares within a few steps
            (sc,) = ctx.comms()[0]._slots.values()
            sc.balancer = LoadBalancer(dict(sc.shares), "nvlink", window=3,
                                       invoke_period=3)
            sc.probe_period = 5
        sigs.append(plain_signature(ctx.comms()[0].plan_signature()))
    saved = f"{save_dir}/rank{mesh.rank}.json"
    out["measured"] = {"signatures": sigs,
                       "grads": {k: v.numpy() for k, v in summed.items()},
                       "timing": ctx.timing_kind(),
                       "report": prog.report(),
                       "saved": (ctx.save_tuning_profile(saved), saved)}
    prog.close()
    return out


#: gradient-bucket sizes whose error-feedback gate tests/test_torch_train.py
#: compares with the reference's
EF_SIZES = (64 * 1024, 2 << 20, 4 << 20, 16 << 20)


def flat_leaves(tree, prefix=""):
    """A nested dict of tensors (or arrays) -> {"a/b/c": float32 numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(as_bits(v) if torch.is_tensor(v)
                                         else v, dtype=np.float32)
    return out


def train(params_np, runs, steps, ckpt_dir):
    """tests/test_torch_train.py on this rank: 3-step data-parallel
    training runs of reduced glm4-9b on the (data=2, model=1) mesh, each
    from the reference's initial params, through build_train_program and
    run_loop.  On rank 0 the runs marked ``state`` return their final
    params and AdamW moments, and the run marked ``ckpt`` checkpoints its
    final state."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import CommConfig
    from repro_torch.core.links import PROFILES, degrade_profile
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_program
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    mesh = Mesh((2, 1), ("data", "model"), device="cpu")
    out = {}
    for name, run in runs.items():
        base, _, spec = run["comm"]["profile"].partition("!")
        if spec:                    # a degraded profile registers by use
            degrade_profile(PROFILES[base], spec)
        cfg = get_config("glm4-9b").reduced(d_model=run["d_model"])
        params = params_from_reference(params_np)
        opt_state = init_state(params)
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(**run["comm"]),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            device="cpu", name=name)
        loop = LoopConfig(total_steps=steps, log_every=0,
                          ckpt_dir=ckpt_dir if (run.get("ckpt")
                                                and mesh.rank == 0) else None)
        params, opt_state, hist = run_loop(
            program, params, opt_state,
            make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7), ctx,
            loop)
        codecs = sorted({c for _, _, p in ctx.comms()[0].plan_signature()
                         for c in p.path_codecs})
        out[name] = {"losses": hist, "codecs": codecs,
                     "signature": plain_signature(
                         ctx.comms()[0].plan_signature()),
                     "ef": (ctx.ef_codec_name(),
                            [ctx.ef_active_for(nb, dt)
                             for nb in EF_SIZES
                             for dt in (torch.float32, torch.bfloat16)])}
        program.close()
        if run.get("state") and mesh.rank == 0:
            out[name]["state"] = {
                "params": flat_leaves(params),
                "mu": flat_leaves(opt_state.mu),
                "nu": flat_leaves(opt_state.nu)}
        if run.get("ckpt"):
            out["final"] = {k: as_bits(v) for k, v in
                            (("embed", params["embed"]),
                             ("mu_wq", opt_state.mu["layers"]["attn"]["wq"]),
                             ("step", opt_state.step))}
    return out


def pinned_profile(path, profile, n_ranks, shares, ops=("all_reduce",),
                   bucket=1 << 20):
    """Write a TuningProfile that pins the ``ops`` slots of an axis of
    ``n_ranks`` at ``bucket`` to ``shares`` (link name -> SHARE_GRID
    units): the communicators of both packages warm-start those slots
    from it and build multi-route plans for small payloads."""
    from repro_torch.control.profile import TuningProfile
    from repro_torch.core.topology import Collective
    from repro_torch.core.tuner import SHARE_GRID
    prof = TuningProfile(path)
    for op in ops:
        prof.record(profile, "ring", Collective(op), n_ranks, bucket,
                    SHARE_GRID, shares)
    prof.save(path)
    return path


def _rank_rows(x: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """Rank r's block of a global array split over every rank on dim 0 (a
    shard_map in_spec of P(("data", "model")))."""
    n = x.shape[0] // mesh.world
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.rank * n:(mesh.rank + 1) * n]))


def tp_collectives(cases, comm, codec_cases):
    """tests/test_torch_tp_collectives.py on this rank: each model-axis
    collective of a (data=2, model=4) ctx forward and backward (the loss
    sum(out * out * (rank + 1))), with the calls its communicator recorded
    before and after the backward and inside ``unrecorded``; then the
    staged-only codec plans' gradients on the (8,) mesh."""
    from repro_torch.core.communicator import CommConfig
    from repro_torch.core.topology import Collective
    from repro_torch.models.tp import ParallelCtx
    mesh = Mesh((2, 4), ("data", "model"), device="cpu")
    ctx = ParallelCtx(tp_axis="model", dp_axis="data", tp_size=4, dp_size=2,
                      comm_config=CommConfig(**comm), mesh=mesh)
    tp_comm = ctx.comms()[0]
    w = float(mesh.rank + 1)
    out = {}
    for name, c in cases.items():
        fn = getattr(ctx, c["op"])
        x = _rank_rows(c["x"], mesh).requires_grad_(True)
        tp_comm.reset_issued()
        y = fn(x)
        recorded = len(tp_comm.issued_calls())
        (y * y * w).sum().backward()
        with ctx.unrecorded():
            again = fn(x.detach())
        out[name] = {"y": as_bits(y.detach()), "grad": as_bits(x.grad),
                     "recorded": (recorded, len(tp_comm.issued_calls())),
                     "unrecorded_equal": bool(torch.equal(again, y))}
    out["signature"] = tuple((a, plain_signature(s))
                             for a, s in ctx.plan_signature())
    flat = Mesh((8,), ("data",), device="cpu")
    for name, c in codec_cases.items():
        plan = routing.build_plan(
            Collective(c["op"]), "data", {"staged": 1}, staged_substeps=1,
            path_codecs={"staged": c["codec"]} if c["codec"] else None)
        x = _rank_rows(c["x"], flat).requires_grad_(True)
        y = routing.execute(plan, x, flat)
        (y * y * float(flat.rank + 1)).sum().backward()
        out[name] = {"y": as_bits(y.detach()), "grad": as_bits(x.grad),
                     "codecs": plan.path_codecs}
    return out


def recording(ctx, name, path):
    """What the step's communicators recorded for program ``name``, their
    plan signatures and the TuningProfile JSON they save to ``path`` (a
    ctx of either package)."""
    rec = {c.axis_name: {
        "calls": [(op.value, n, win)
                  for op, n, win in c.recorder(name).issued_calls()],
        "signature": plain_signature(c.plan_signature())}
        for c in ctx.comms()}
    ctx.save_tuning_profile(path)
    with open(path) as f:
        rec["profile_json"] = f.read()
    return rec


def tp_train(params_np, runs, steps, grad_case, ckpt_dir, ref_ckpt_dir,
             work_dir):
    """tests/test_torch_tp_train.py on this rank of the (data=2, model=4)
    mesh, reduced glm4-9b from the reference's initial params (by layer
    count, ``params_np``):

    * one ``lm_loss`` gradient of a model-axis-only ctx on the full batch
      ``grad_case`` (both data rows compute the same);
    * each run of ``runs``: ``steps`` train steps through
      build_train_program, per-step losses, what its communicators
      recorded after step 1, the final local state of runs marked
      ``state``, and a checkpoint of the run marked ``ckpt`` (data row 0
      saves, model rank 0 writes);
    * the local shards this rank restores from the reference's
      checkpoint in ``ref_ckpt_dir``."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference, shard_params
    from repro_torch.core.communicator import CommConfig
    from repro_torch.core.links import PROFILES, degrade_profile
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_program
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import lm_loss, param_specs
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from torch.utils import _pytree as pytree
    mesh = Mesh((2, 4), ("data", "model"), device="cpu")
    tpi = mesh.axis_index("model")
    out = {}
    for run in runs.values():
        base, _, spec = run["comm"]["profile"].partition("!")
        if spec:                    # a degraded profile registers by use
            degrade_profile(PROFILES[base], spec)

    def local(n_layers):
        cfg = get_config("glm4-9b").reduced(n_layers=n_layers)
        specs = param_specs(cfg)
        return cfg, specs, shard_params(
            params_from_reference(params_np[n_layers]), specs, tpi, 4)

    cfg, specs, params = local(2)
    ctx = ParallelCtx(tp_axis="model", tp_size=4, mesh=mesh,
                      comm_config=CommConfig(**grad_case["comm"]))
    leaves, tree = pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in grad_case["batch"].items()}
    loss = lm_loss(params, batch, cfg, ctx, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    out["grad"] = {"loss": float(loss), "grads": flat_leaves(
        pytree.tree_unflatten(list(grads), tree))}

    for name, run in runs.items():
        cfg, specs, params = local(run["layers"])
        opt_state = init_state(params)
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(**run["comm"]),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            device="cpu", name=name)
        batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
        losses, rec = [], None
        for i in range(run["steps"]):
            params, opt_state, m = program.step(params, opt_state,
                                                next(batches))
            losses.append(float(m["loss"]))
            if i == 0 and run.get("record"):
                rec = recording(ctx, name,
                                 f"{work_dir}/{name}-rank{mesh.rank}.json")
        program.close()
        out[name] = {"losses": losses, "recording": rec}
        if run.get("state"):
            out[name]["state"] = {"params": flat_leaves(params),
                                  "mu": flat_leaves(opt_state.mu),
                                  "nu": flat_leaves(opt_state.nu)}
        if run.get("ckpt") and mesh.axis_index("data") == 0:
            Checkpointer(ckpt_dir, ctx=ctx, specs=specs).save(
                run["steps"], params, opt_state)
        if run.get("ckpt"):
            got, got_opt, meta = Checkpointer(
                ref_ckpt_dir, ctx=ctx, specs=specs).restore(
                    params, init_state(params))
            out["restored"] = {"step": meta["step"],
                               "params": flat_leaves(got),
                               "mu": flat_leaves(got_opt.mu),
                               "nu": flat_leaves(got_opt.nu)}
    return out
