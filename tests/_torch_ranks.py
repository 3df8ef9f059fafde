"""Rank-side halves of the port's multi-rank tests.

``launch.mesh.run_ranks`` starts every rank as a fresh interpreter that
imports the function it runs, so these functions live in a module that
imports only the port: no rank ever imports JAX.  Each takes case lists
of plain data (numpy global inputs, option dicts) made by the test module
and returns plain data (numpy arrays, tuples), one answer per case.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

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


#: the kernels' list forms (one call a ring step) and their per-sub-chunk
#: counterparts, whose calls ``collectives`` counts per case
COUNTED = ("accumulate", "accumulate_many", "wire_encode", "wire_encode_many")


@contextlib.contextmanager
def counted_calls(counts: collections.Counter):
    """Within the block, every call of a ``kernels/ops.py`` function named
    in COUNTED adds one to ``counts[name]``; ops' own calls between them
    (the list forms' closures, the bf16 decode-accumulate) go through the
    module's names, so they count too."""
    from repro_torch.kernels import ops
    originals = {name: getattr(ops, name) for name in COUNTED}

    def wrap(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


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
    if op == "codec_execute":
        from repro_torch.core.topology import Collective
        plan = routing.build_plan(
            Collective(kw["collective"]), "data", kw["shares"], "model",
            staged_substeps=kw["substeps"],
            path_codecs={"staged": kw["codec"]})
        return routing.execute(plan, x, mesh)
    raise ValueError(op)


def collectives(cases):
    """Every case of tests/test_torch_collectives.py on this rank, with
    the COUNTED calls each made; also the rank's mesh coordinates."""
    meshes = {k: Mesh(*v, device="cpu") for k, v in MESHES.items()}
    out = {"coords": {k: m.coords for k, m in meshes.items()}, "calls": {}}
    for name, c in cases.items():
        mesh = meshes[c["mesh"]]
        x = torch.from_numpy(local_block(c["x"], c["in_spec"], mesh))
        x = x.to(getattr(torch, c["dtype"]))
        with counted_calls(collections.Counter()) as counts:
            out[name] = as_bits(_collective(c["op"], x, mesh, c["kw"]))
        out["calls"][name] = dict(counts)
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
    collective of a (data=2, model=4) ctx, and its data-axis
    ``ep_all_to_all``, forward and backward (the loss
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
        if c["op"] == "ep_all_to_all":
            comm = ctx.comms()[1]

            def fn(x):
                return ctx.ep_all_to_all(x, split_axis=0, concat_axis=0)
        else:
            comm, fn = tp_comm, getattr(ctx, c["op"])
        x = _rank_rows(c["x"], mesh).requires_grad_(True)
        comm.reset_issued()
        y = fn(x)
        recorded = len(comm.issued_calls())
        (y * y * w).sum().backward()
        with ctx.unrecorded():
            again = fn(x.detach())
        out[name] = {"y": as_bits(y.detach()), "grad": as_bits(x.grad),
                     "recorded": (recorded, len(comm.issued_calls())),
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


def _local_tree(tree, spec, mesh, dtype):
    """This rank's blocks of a nested dict of global numpy arrays."""
    if isinstance(tree, dict):
        return {k: _local_tree(v, spec, mesh, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(
        local_block(tree, spec, mesh))).to(getattr(torch, dtype))


def _run_prog(program, params, opt_state, batches, steps, after_first=None):
    losses = []
    for i in range(steps):
        params, opt_state, m = program.step(params, opt_state, next(batches))
        losses.append(float(m["loss"]))
        if i == 0 and after_first is not None:
            after_first()
    return params, opt_state, losses


def _sub_recorders(ctx, name, n_buckets):
    """Per communicator, each bucket's sub-recorder: its calls as (op,
    bytes, window population) and the base recorder's call count."""
    return {c.axis_name: {
        "base": len(c.recorder(name).issued_calls()),
        "buckets": [[(op.value, nb, c.window_population(w))
                     for op, nb, w in c.recorder(f"{name}/g{k}")
                     .issued_calls()] for k in range(n_buckets)],
        "windows": len({w for k in range(n_buckets)
                        for *_, w in c.recorder(f"{name}/g{k}")
                        .issued_calls()})}
        for c in ctx.comms()}


def _post_backward_builder(cfg, ctx, opt, bucket_mb, device):
    """A train step that reduces its buckets AFTER the backward through
    ``sync_grads``: the reference's post-backward loop."""
    from repro_torch.launch.steps import local_batch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim.adamw import apply_updates
    from repro_torch.train.train_step import sync_grads

    def builder():
        def step(params, opt_state, batch):
            batch = local_batch(batch, ctx, device)
            leaves, spec = pytree.tree_flatten(params)
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = lm_loss(params, batch, cfg, ctx) / ctx.dp_size
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            grads = ctx.await_all(sync_grads(
                pytree.tree_unflatten(list(grads), spec), cfg, ctx,
                bucket_mb=bucket_mb))
            params, opt_state, om = apply_updates(params, grads, opt_state,
                                                  opt)
            return params, opt_state, ctx.metrics_reduce(
                {"loss": loss.detach()}, om)
        return step
    return builder


def overlap(parity, params_np, steps, bucket_mb, ef, ckpt_dir):
    """tests/test_torch_overlap.py on this rank (4 ranks):

    * on the (4,) mesh, each ``parity`` case's monolithic and bucketed
      sync of small-integer gradients, and the StepProgram issue/await
      lifecycle through ``ctx.issue``;
    * on the (data=2, model=2) mesh, reduced glm4-9b from the reference's
      initial params (``params_np``): the hooked bucketed train step and
      a post-backward ``sync_grads`` step, each ``steps`` steps (issue
      order, hook calls, sub-recorders, losses), ``issue`` inside
      ``unrecorded``, and the error-feedback run ``ef``, whose final
      state (residuals included) data row 0 checkpoints into
      ``ckpt_dir`` and every rank restores."""
    import torch.distributed as dist
    from types import SimpleNamespace
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.core.communicator import CommConfig
    from repro_torch.core.links import PROFILES, degrade_profile
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_program, make_ctx
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.runtime.program import StepProgram
    from repro_torch.train import bucketer as bk
    from repro_torch.train.train_step import ef_init_residuals, sync_grads
    out = {}
    flat = Mesh((4,), ("data",), device="cpu")
    for name, c in parity.items():
        ctx = ParallelCtx(dp_axis="data", dp_size=4, mesh=flat,
                          comm_config=CommConfig(profile="tpu_v5e",
                                                 tag="ov-flat"))
        cfg = SimpleNamespace(moe=SimpleNamespace(impl="ep_a2a")
                              if c["ep"] else None)
        t = _local_tree(c["grads"], "data", flat, c["dtype"])
        mono = sync_grads(t, cfg, ctx)
        buck = ctx.await_all(sync_grads(t, cfg, ctx,
                                        bucket_mb=c["bucket_mb"]))
        out[name] = {"mono": flat_leaves(mono), "buck": flat_leaves(buck)}

    ctx = ParallelCtx(dp_axis="data", dp_size=4, mesh=flat,
                      comm_config=CommConfig(profile="tpu_v5e",
                                             tag="ov-prog"))
    comm = ctx.comms()[0]

    def builder():
        def step(v):
            with ctx.issue("b0"):
                a = comm.all_reduce(v)
            with ctx.issue("b1"):
                b = comm.all_reduce(2.0 * v)
            a, b = ctx.await_all((a, b))
            return a + b
        return step

    x = torch.from_numpy(local_block(
        (np.arange(4 * 8, dtype=np.float32) % 5).reshape(4 * 8, 1), "data",
        flat))
    prog = StepProgram(builder, ctx, name="ovl")
    h = prog.issue(x)
    pending = (h.ready, prog._pending == [h])
    outs = prog.await_all()
    c0, c1 = (comm.recorder(f"ovl/{t}").issued_calls() for t in ("b0", "b1"))
    lifecycle = {"pending": pending, "ready": h.ready, "n_out": len(outs),
                 "left": len(prog._pending), "y": as_bits(outs[0]),
                 "calls": (len(c0), len(c1)),
                 "same_window": c0[0][2] == c1[0][2],
                 "population": comm.window_population(c0[0][2])}
    prog.issue(x)
    lifecycle["y2"] = as_bits(prog.await_all()[0])
    lifecycle["hits"] = prog.cache.report()["hits"]
    lifecycle["empty_await"] = prog.await_all()
    prog.close()
    out["lifecycle"] = lifecycle

    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    cfg = get_config("glm4-9b").reduced()
    specs = param_specs(cfg)
    tpi = mesh.axis_index("model")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)

    def params():
        from repro_torch.convert import params_from_reference
        return shard_params(params_from_reference(params_np), specs, tpi, 2)

    def batches():
        return make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)

    # the hooked step: issue order, hook calls a step, sub-recorders
    comm_cfg = CommConfig(profile="h800", tag="ov-train")
    program, ctx = build_train_program(cfg, mesh, comm=comm_cfg, opt=opt,
                                       bucket_mb=bucket_mb, device="cpu",
                                       name="hooked")
    n_buckets = len(bk.GradBucketer(params(), bucket_mb=bucket_mb).buckets)
    issued, ready = [], []
    issue, ready_fn = ctx.issue, bk.BucketSync.ready

    def logged_issue(tag):
        issued.append((tag, torch._C._current_graph_task_id() != -1))
        return issue(tag)

    def logged_ready(self, i, g):
        ready.append(i)
        return ready_fn(self, i, g)

    rec = {}
    ctx.issue = logged_issue
    bk.BucketSync.ready = logged_ready
    try:
        _, _, hooked_losses = _run_prog(
            program, params(), init_state(params()), batches(), steps,
            lambda: rec.update(hooked=_sub_recorders(ctx, "hooked",
                                                     n_buckets)))
    finally:
        del ctx.issue
        bk.BucketSync.ready = ready_fn
    sig_hooked = tuple((a, plain_signature(s))
                       for a, s in ctx.plan_signature("hooked"))
    program.close()
    with ctx.unrecorded():
        try:
            with ctx.issue("g0"):
                pass
            refused = False
        except RuntimeError:
            refused = True

    post_ctx = make_ctx(mesh, comm_cfg)
    post = StepProgram(_post_backward_builder(cfg, post_ctx, opt, bucket_mb,
                                              torch.device("cpu")),
                       post_ctx, name="post")
    post_issued = []
    post_issue = post_ctx.issue
    post_ctx.issue = lambda tag: (post_issued.append(tag),
                                  post_issue(tag))[1]
    try:
        _, _, post_losses = _run_prog(
            post, params(), init_state(params()), batches(), steps,
            lambda: rec.update(post=_sub_recorders(post_ctx, "post",
                                                   n_buckets)))
    finally:
        del post_ctx.issue
    sig_post = tuple((a, plain_signature(s))
                     for a, s in post_ctx.plan_signature("post"))
    post.close()
    out["hooked"] = {"issued": issued, "ready": ready, "n_buckets": n_buckets,
                     "losses": hooked_losses, "recorders": rec["hooked"],
                     "signature": sig_hooked, "refused": refused,
                     "n_leaves": len(bk.tree_paths(params()))}
    out["post"] = {"issued": post_issued, "losses": post_losses,
                   "recorders": rec["post"], "signature": sig_post}

    # error feedback on (2, 2): the final state checkpointed and restored
    base, _, spec = ef["profile"].partition("!")
    if spec:                        # a degraded profile registers by use
        degrade_profile(PROFILES[base], spec)
    program, ctx = build_train_program(
        cfg, mesh, comm=CommConfig(profile=ef["profile"],
                                   compress=ef["compress"]),
        opt=opt, bucket_mb=ef["bucket_mb"], device="cpu", name="ef")
    p0 = params()
    state = (init_state(p0), ef_init_residuals(p0))
    p, state, losses = _run_prog(program, p0, state, batches(), steps)
    program.close()
    if mesh.axis_index("data") == 0:
        Checkpointer(ckpt_dir, ctx=ctx, specs=specs).save(steps, p, state)
    dist.barrier()
    got_p, got_state, meta = Checkpointer(ckpt_dir, ctx=ctx,
                                          specs=specs).restore(
        p, (init_state(p), ef_init_residuals(p)))
    out["ef"] = {
        "losses": losses, "codec": ctx.ef_codec_name(),
        "rmax": max(float(r.abs().max()) for r in
                    pytree.tree_leaves(state[1])),
        "residuals": flat_leaves(state[1]), "mu": flat_leaves(state[0].mu),
        "restored": {"step": meta["step"], "params": flat_leaves(got_p),
                     "mu": flat_leaves(got_state[0].mu),
                     "residuals": flat_leaves(got_state[1])},
        "params": flat_leaves(p)}
    return out


def ef_train(params_np, runs):
    """tests/test_torch_ef.py on this rank of the (data=2, model=4) mesh:
    each run of ``runs`` trains reduced glm4-9b from the reference's
    initial params (bucketed, error-feedback residuals paired with the
    AdamW state under a lossy codec) and returns its per-step losses and
    the residuals' max (None without them); runs marked ``state`` also
    their final residual tree (this rank's shards, as numpy)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference, shard_params
    from repro_torch.core.communicator import CommConfig
    from repro_torch.core.links import PROFILES, degrade_profile
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_program
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.train_step import ef_init_residuals
    mesh = Mesh((2, 4), ("data", "model"), device="cpu")
    cfg = get_config("glm4-9b").reduced()
    out = {}
    for name, run in runs.items():
        base, _, spec = run["profile"].partition("!")
        if spec:                    # a degraded profile registers by use
            degrade_profile(PROFILES[base], spec)
        params = shard_params(params_from_reference(params_np),
                              param_specs(cfg), mesh.axis_index("model"), 4)
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(profile=run["profile"],
                                       compress=run["compress"],
                                       tag=f"ef-{name}"),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                            total_steps=run["steps"]),
            bucket_mb=run["bucket_mb"], device="cpu", name=name)
        state = init_state(params)
        ef = bool(ctx.ef_codec_name())
        if ef:
            state = (state, ef_init_residuals(params))
        _, state, losses = _run_prog(
            program, params, state,
            make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7),
            run["steps"])
        program.close()
        out[name] = {"losses": losses, "codec": ctx.ef_codec_name(),
                     "rmax": max(float(r.abs().max()) for r in
                                 pytree.tree_leaves(state[1])) if ef else None}
        if run.get("state"):
            out[name]["residuals"] = pytree.tree_map(as_bits, state[1])
    return out


def step_phase() -> str:
    """Where an executed collective runs: the forward, the checkpoint
    recompute (inside the backward, grad mode on) or the backward."""
    if torch._C._current_graph_task_id() == -1:
        return "forward"
    return "recompute" if torch.is_grad_enabled() else "backward"


@contextlib.contextmanager
def executed_calls(calls: list):
    """Within the block, every ``routing.execute`` call adds (axis,
    collective, step phase) to ``calls``."""
    execute = routing.execute

    def counted(plan, x, mesh, **kw):
        calls.append((plan.axis_name, plan.collective.value, step_phase()))
        return execute(plan, x, mesh, **kw)

    routing.execute = counted
    try:
        yield calls
    finally:
        routing.execute = execute


def moe_ep(params_np, runs, steps, a2a_case, ckpt_dir, work_dir):
    """tests/test_torch_moe.py on this rank of the (data=2, model=2)
    mesh:

    * ``ep_all_to_all`` of a (data=2, model=2) ctx on this rank's rows of
      ``a2a_case["x"]``, forward and backward (the loss
      sum(out * out * (rank + 1)));
    * each run of ``runs``: ``steps`` train steps of reduced kimi-k2
      (ep_a2a, 4 experts) through build_train_program, from the
      reference's global init cut by ``rank_specs`` (experts over data,
      their FFN hidden dim over model), the per-step losses, what the
      communicators recorded after step 1 and the collectives executed a
      step by phase;
    * for the run marked ``ckpt``: its final local state, a checkpoint of
      it (every rank saves, rank (0, 0) writes) and what this rank
      restores from the file."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import CommConfig
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import (build_train_program, local_params,
                                          rank_specs)
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.optim.adamw import AdamWConfig, init_state
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    ctx = ParallelCtx(tp_axis="model", dp_axis="data", tp_size=2, dp_size=2,
                      comm_config=CommConfig(**a2a_case["comm"]), mesh=mesh)
    x = _rank_rows(a2a_case["x"], mesh).requires_grad_(True)
    y = ctx.ep_all_to_all(x, split_axis=0, concat_axis=0)
    (y * y * float(mesh.rank + 1)).sum().backward()
    out["a2a"] = {"y": as_bits(y.detach()), "grad": as_bits(x.grad)}

    cfg = get_config("kimi-k2-1t-a32b").reduced()
    for name, run in runs.items():
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(**run["comm"]),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            device="cpu", name=name)
        specs = rank_specs(cfg, ctx)
        params = local_params(params_from_reference(params_np), specs, ctx)
        opt_state = init_state(params)
        batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
        losses, rec, calls = [], None, []
        for i in range(steps):
            with executed_calls(calls) if i == 0 else \
                    contextlib.nullcontext():
                params, opt_state, m = program.step(params, opt_state,
                                                    next(batches))
            losses.append(float(m["loss"]))
            if i == 0 and run.get("record"):
                rec = recording(ctx, name,
                                f"{work_dir}/{name}-rank{mesh.rank}.json")
        program.close()
        out[name] = {"losses": losses, "recording": rec,
                     "executed": dict(collections.Counter(calls))}
        if run.get("ckpt"):
            Checkpointer(ckpt_dir, ctx=ctx, specs=specs).save(
                steps, params, opt_state)
            torch.distributed.barrier()          # rank (0, 0) has written
            got, got_opt, meta = Checkpointer(
                ckpt_dir, ctx=ctx, specs=specs).restore(
                    params, init_state(params))
            state = {"params": params, "mu": opt_state.mu,
                     "nu": opt_state.nu}
            back = {"params": got, "mu": got_opt.mu, "nu": got_opt.nu}
            out["ckpt"] = {
                "step": meta["step"],
                "state": {k: flat_leaves(v) for k, v in state.items()},
                "restored": {k: flat_leaves(v) for k, v in back.items()}}
    return out


def dp_train(arch, params_np, runs, steps):
    """tests/test_torch_ssm.py on this rank of the (data=2, model=1)
    mesh: each run of ``runs``, ``steps`` train steps of ``arch``
    reduced from the reference's initial params through
    build_train_program; the per-step losses and the data axis's plan
    signature after the run."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import CommConfig
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_program
    from repro_torch.optim.adamw import AdamWConfig, init_state
    mesh = Mesh((2, 1), ("data", "model"), device="cpu")
    cfg = get_config(arch).reduced()
    out = {}
    for name, run in runs.items():
        params = params_from_reference(params_np)
        opt_state = init_state(params)
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(**run["comm"]),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            device="cpu", name=name)
        batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
        losses = []
        for _ in range(steps):
            params, opt_state, m = program.step(params, opt_state,
                                                next(batches))
            losses.append(float(m["loss"]))
        program.close()
        out[name] = {"losses": losses, "signature": tuple(
            (a, plain_signature(s)) for a, s in ctx.plan_signature())}
    return out


def vlm_encdec(params_np, runs, steps, prefill_case, ckpt_dir, ref_ckpt_dir,
               work_dir):
    """tests/test_torch_vlm_encdec.py on this rank of the (data=2,
    model=2) mesh, for each arch of ``params_np`` (reduced, from the
    reference's global init cut to this rank's model-axis shards):

    * each run of ``runs``: ``steps`` train steps through
      build_train_program, the per-step losses, and for the runs marked
      ``record`` what the communicators recorded after step 1;
    * the prefill program on the initial params and ``prefill_case``'s
      global batch (fresh communicators for each arch and for the prefill,
      as the reference's runs): this rank's last-position local-vocab logits;
    * for the arch marked in ``ckpt_dir`` (a dict arch -> dir): the run
      marked ``ckpt``'s final local state, a checkpoint of it (data row 0
      saves, model rank 0 writes), and the local shards this rank
      restores from the reference's checkpoint in ``ref_ckpt_dir``."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import (build_prefill_program,
                                          build_train_program, local_params,
                                          rank_specs)
    from repro_torch.optim.adamw import AdamWConfig, init_state
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for arch, init in params_np.items():
        cfg = get_config(arch).reduced()
        res = out[arch] = {}
        comm_destroy_all()          # fresh balancers, as the reference's
        for name, run in runs.items():
            program, ctx = build_train_program(
                cfg, mesh, comm=CommConfig(**run["comm"]),
                opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                device="cpu", name=name)
            specs = rank_specs(cfg, ctx)
            params = local_params(params_from_reference(init), specs, ctx)
            opt_state = init_state(params)
            batches = make_batches(cfg, seq_len=32, batch_per_shard=4,
                                   seed=7)
            losses, rec = [], None
            for i in range(steps):
                params, opt_state, m = program.step(params, opt_state,
                                                    next(batches))
                losses.append(float(m["loss"]))
                if i == 0 and run.get("record"):
                    rec = recording(ctx, name, f"{work_dir}/{arch}-{name}-"
                                    f"rank{mesh.rank}.json")
            program.close()
            res[name] = {"losses": losses, "recording": rec}
            if run.get("ckpt") and arch in ckpt_dir:
                state = {"params": params, "mu": opt_state.mu,
                         "nu": opt_state.nu}
                res["state"] = {k: flat_leaves(v) for k, v in state.items()}
                if mesh.axis_index("data") == 0:
                    Checkpointer(ckpt_dir[arch], ctx=ctx, specs=specs).save(
                        steps, params, opt_state)
                got, got_opt, meta = Checkpointer(
                    ref_ckpt_dir[arch], ctx=ctx, specs=specs).restore(
                        params, init_state(params))
                res["restored"] = {"step": meta["step"],
                                   "params": flat_leaves(got),
                                   "mu": flat_leaves(got_opt.mu),
                                   "nu": flat_leaves(got_opt.nu)}
        comm_destroy_all()
        program, ctx = build_prefill_program(
            cfg, mesh, comm=CommConfig(**prefill_case["comm"]),
            device="cpu", name="prefill")
        params = local_params(params_from_reference(init),
                              rank_specs(cfg, ctx), ctx)
        res["prefill"] = as_bits(program(params, prefill_case[arch]))
        program.close()
    return out


def spec_block(x: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    """The block of a global array at the mesh position ``coords`` (axis
    -> index, ``sizes`` axis -> size) by a per-dim spec of
    ``launch/shapes.py``: None whole, an axis name split over it, a tuple
    of axes split over all of them, outermost first."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        i, n = 0, 1
        for a in (axes,) if isinstance(axes, str) else axes:
            i, n = i * sizes[a] + coords[a], n * sizes[a]
        size = x.shape[dim] // n
        x = np.take(x, range(i * size, (i + 1) * size), axis=dim)
    return np.ascontiguousarray(x)


def serve_config(case):
    """The port's reduced config of a serve case, with its MoE overrides
    (tests/test_torch_serve_sharded.py builds the reference's the same
    way)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"]).reduced()
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return cfg


def _gathered(logits: torch.Tensor, mesh: Mesh, rows_split: bool):
    """The global [B, V] logits of every rank's [B_local, V_local]."""
    full = torch.cat(list(mesh.all_gather(logits, "model")), dim=1)
    if rows_split:
        full = torch.cat(list(mesh.all_gather(full, "data")), dim=0)
    return full


def _local_decode(params, cfg, ctx, case, stream, coords, sizes):
    """This rank's logits each step of the decode over a LOCAL cache
    (``seq_shard=None``: this shard's KV heads, the whole sequence) on the
    same ctx, the global tokens ``stream`` fed."""
    from repro_torch.models import transformer as T
    dcfg = T.DecodeConfig(cache_len_local=case["seq"], seq_shard=None)
    split = ("data", None) if stream.shape[0] > 1 else (None, None)
    cache = T.init_cache(cfg, ctx, dcfg, stream.shape[0] // (
        2 if split[0] else 1))
    for k, v in case.get("cache", {}).items():
        cache[k].copy_(torch.from_numpy(spec_block(
            v, (None, split[0], None, None, None), coords, sizes)))
    out = []
    with torch.no_grad():
        for t in range(case["steps"]):
            tok = torch.from_numpy(spec_block(stream[:, t:t + 1], split,
                                              coords, sizes))
            logits, cache = T.decode_step(params, cache, tok, t, cfg, ctx,
                                          dcfg)
            out.append(as_bits(logits))
    return out


def serve_sharded(inits, cases, comm, paged, work_dir):
    """tests/test_torch_serve_sharded.py on this rank of the (data=2,
    model=2) mesh:

    * each serve case through build_serve_program (fresh communicators):
      ``steps`` decode steps from position 0, the prompt's tokens first,
      then greedy tokens, the argmax of the logits gathered over the mesh;
      this rank's logits each step, the stream, what the communicators
      recorded after step 1 (and in the ``q_ag`` sub-recorder) and the
      final cache;
    * ``paged``: ``paged_decode_step`` on a ctx of the model axis alone,
      for each impl, over the ticks: this rank's logits each tick and
      the final pool."""
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.steps import (build_serve_program,
                                          local_params, rank_specs)
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.models import transformer as T
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    coords = {a: mesh.axis_index(a) for a in mesh.axes}
    sizes = {a: mesh.axis_size(a) for a in mesh.axes}
    out = {}
    for name, c in cases.items():
        cfg = serve_config(c)
        comm_destroy_all()              # fresh balancers, as the reference's
        b = c["prompt"].shape[0]
        shape = SH.InputShape(name, "decode", c["seq"], b)
        program, ctx, dcfg = build_serve_program(
            cfg, mesh, shape, comm=CommConfig(**comm), name="serve",
            device="cpu")
        params = local_params(params_from_reference(inits[c["arch"]]),
                              rank_specs(cfg, ctx), ctx)
        specs = SH.input_partition_specs(cfg, shape, tp=2, dp=2)["cache"]
        cache = T.init_cache(cfg, ctx, dcfg, b // 2 if b > 1 else 1,
                             device="cpu")
        for k, v in c.get("cache", {}).items():   # whisper's cross cache
            cache[k].copy_(torch.from_numpy(spec_block(v, specs[k], coords,
                                                       sizes)))
        toks = [c["prompt"][:, t] for t in range(c["prompt"].shape[1])]
        res = out[name] = {"logits": []}
        for t in range(c["steps"]):
            logits, cache = program.step(params, cache, toks[t][:, None], t)
            res["logits"].append(as_bits(logits))
            if t == 0:
                res["recording"] = recording(
                    ctx, "serve", f"{work_dir}/{name}-rank{mesh.rank}.json")
                res["q_ag"] = {comm_.axis_name: [
                    (op.value, n, win) for op, n, win in
                    comm_.recorder("serve/q_ag").issued_calls()]
                    for comm_ in ctx.comms()}
            if t + 1 >= len(toks):
                toks.append(_gathered(logits, mesh, b > 1).argmax(-1).numpy()
                            .astype(np.int32))
        program.close()
        res["stream"] = np.stack(toks, 1)
        res["cache"] = {k: as_bits(v) for k, v in cache.items()}
        res["local"] = _local_decode(params, cfg, ctx, c, res["stream"],
                                     coords, sizes)
    if paged:
        cfg = serve_config(paged)
        comm_destroy_all()
        ctx = ParallelCtx(tp_axis="model", tp_size=2,
                          comm_config=CommConfig(**comm), mesh=mesh)
        params = local_params(params_from_reference(inits[paged["arch"]]),
                              rank_specs(cfg, ctx), ctx)
        for impl in ("reference", "kernel"):
            pcfg = T.PagedConfig(attn_impl=impl, **paged["pcfg"])
            pool = T.init_paged_pool(cfg, ctx, pcfg, device="cpu")
            logits = []
            with torch.no_grad():
                for tick in paged["ticks"]:
                    lg, pool = T.paged_decode_step(
                        params, pool, *(torch.from_numpy(a) for a in tick),
                        cfg, ctx, pcfg)
                    logits.append(as_bits(lg))
            out[f"paged-{impl}"] = {"logits": logits, "pool": {
                k: as_bits(v) for k, v in pool.items()}}
    return out


def _cluster_comm(layout, profile, cache, mesh, tag):
    """tests/test_cluster.py's ``_cluster_comm`` on this rank's (node,
    data) mesh: the intra tier on data, the NIC tier on node (ortho over
    data), both warm-started from ``cache``."""
    from repro_torch.cluster.communicator import ClusterCommunicator
    from repro_torch.cluster.topology import make_cluster
    from repro_torch.core.communicator import CommConfig, FlexCommunicator
    n, m = layout
    topo = make_cluster(profile, n)
    intra = (FlexCommunicator("data", m, CommConfig(
        profile=profile, tuning_cache=cache, tag=f"{tag}-intra"),
        mesh=mesh) if m > 1 else None)
    inter = (FlexCommunicator("node", n, CommConfig(
        profile=topo.nic_tier.name, tuning_cache=cache,
        tag=f"{tag}-inter"), ortho_name="data" if m > 1 else None,
        mesh=mesh) if n > 1 else None)
    return ClusterCommunicator(topo, intra, inter)


def _cluster_op(cc, op, x):
    if op == "all_gather":
        return cc.all_gather(x, tiled=True)
    return getattr(cc, op)(x)


def cluster(case):
    """tests/test_torch_cluster.py on this rank (8 ranks, or 4):

    * ``coll``: each hierarchical collective of a ClusterCommunicator on
      its (node, data) layout, this rank's row block of the global
      payload in, warm-started from ``case["cache"]``; the tiers' plan
      signatures; the N=1 cases also through the bare intra communicator;
    * ``ctx``: ParallelCtx cases on (node, data, model) meshes: the
      gradient reduce of a row block, comms order, plan signature and the
      comm report's tiers and cluster block;
    * ``metrics``: the fused metrics reduce on (node, data) and the nested
      node / data psums;
    * ``parity``: monolithic and bucketed ``sync_grads`` of small-integer
      gradients on (node=2, data=4);
    * ``train``: reduced glm4-9b runs from the reference's initial params
      through build_train_program on each run's mesh: per-step losses."""
    import json
    from types import SimpleNamespace
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import (CommConfig, FlexCommunicator,
                                               comm_destroy_all)
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import (build_train_program, local_params,
                                          rank_specs)
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.train_step import sync_grads
    world, rank = dist.get_world_size(), dist.get_rank()
    meshes = {}

    def mesh_of(shape, axes):
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = Mesh(shape, axes, device="cpu")
        return meshes[(shape, axes)]

    def rows(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.split(x, world)[rank]))

    out = {"coll": {}, "ctx": {}, "parity": {}, "train": {}}
    for name, c in case.get("coll", {}).items():
        comm_destroy_all()
        mesh = mesh_of(tuple(c["layout"]), ("node", "data"))
        cc = _cluster_comm(c["layout"], c["profile"], case["cache"], mesh,
                           name)
        xs = {op: rows(c["x_ar" if op == "all_reduce" else "x"]).to(
            getattr(torch, c["dtype"])) for op in c["ops"]}
        got = {op: as_bits(_cluster_op(cc, op, xs[op])) for op in c["ops"]}
        got["signature"] = tuple((a, plain_signature(s))
                                 for a, s in cc.plan_signature())
        got["hierarchical"] = cc.hierarchical
        if c["layout"][0] == 1:         # N=1: the bare communicator
            flat = FlexCommunicator("data", c["layout"][1], CommConfig(
                profile=c["profile"], tuning_cache=case["cache"],
                tag=f"{name}-flat"), mesh=mesh)
            got["flat"] = {op: as_bits(_cluster_op(flat, op, xs[op]))
                           for op in c["ops"]}
            got["flat_signature"] = plain_signature(flat.plan_signature())
        out["coll"][name] = got

    for name, c in case.get("ctx", {}).items():
        comm_destroy_all()
        mesh = mesh_of(tuple(c["shape"]), ("node", "data", "model"))
        sizes = dict(zip(("node", "data", "model"), c["shape"]))
        ctx = ParallelCtx(
            tp_axis="model" if sizes["model"] > 1 else None,
            dp_axis="data" if sizes["data"] > 1 else None,
            node_axis="node", tp_size=sizes["model"],
            dp_size=sizes["data"], node_size=sizes["node"], mesh=mesh,
            comm_config=CommConfig(profile=c["profile"], tag=name))
        # the payload splits over (node, data); model ranks share a block
        shards = sizes["node"] * sizes["data"]
        i = ctx.node_index() * sizes["data"] + ctx.dp_index()
        x = torch.from_numpy(np.ascontiguousarray(
            np.split(c["x"], shards)[i]))
        y = ctx.grad_all_reduce({"w": x})["w"]
        rep = ctx.comm_report()
        out["ctx"][name] = {
            "y": as_bits(y), "axes": [cm.axis_name for cm in ctx.comms()],
            "signature": tuple((a, plain_signature(s))
                               for a, s in ctx.plan_signature()),
            "tiers": {a: rep[a]["tier"] for a in rep if a != "cluster"},
            "cluster": json.dumps(rep.get("cluster"), sort_keys=True,
                                  default=str),
            "hierarchical": ctx._cluster_comm.hierarchical,
            "ep": (ctx.ep_axes, ctx.ep_size, ctx.ep_spec_axis())}

    if "metrics" in case:
        c = case["metrics"]
        comm_destroy_all()
        mesh = mesh_of((2, 4), ("node", "data"))
        ctx = ParallelCtx(dp_axis="data", node_axis="node", dp_size=4,
                          node_size=2, mesh=mesh,
                          comm_config=CommConfig(profile="tpu_v5e",
                                                 tag="ov-metrics"))
        v = rows(c["x"])
        fused = ctx.metrics_reduce({"loss": v.sum()},
                                   {"lr": torch.tensor(0.5)})
        nested = ctx.node_psum(ctx.dp_psum_small(v.sum()))
        out["metrics"] = {"loss": as_bits(fused["loss"]),
                          "lr": as_bits(fused["lr"]),
                          "nested": as_bits(nested)}

    for name, c in case.get("parity", {}).items():
        comm_destroy_all()
        mesh = mesh_of((2, 4), ("node", "data"))
        ctx = ParallelCtx(dp_axis="data", node_axis="node", dp_size=4,
                          node_size=2, mesh=mesh,
                          comm_config=CommConfig(profile="tpu_v5e",
                                                 tag="ov-node"))
        cfg = SimpleNamespace(moe=SimpleNamespace(impl="ep_a2a")
                              if c["ep"] else None)
        t = pytree.tree_map(lambda a: rows(a).to(getattr(torch, c["dtype"])),
                            c["grads"])
        mono = sync_grads(t, cfg, ctx)
        buck = ctx.await_all(sync_grads(t, cfg, ctx,
                                        bucket_mb=c["bucket_mb"]))
        out["parity"][name] = {"mono": flat_leaves(mono),
                               "buck": flat_leaves(buck)}

    for name, run in case.get("train", {}).items():
        comm_destroy_all()
        mesh = mesh_of(tuple(run["shape"]), tuple(run["axes"]))
        cfg = get_config("glm4-9b").reduced()
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(profile="tpu_v5e", tag=name),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            device="cpu", name=name)
        params = local_params(params_from_reference(case["params"]),
                              rank_specs(cfg, ctx), ctx)
        opt_state = init_state(params)
        batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
        _, _, losses = _run_prog(program, params, opt_state, batches,
                                 run["steps"])
        program.close()
        out["train"][name] = {"losses": losses,
                              "node_size": ctx.node_size,
                              "cluster": ctx._cluster_comm is not None}
    comm_destroy_all()
    return out


def leaf_digests(tree, prefix=""):
    """A nested dict of tensors -> {"a/b/c": sha256 of the leaf's bytes}:
    equal digests are equal bits."""
    import hashlib
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_digests(v, f"{prefix}{k}/"))
        else:
            b = v.detach().contiguous().view(torch.uint8).numpy().tobytes()
            out[prefix + k] = (tuple(v.shape), str(v.dtype),
                               hashlib.sha256(b).hexdigest())
    return out


def elastic(case):
    """tests/test_torch_faults.py's elastic resume on this rank.

    On 8 ranks, for each schedule of ``case["drops"]`` in order: reduced
    glm4-9b from seed-0 weights on (node=2, data=2, model=2) of a 2-node
    h800 cluster, ``case["steps"]`` steps under a FabricClock with the
    schedule's node loss, snapshots every ``case["ckpt_every"]`` steps to
    the run's directory; the lost node's ranks leave, the survivors resume
    through ``make_train_resume``.  The ranks that left one run take part in the
    next, so the last schedule's lost node leaves the process for good.
    On 4 ranks: the fresh (data=2, model=2) launch that restores
    ``case["fresh_from"]`` at ``case["resume"]`` and steps to the end.
    Returns each run's per-rank facts and final param digests."""
    import torch.distributed as dist
    from repro_torch.cluster.topology import make_cluster
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.data.pipeline import make_batches
    from repro_torch.faults import (FabricClock, HealthTimeline,
                                    make_train_resume, parse_fault_schedule,
                                    restore_templates, validate_schedule)
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.steps import (build_train_program, local_params,
                                          rank_specs)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.loop import LoopConfig, run_loop
    cfg = get_config("glm4-9b").reduced()
    steps = case["steps"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)

    def batches_fn():
        return make_batches(cfg, seq_len=case["seq_len"],
                            batch_per_shard=case["batch"])

    out = {}
    if dist.get_world_size() == 4:
        comm_destroy_all()
        mesh = Mesh((2, 2), ("data", "model"), device="cpu")
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(profile="h800", tag="fresh"),
            opt=opt, device="cpu", name="train-fresh")
        specs = rank_specs(cfg, ctx)
        p_tmpl, o_tmpl = restore_templates(cfg, ctx, specs)
        params, opt_state, meta = Checkpointer(
            case["fresh_from"], ctx=ctx, specs=specs).restore(
                p_tmpl, o_tmpl, case["resume"])
        batches = batches_fn()
        hist = []
        for _ in range(case["resume"], steps):
            params, opt_state, metrics = program.step(params, opt_state,
                                                      next(batches))
            hist.append(float(metrics["loss"]))
        program.close()
        return {"fresh": {"rank": mesh.rank, "meta_step": meta["step"],
                          "history": hist,
                          "params": leaf_digests(params)}}
    for name, schedule in case["drops"].items():
        comm_destroy_all()
        cluster = make_cluster("h800", 2, nics_per_node=4, nic_gbit=400.0,
                               name=f"flt-elastic-{name}")
        tl = HealthTimeline(validate_schedule(
            parse_fault_schedule(schedule), profiles=[cluster.nic_tier],
            n_nodes=2))
        comm = CommConfig(profile=cluster.node.name, fault=tl.spec(),
                          tag=name)
        mesh = Mesh((2, 2, 2), ("node", "data", "model"), device="cpu")
        program, ctx = build_train_program(cfg, mesh, comm=comm, opt=opt,
                                           device="cpu", cluster=cluster,
                                           name="train")
        specs = rank_specs(cfg, ctx)
        params = local_params(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), specs, ctx)
        clock = FabricClock(tl).attach(ctx)
        logs = []
        handler = make_train_resume(
            cfg, opt=opt, comm_config=comm, mesh=mesh, cluster=cluster,
            ckpt_dir=case["ckpt"][name], batches_fn=batches_fn,
            log=logs.append)
        loop = LoopConfig(total_steps=steps, log_every=0,
                          ckpt_every=case["ckpt_every"],
                          ckpt_dir=case["ckpt"][name], param_specs=specs,
                          faults=clock, on_node_loss=handler)
        params, _, hist = run_loop(program, params, init_state(params),
                                   batches_fn(), ctx, loop,
                                   log=lambda *_: None)
        program.close()
        new = clock.ctx
        out[name] = {
            "dropped_at": loop.report.get("dropped_at"), "history": hist,
            "logs": logs, "transitions": clock.transitions,
            "reattached": new is not ctx and new.fault_clock is clock,
            "mesh": (new.mesh.ranks, new.mesh.rank, new.mesh.axes,
                     new.node_size),
            "params": leaf_digests(params)}
    comm_destroy_all()
    return out


#: the three-tier cluster's mesh axes, outermost first
POD_AXES = ("pod", "node", "data")


def _comm3(layout, cache, mesh, tag):
    """tests/test_pod.py's ``_comm3`` on this rank's (pod, node, data)
    mesh: one ClusterCommunicator over the h800 cluster of p pods of n
    nodes, tiers of size 1 absent, each warm-started from ``cache``."""
    from repro_torch.cluster.communicator import ClusterCommunicator
    from repro_torch.cluster.topology import make_cluster
    from repro_torch.core.communicator import CommConfig, FlexCommunicator
    p, n, m = layout
    topo = make_cluster("h800", n, nics_per_node=4, nic_gbit=400.0,
                        pods=p, pod_uplinks=4, pod_gbit=400.0)
    intra = (FlexCommunicator("data", m, CommConfig(
        profile="h800", tuning_cache=cache, tag=f"{tag}-intra"),
        mesh=mesh) if m > 1 else None)
    inter = (FlexCommunicator("node", n, CommConfig(
        profile=topo.nic_tier.name, tuning_cache=cache, tag=f"{tag}-inter"),
        ortho_name="data" if m > 1 else None, mesh=mesh) if n > 1 else None)
    pod = (FlexCommunicator("pod", p, CommConfig(
        profile=topo.pod_tier.name, tuning_cache=cache, tag=f"{tag}-pod"),
        ortho_name="node" if n > 1 else None, mesh=mesh) if p > 1 else None)
    return ClusterCommunicator(topo, intra, inter, pod)


def pod(case):
    """tests/test_torch_pod.py on this rank (8 ranks), each input this
    rank's row block of a global payload (a shard_map in_spec over every
    mesh axis):

    * ``coll``: the three-tier all-reduce, all-gather and reduce-scatter
      of a ClusterCommunicator on each (pod, node, data) layout, the
      tiers' plan signatures, and the rail-local ``ep_all_to_all`` where
      the case asks, beside the flat all_to_all over the mesh's plane
      group, with its a2a report and summary;
    * ``a2a2``: the two-tier (node=2, data=4) ``ep_all_to_all`` and the
      flat one;
    * ``parity``: the pods=1 cluster against the two-tier one on (node=2,
      data=4): outputs and plan signatures;
    * ``ctx``: the ctx on (pod=2, node=2, data=2, model=1): its pod
      communicator, ep span, comms order, gradient reduce, plan signature
      and comm report; the fused metrics reduce over the plane;
    * ``train``: reduced runs from the reference's initial params through
      build_train_program on (pod=2, node=2, data=2, model=1): per-step
      losses, the ctx's ep span and this rank's initial expert shards;
    * ``legacy``, last: on ranks 0-3 only, the ctx on the legacy (pod=2,
      data=2, model=1) mesh (built over those ranks alone): its gradient
      and expert reduces (the data tier's, then a plain pod psum)."""
    import json
    import torch.distributed as dist
    from repro_torch.cluster.communicator import ClusterCommunicator
    from repro_torch.cluster.topology import make_cluster
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference
    from repro_torch.core.communicator import (CommConfig, FlexCommunicator,
                                               comm_destroy_all)
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import (build_train_program, local_params,
                                          rank_specs)
    from repro_torch.models.tp import ParallelCtx
    from repro_torch.optim.adamw import AdamWConfig, init_state
    world, rank = dist.get_world_size(), dist.get_rank()
    cache = case["cache"]
    meshes = {}

    def mesh_of(shape, axes, ranks=None):
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = Mesh(shape, axes, device="cpu", ranks=ranks)
        return meshes[key]

    def rows(x, n=world, i=rank):
        return torch.from_numpy(np.ascontiguousarray(np.split(x, n)[i]))

    def sig(comm):
        return tuple((a, plain_signature(s)) for a, s in
                     comm.plan_signature())

    out = {"coll": {}, "parity": {}}
    for name, c in case["coll"].items():
        comm_destroy_all()
        mesh = mesh_of(c["layout"], POD_AXES)
        cc = _comm3(c["layout"], cache, mesh, name)
        dt = getattr(torch, c["dtype"])
        got = {op: as_bits(_cluster_op(cc, op, rows(
            c["x_ar" if op == "all_reduce" else "x"]).to(dt)))
            for op in ("all_reduce", "all_gather", "reduce_scatter")}
        if "x_a2a" in c:
            x = rows(c["x_a2a"]).to(dt)
            got["a2a"] = as_bits(cc.ep_all_to_all(x, 0, 0))
            got["a2a_flat"] = as_bits(mesh.all_to_all(x, POD_AXES))
            got["a2a_report"] = cc.a2a_report()
            got["summary"] = json.dumps(cc.summary(), sort_keys=True,
                                        default=str)
        got["signature"] = sig(cc)
        out["coll"][name] = got

    comm_destroy_all()
    c = case["a2a2"]
    mesh = mesh_of((2, 4), ("node", "data"))
    topo = make_cluster("h800", 2)
    cc = ClusterCommunicator(topo, FlexCommunicator("data", 4, CommConfig(
        profile="h800", tag="a2a2-intra"), mesh=mesh), FlexCommunicator(
        "node", 2, CommConfig(profile=topo.nic_tier.name, tag="a2a2-inter"),
        ortho_name="data", mesh=mesh))
    x = rows(c["x"])
    out["a2a2"] = {"a2a": as_bits(cc.ep_all_to_all(x, 0, 0)),
                   "flat": as_bits(mesh.all_to_all(x, ("node", "data")))}

    for name, c in case["parity"].items():
        comm_destroy_all()
        mesh = mesh_of((2, 4), ("node", "data"))

        def two_tier(tag, topo, mesh=mesh):
            return ClusterCommunicator(topo, FlexCommunicator(
                "data", 4, CommConfig(profile="h800", tag=f"{tag}-intra"),
                mesh=mesh), FlexCommunicator(
                "node", 2, CommConfig(profile=topo.nic_tier.name,
                                      tag=f"{tag}-inter"),
                ortho_name="data", mesh=mesh))
        ccs = (two_tier("par-a", make_cluster("h800", 2)),
               two_tier("par-b", make_cluster("h800", 2, pods=1)))
        x = rows(c["x"])
        out["parity"][name] = {
            "pod": ccs[1].pod is None and ccs[1].comms() == (ccs[1].intra,
                                                              ccs[1].inter),
            "out": [{op: as_bits(_cluster_op(cc, op, x))
                     for op in ("all_reduce", "all_gather",
                                "reduce_scatter")} for cc in ccs],
            "signature": [sig(cc) for cc in ccs]}

    comm_destroy_all()
    c = case["ctx"]
    mesh = mesh_of((2, 2, 2, 1), POD_AXES + ("model",))
    ctx = ParallelCtx(tp_axis="model", dp_axis="data", node_axis="node",
                      pod_axis="pod", tp_size=1, dp_size=2, node_size=2,
                      pod_size=2, mesh=mesh,
                      comm_config=CommConfig(profile="h800", tag="ctx-pod"))
    y = ctx.grad_all_reduce({"w": rows(c["x"])})["w"]
    rep = ctx.comm_report()
    fused = ctx.metrics_reduce({"loss": rows(c["x"]).sum()},
                               {"lr": torch.tensor(0.5)})
    out["ctx"] = {
        "pod_comm": ctx._pod_comm is not None, "n_pods": ctx.cluster.n_pods,
        "ep": (ctx.ep_axes, ctx.ep_size, ctx.ep_spec_axis(),
               ctx.ep_index()),
        "axes": [cm.axis_name for cm in ctx.comms()], "y": as_bits(y),
        "signature": sig(ctx),
        "tiers": {a: rep[a]["tier"] for a in rep if a != "cluster"},
        "cluster": json.dumps(rep["cluster"], sort_keys=True, default=str),
        "metrics": {"loss": as_bits(fused["loss"]),
                    "lr": as_bits(fused["lr"]),
                    "nested": as_bits(ctx.pod_psum(ctx.node_psum(
                        ctx.dp_psum_small(rows(c["x"]).sum()))))}}

    out["train"] = {}
    for name, run in case["train"].items():
        comm_destroy_all()
        mesh = mesh_of((2, 2, 2, 1), POD_AXES + ("model",))
        cfg = get_config(run["arch"]).reduced(**run["reduced"])
        program, ctx = build_train_program(
            cfg, mesh, comm=CommConfig(profile="tpu_v5e", tag=name),
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            device="cpu", name=name)
        specs = rank_specs(cfg, ctx)
        params = local_params(params_from_reference(run["params"]), specs,
                              ctx)
        batches = make_batches(cfg, seq_len=32, batch_per_shard=8, seed=7)
        got = {"ep": (ctx.ep_axes, ctx.ep_size, ctx.ep_index()),
               "axes": [cm.axis_name for cm in ctx.comms()]}
        if cfg.moe is not None:
            # copies: the step updates the params in place
            got["experts"] = {k: v.copy() for k, v in flat_leaves(
                params["layers"]["moe"]["experts"]).items()}
        _, _, got["losses"] = _run_prog(program, params, init_state(params),
                                        batches, run["steps"])
        got["tiers"] = sorted(ctx.comm_report()["cluster"]["rollup"])
        program.close()
        out["train"][name] = got
    comm_destroy_all()
    c = case["legacy"]
    if rank < 4:
        mesh = mesh_of((2, 2, 1), ("pod", "data", "model"),
                       ranks=range(4))
        ctx = ParallelCtx(tp_axis="model", dp_axis="data", pod_axis="pod",
                          tp_size=1, dp_size=2, pod_size=2, mesh=mesh,
                          comm_config=CommConfig(profile="h800",
                                                 tuning_cache=cache,
                                                 tag="legacy"))
        y = ctx.grad_all_reduce({"w": rows(c["x"], 4)})["w"]
        out["legacy"] = {"y": as_bits(y), "signature": sig(ctx),
                         "pod_comm": ctx._pod_comm is not None,
                         "cluster": ctx._cluster_comm is not None,
                         "expert": as_bits(ctx.expert_grad_reduce(
                             rows(c["x"], 4))),
                         "ep": (ctx.ep_axes, ctx.ep_size)}

    comm_destroy_all()
    return out


def lowered_vs_live(pinned: str, cases: dict):
    """tests/test_torch_dryrun.py on this rank of a (data=2, model=2)
    mesh: for each case, the program ``StepProgram.lower`` lowers on meta
    arguments, then one live call of it on the same shapes under a trace
    scope of the mesh; the two logs and plan signatures come back.  Both
    axes' all-reduce slots are pinned by ``pinned`` to three routes."""
    from repro_torch.configs import get_config
    from repro_torch.core.communicator import CommConfig, comm_destroy_all
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import (build_serve_program,
                                          build_train_program, local_params,
                                          rank_specs)
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.optim.adamw import init_state
    from repro_torch.runtime.program import meta_like
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    cfg = get_config("glm4-9b").reduced()
    out = {}
    for name, c in cases.items():
        comm_destroy_all()
        comm = CommConfig(profile="h100", tuning_cache=pinned)
        if c["kind"] == "train":
            program, ctx = build_train_program(
                cfg, mesh, comm=comm, name=name, bucket_mb=c["bucket_mb"],
                device="cpu")
        else:
            program, ctx, dcfg = build_serve_program(
                cfg, mesh, InputShape(name, "decode", c["seq"],
                                      c["batch"]),
                comm=comm, name=name, device="cpu")
        params = local_params(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"),
            rank_specs(cfg, ctx), ctx)
        if c["kind"] == "train":
            args = (params, init_state(params), c["batch"])
        else:
            cache = init_cache(cfg, ctx, dcfg, c["batch"] // 2,
                               device="cpu")
            args = (params, cache, c["token"], c["pos"])
        lowered = program.lower(*meta_like(args))
        with mesh.tracing() as live:
            program(*args)
        sig = ctx.plan_signature(name)
        program.observe()
        program.close()
        out[name] = {"lowered": (lowered.log.traced, lowered.log.executed),
                     "live": (live.traced, live.executed),
                     "signatures": (lowered.plan_signature, sig)}
    comm_destroy_all()
    return out
