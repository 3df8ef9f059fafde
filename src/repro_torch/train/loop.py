"""Host-side training loop: data feeding, metrics, checkpointing.

Port of ``src/repro/train/loop.py``.  The Stage-2 execute -> observe ->
rebuild lifecycle lives in the StepProgram runtime (runtime/program.py):
each tick runs through the plan-keyed executable cache and feeds the
executed step's collectives back to the balancers.

With a fault schedule (repro_torch.faults, DESIGN.md §14) the loop also
advances the FabricClock at the top of every step.  Degrade transitions
apply inside the communicators (the clock has swapped the profiles by the
time ``advance`` returns); a committed NODE loss hands control to the
``on_node_loss`` handler, which on a survivor rebuilds mesh, program, ctx
and state at the surviving topology and rewinds the step counter to the
restored checkpoint (which is why the loop is a ``while``), and on a rank
of the lost node returns ``NodeLeft``: the loop stops there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import ep_sharded, respec_ep
from repro_torch.core.communicator import comm_release
from repro_torch.faults.elastic import NodeLeft
from repro_torch.models.tp import ParallelCtx
from repro_torch.runtime.program import StepProgram


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0           # 0 = only final
    ckpt_dir: Optional[str] = None
    #: the ``transformer.param_specs`` tree: on a model axis the params
    #: are rank-local shards, and the checkpointer gathers them by it
    param_specs: Optional[dict] = None
    #: TuningProfile path: when set, the loop persists every axis'
    #: converged Stage-1 shares at the end so the next launch warm-starts
    #: with zero Algorithm-1 iterations (control/profile.py).
    tuning_cache: Optional[str] = None
    #: FabricClock (repro_torch.faults) — None on the fault-free path,
    #: where the loop body is exactly the historical per-step arithmetic.
    faults: Optional[object] = None
    #: elastic node-loss handler (``repro_torch.faults.make_train_resume``):
    #: (transition, step) -> (program, ctx, params, opt_state, batches,
    #: resume_step) on a survivor, ``NodeLeft`` on a rank of the lost
    #: node.  Required when the schedule contains node events.
    on_node_loss: Optional[Callable] = None
    #: filled by run_loop on completion: the FINAL program/ctx status —
    #: after an elastic swap the caller's program/ctx references are the
    #: retired pre-drop objects, so launchers report from here.  On a rank
    #: of a lost node it holds ``dropped_at``, the step it left at.
    report: Optional[Dict] = None


def saves_checkpoints(ctx: ParallelCtx, specs) -> bool:
    """Whether this rank takes part in the Checkpointer's saves: the ranks
    of pod 0, node 0 and data row 0 (model rank 0 of them writes), or
    every rank when the ep span shards leaves (ep_a2a experts), whose save
    gathers over it."""
    return (ctx.mesh is None
            or (ctx.pod_index() == 0 and ctx.node_index() == 0
                and ctx.dp_index() == 0)
            or (specs is not None and ep_sharded(specs, ctx)))


def _checkpointer(loop: LoopConfig, ctx: ParallelCtx
                  ) -> Optional[Checkpointer]:
    if not loop.ckpt_dir or not saves_checkpoints(ctx, loop.param_specs):
        return None
    return Checkpointer(loop.ckpt_dir, ctx=ctx, specs=loop.param_specs)


def run_loop(step: Union[StepProgram, Callable[[], Callable]],
             params, opt_state,
             batches: Iterator[Dict[str, np.ndarray]],
             ctx: ParallelCtx, loop: LoopConfig,
             log: Callable[[str], None] = print):
    """Drive training through a :class:`StepProgram` (or a zero-arg
    builder, wrapped into one here and retired at the end).  Returns
    (params, opt_state, per-step losses); a step replayed after an elastic
    resume is recorded again.  Only the ranks of node 0 and data row 0
    (``saves_checkpoints``, decided again on a rebuilt mesh) save to
    ``loop.ckpt_dir``."""
    program = step if isinstance(step, StepProgram) \
        else StepProgram(step, ctx)
    owned = program is not step
    ckpt = _checkpointer(loop, ctx)
    history = []
    t0 = time.time()
    i = 0
    left: Optional[NodeLeft] = None
    try:
        while i < loop.total_steps:
            if loop.faults is not None:
                swap = _advance_faults(loop, program, ctx, i, log)
                if isinstance(swap, NodeLeft):
                    left = swap
                    comm_release(ctx.mesh)
                    break
                if swap is not None:
                    # elastic resume: retire the old program and the old
                    # mesh's communicators (their groups hold ranks that
                    # are gone), rewind to the restored snapshot.  close()
                    # is idempotent, so a caller's finally on the old
                    # program reference stays harmless.
                    program.close()
                    comm_release(ctx.mesh)
                    (program, ctx, params, opt_state, batches, i) = swap
                    owned = True
                    loop.faults.attach(ctx)
                    # who saves is decided again on the rebuilt mesh, and
                    # ep_a2a experts shard over its ep span
                    if loop.param_specs is not None:
                        loop.param_specs = respec_ep(
                            loop.param_specs, ctx.ep_spec_axis() or "data")
                    ckpt = _checkpointer(loop, ctx)
                    continue
            batch = next(batches)
            params, opt_state, metrics = program.step(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])
            history.append(loss)
            if loop.log_every and (i % loop.log_every == 0
                                   or i == loop.total_steps - 1):
                dt = time.time() - t0
                log(f"step {i:5d}  loss {loss:.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"lr {float(metrics['lr']):.2e}  {dt:.1f}s")
            if ckpt and loop.ckpt_every and (i + 1) % loop.ckpt_every == 0:
                ckpt.save(i + 1, params, opt_state)
            i += 1
        if left is not None:
            loop.report = {"program": program.report(),
                           "dropped_at": left.step}
            return params, opt_state, history
        if ckpt:
            ckpt.save(loop.total_steps, params, opt_state)
        ec = program.cache.report()
        if loop.log_every:
            log(f"executable cache: {ec['rebuilds']} rebuilds, "
                f"{ec['hits']} hits, {ec['evictions']} evictions over "
                f"{loop.total_steps} steps")
            status = ctx.tuning_status()
            if status:
                warm = sum(s["warm"] for slots in status.values()
                           for s in slots.values())
                total = sum(len(slots) for slots in status.values())
                log(f"stage-1 slots: {warm}/{total} warm-started "
                    f"(timing source: {ctx.timing_kind()})")
        if loop.tuning_cache:
            n = ctx.save_tuning_profile(loop.tuning_cache)
            if loop.log_every:
                log(f"tuning profile: {n} slots -> {loop.tuning_cache}")
        loop.report = {"program": program.report(),
                       "tuning": ctx.tuning_status()}
    finally:
        if owned:
            program.close()
    return params, opt_state, history


def _advance_faults(loop: LoopConfig, program: StepProgram,
                    ctx: ParallelCtx, i: int, log):
    """One FabricClock tick.  Returns the handler's answer when a node
    loss committed (at most one per step — a schedule dropping two nodes
    at once resumes once at the first and re-commits the second on a
    later tick, since fabric time is monotone), else None."""
    for tr in loop.faults.advance(i):
        if tr["kind"] == "node":
            if loop.on_node_loss is None:
                raise RuntimeError(
                    f"fault schedule lost node{tr['node']} at step "
                    f"{tr['step']} but no on_node_loss handler is "
                    f"configured (launch built without --ckpt-dir?)")
            return loop.on_node_loss(tr, i)
        if loop.log_every:
            log(f"fault: fabric -> {tr['state'] or ['healthy']} at step "
                f"{tr['step']} (re-keyed: {sorted(tr['rekeyed'])})")
    return None
