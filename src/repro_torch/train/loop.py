"""Host-side training loop: data feeding, metrics, checkpointing.

Port of ``src/repro/train/loop.py`` without fault schedules: the
``faults`` and ``on_node_loss`` hooks of the reference's LoopConfig raise
until the fault tier is ported (ROADMAP queue 1 item 13).  The Stage-2
execute -> observe -> rebuild lifecycle lives in the StepProgram runtime
(runtime/program.py): each tick runs through the plan-keyed executable
cache and feeds the executed step's collectives back to the balancers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
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
    #: the reference's FabricClock and elastic node-loss handler: not
    #: ported (ROADMAP queue 1 item 13); anything but None raises
    faults: Optional[object] = None
    on_node_loss: Optional[Callable] = None
    #: filled by run_loop on completion: the final program/ctx status
    report: Optional[Dict] = None


def run_loop(step: Union[StepProgram, Callable[[], Callable]],
             params, opt_state,
             batches: Iterator[Dict[str, np.ndarray]],
             ctx: ParallelCtx, loop: LoopConfig,
             log: Callable[[str], None] = print):
    """Drive training through a :class:`StepProgram` (or a zero-arg
    builder, wrapped into one here and retired at the end).  Returns
    (params, opt_state, per-step losses)."""
    if loop.faults is not None or loop.on_node_loss is not None:
        raise NotImplementedError("fault schedules and elastic node loss "
                                  "are not ported yet: ROADMAP queue 1 "
                                  "item 13")
    program = step if isinstance(step, StepProgram) \
        else StepProgram(step, ctx)
    owned = program is not step
    ckpt = (Checkpointer(loop.ckpt_dir, ctx=ctx, specs=loop.param_specs)
            if loop.ckpt_dir else None)
    history = []
    t0 = time.time()
    try:
        for i in range(loop.total_steps):
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
