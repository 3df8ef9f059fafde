"""Training cells: the program's train step, driven as its launcher builds
it (``repro_torch.launch.steps.build_train_program`` over the ctx of a
(data, 1) ``Mesh`` of one card a rank, or over one device's ctx).

On each rank, set-up builds the one step program, hands it the seeded
weights and fresh AdamW state, and drives it through the checked steps on
pool batches 0, 1, 2, whose readings ``compare.py`` holds against the
reference.  It then warms up until the executable cache and the plan
signature stop changing, times the last warm steps, and rank 0 fixes the
window's step count from them.  The window runs those steps back to back
and ends on a synchronize and a barrier on every rank.  A traced run then
profiles ``TRACE_STEPS`` more steps.  Once the peak memory is read and
the program's state freed, the reference runs the checked steps again.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from bench import cells, compare, faults
from bench import trace as TR
from bench import traffic as T
from bench import weights as W
from bench.reference import train as reference

#: training steps that set-up checks against the reference
CHECKED_STEPS = 3
#: warm-up steps after them: at least, and at most
WARM_MIN, WARM_MAX = 3, 12
#: steps a traced run profiles after its window
TRACE_STEPS = 3
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(world: int) -> None:
    if world > 1:
        dist.barrier()


class Job:
    """One rank's program, ctx and token pool for one cell."""

    def __init__(self, spec: Dict):
        from repro_torch.core.communicator import CommConfig
        from repro_torch.launch.steps import build_train_program
        from repro_torch.optim.adamw import AdamWConfig
        self.cfg, self.cell, self.traffic = (spec["config"], spec["cell"],
                                             spec["traffic"])
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if spec["device"] == "cuda" else torch.device("cpu"))
        self.arch = cells.program_config(self.cfg)
        mesh = None
        if self.world > 1:
            from repro_torch.launch.mesh import Mesh
            mesh = Mesh((self.world, 1), ("data", "model"),
                        device=spec["device"])
        prog = self.cell["program"]
        comm = CommConfig(backend=prog["backend"], profile=prog["profile"],
                          timing=prog["timing"])
        self.opt = self.cell["optimizer"]
        self.program, self.ctx = build_train_program(
            self.arch, mesh, comm=comm, opt=AdamWConfig(**self.opt),
            remat=prog["remat"], bucket_mb=prog["bucket_mb"],
            device=self.device)
        self.params = self.state = None
        self.g1: Dict = {}

    # -- state ---------------------------------------------------------------

    def fresh(self, seed: int) -> None:
        """The seed's weights and token pool, and a fresh AdamW state."""
        from repro_torch.launch.steps import (eval_shape_params,
                                              local_params, rank_specs)
        from repro_torch.optim.adamw import init_state
        self.free()
        self.seed = seed
        params = W.make(self.cfg, seed, self.device)
        errs = W.layout_errors(params, eval_shape_params(self.arch))
        if errs:
            raise ValueError("the weights' tree is not the program's: "
                             + "; ".join(errs))
        self.params = local_params(params, rank_specs(self.arch, self.ctx),
                                   self.ctx)
        self.state = init_state(self.params)
        self.pool = T.token_pool(self.traffic, self.cfg["vocab_size"], seed,
                                 self.device)
        self.k = 0

    def free(self) -> None:
        """Drop the program's weights and optimizer state (the pool and
        the seed stay for the reference)."""
        self.params = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def step(self):
        self.params, self.state, metrics = self.program.step(
            self.params, self.state, T.batch(self.pool, self.k))
        self.k += 1
        return metrics

    def _adam(self):
        s = self.state
        return s if hasattr(s, "mu") else s[0]

    # -- phases --------------------------------------------------------------

    def checked_steps(self) -> Dict:
        """The checked steps: each loss, the step-1 gradient norms from
        the first moment, the change norms after the last."""
        losses, grads = [], {}
        for i in range(CHECKED_STEPS):
            m = self.step()
            losses.append(float(m["loss"]))
            if i == 0:
                mu = W.flatten(self._adam().mu)
                grads = compare.optimizer_grad_norms(
                    compare.leaf_norms(mu), float(m["grad_norm"]), self.opt)
                self.g1 = compare.host_grads(mu, float(m["grad_norm"]),
                                             self.opt, self.arch.dtype)
        change = {}
        now = dict(W.flatten(self.params))
        for path, x0 in W.leaves(self.cfg, self.seed, self.device):
            change[reference.name(path)] = reference.norm(
                now[path].float() - x0.float())
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change}

    def warm(self) -> Tuple[float, int]:
        """Warm-up steps until a step neither rebuilds nor re-keys: the
        median time of the last three (each ended by a synchronize) and
        the number of steps."""
        times: List[float] = []
        while len(times) < WARM_MAX:
            before = (self.program.cache.report()["rebuilds"],
                      self.program.plan_rekeys)
            _sync(self.device)
            t0 = time.perf_counter()
            self.step()
            _sync(self.device)
            times.append(time.perf_counter() - t0)
            settled = before == (self.program.cache.report()["rebuilds"],
                                 self.program.plan_rekeys)
            if settled and len(times) >= WARM_MIN:
                break
        return statistics.median(times[-3:]), len(times)

    def window(self, n: int) -> Dict:
        """``n`` steps back to back, from a barrier to a synchronize and a
        barrier."""
        before = (self.program.cache.report()["rebuilds"],
                  self.program.plan_rekeys)
        cuda = self.device.type == "cuda"
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(n + 1)] if cuda else []
        _sync(self.device)
        _barrier(self.world)
        t_start = time.time()
        t0 = time.perf_counter()
        losses = []
        for i in range(n):
            if cuda:
                marks[i].record()
            losses.append(self.step()["loss"])
        if cuda:
            marks[n].record()
        _sync(self.device)
        _barrier(self.world)
        window_s = time.perf_counter() - t0
        after = (self.program.cache.report()["rebuilds"],
                 self.program.plan_rekeys)
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return {"t_start": t_start, "window_s": window_s, "steps": n,
                "step_ms": step_ms,
                "failed": bad, "last_loss": float(losses[-1]),
                "rebuilds": after[0] - before[0],
                "rekeys": after[1] - before[1]}

    def sync_calls(self) -> List[Dict]:
        """The gradient all-reduce calls of one step and the plans they
        take now: bytes, element size and the plan's units per route."""
        from repro_torch.core.communicator import bucket_for
        from repro_torch.core.topology import Collective
        from repro_torch.train.bucketer import GradBucketer
        comm = next((c for c in self.ctx.comms() if c.axis_name == "data"),
                    None)
        if comm is None:
            return []
        bucket_mb = self.cell["program"]["bucket_mb"]
        if bucket_mb > 0:
            sizes = [b.nbytes for b in GradBucketer(
                self.params, bucket_mb=bucket_mb).buckets]
        else:
            sizes = [x.numel() * x.element_size()
                     for _, x in W.flatten(self.params)]
        elem = next(iter(W.flatten(self.params)))[1].element_size()
        out = []
        for nbytes in sizes:
            plan = comm.plan_cache.current(Collective.ALL_REDUCE,
                                           bucket_for(nbytes))
            out.append({"nbytes": nbytes, "elem": elem,
                        "units": plan.units() if plan else None,
                        "grain": plan.grain if plan else None,
                        "ranks": self.world})
        return out

    def traced(self, steps: int) -> Dict:
        calls = []

        def run(n):
            for _ in range(n):
                calls.append(self.sync_calls())
                self.step()
        summary = TR.capture(run, steps, f"rank{self.rank}")
        summary["sync_calls"] = calls
        summary["main_stream"] = TR.main_stream(summary["ops"])
        return summary

    def reference(self, variant: str = "reference", judge=None,
                  keep: Optional[Dict] = None
                  ) -> Tuple[Dict, Dict[str, float]]:
        """The reference's (or a variant's) checked steps, and the
        gradient distances of ``judge`` (leaf -> step-1 gradient; the
        program's by default) from the reference's step-1 gradient, or of
        a variant's from ``judge``, the reference's.  ``keep`` receives
        the step-1 gradient on the host."""
        batches = [T.batch(self.pool, k) for k in range(CHECKED_STEPS)]
        diffs: Dict[str, float] = {}
        base = self.g1 if judge is None else judge

        def on_grads(names, grads):
            mine = dict(zip(names, grads))
            if variant == "reference":
                diffs.update(compare.grad_diffs(base, mine, self.device))
            else:
                diffs.update(compare.grad_diffs(mine, base, self.device))
            if keep is not None:
                keep.update({k: g.cpu() for k, g in mine.items()})
        got = reference.run(self.cfg, self.opt, self.seed, batches,
                            self.device, rank=self.rank, world=self.world,
                            variant=variant, on_grads=on_grads)
        return got, diffs

    def close(self) -> None:
        self.free()
        self.pool = None
        self.program.close()


def _broadcast_int(n: int, world: int, device) -> int:
    if world == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())


def rank_run(spec: Dict) -> Dict:
    """One rank's whole run; the parent assembles the ranks' results."""
    with faults.planted(spec.get("fault", "")):
        t_job = time.time()
        job = Job(spec)
        try:
            return _run(job, spec, t_job)
        finally:
            job.close()


def _run(job: Job, spec: Dict, t_job: float) -> Dict:
    # set-up's phases, in seconds: to the program's build, the build,
    # the weights, the checked steps, the warm-up
    marks = [spec["t_process"], t_job, time.time()]
    job.fresh(spec["seed"])
    marks.append(time.time())
    prog = job.checked_steps()
    marks.append(time.time())
    step_s, warm_steps = job.warm()
    marks.append(time.time())
    n = _broadcast_int(max(1, math.ceil(spec["seconds"] / step_s)),
                       job.world, job.device)
    win = job.window(n)
    out = {"rank": job.rank, "setup_s": win["t_start"] - spec["t_process"],
           "setup_phases_s": [b - a for a, b in zip(marks, marks[1:])],
           "warm_steps": warm_steps, "warm_step_s": step_s, **win}
    if job.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(job.device)
        out["device_name"] = torch.cuda.get_device_name(job.device)
    if spec["trace"]:
        out["trace"] = job.traced(TRACE_STEPS)
        out["trace"]["untraced_step_s"] = win["window_s"] / n
    out["program_report"] = job.program.report()
    job.free()
    t0 = time.perf_counter()
    ref, diffs = job.reference()
    out["reference_s"] = time.perf_counter() - t0
    out["numbers"] = compare.numbers(prog, ref, diffs)
    out["prog"], out["ref"] = prog, ref
    out["modules"] = cells.forbidden_modules()
    return out


def run_cell(spec: Dict) -> List[Dict]:
    """Every rank's result, by rank: in this process on one chip, else in
    one spawned process a card (``launch.mesh.run_ranks``)."""
    world = spec["cell"]["chips"]
    if world == 1:
        return [rank_run(spec)]
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(rank_run, world, backend=spec["dist"],
                     device=spec["device"], timeout_s=spec["timeout_s"],
                     args=(spec,))


def calibrate_rank(spec: Dict) -> Dict:
    """Readings for the limits, on one set-up: for each seed of
    ``spec["seeds"]`` the program's numbers against the reference's, and
    for each seed of ``spec["variant_seeds"]`` those of each reference
    variant of ``spec["variants"]`` (the control) and of each planted
    fault."""
    job = Job(spec)
    rows: List[Dict] = []
    try:
        for seed in spec["seeds"]:
            job.fresh(seed)
            prog = job.checked_steps()
            job.free()
            base = {} if seed in spec["variant_seeds"] else None
            ref, diffs = job.reference(keep=base)
            rows.append({"seed": seed, "variant": "program",
                         "numbers": compare.numbers(prog, ref, diffs)})
            if base is None:
                continue
            for variant in spec["variants"]:
                got, diffs = job.reference(variant, judge=base)
                rows.append({"seed": seed, "variant": variant,
                             "numbers": compare.numbers(got, ref, diffs)})
            for fault in spec["faults"]:
                with faults.planted(fault):
                    job.fresh(seed)
                    got = job.checked_steps()
                job.free()
                diffs = compare.grad_diffs(job.g1, base, job.device)
                rows.append({"seed": seed, "variant": fault,
                             "numbers": compare.numbers(got, ref, diffs)})
    finally:
        job.close()
    return {"rank": job.rank, "rows": rows}


def calibrate(spec: Dict) -> List[Dict]:
    world = spec["cell"]["chips"]
    if world == 1:
        return [calibrate_rank(spec)]
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(calibrate_rank, world, backend=spec["dist"],
                     device=spec["device"], timeout_s=spec["timeout_s"],
                     args=(spec,))
