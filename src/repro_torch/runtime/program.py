"""StepProgram — the runtime that owns the trace→execute→observe→rebuild
lifecycle of one step function (DESIGN.md §7).

Port of ``src/repro/runtime/program.py``.  PyTorch runs eagerly, so the
builder returns a plain callable (no trace, no compile) and the
executable cache keys that callable by plan signature and batch-shape
bucket exactly as the reference keys its jitted steps: the hit, rebuild,
evict, ``plan_rekeys`` and ``shape_buckets`` counters read the same.
CUDA launches are asynchronous, so an issued step is in flight until
:meth:`StepProgram.await_all`; measured mode synchronizes the card where
the reference calls ``block_until_ready``.  A bucketed train step issues
its gradient buckets under ``ctx.issue`` from inside its own backward and
joins them with ``ctx.await_all`` before its optimizer, so the buckets'
sub-recorders (``name/g0``, ...) are in the program's family by the time
:meth:`StepProgram.observe` replays it; :meth:`StepProgram.await_all`
joins whole steps.  :meth:`StepProgram.lower` (the dry-run path) runs a
fresh step once on ``meta`` arguments: no kernel runs, no byte is
allocated and no wire is touched, and the mesh logs the collectives the
step issues (``launch/mesh.py``'s trace log) where the reference reads
them from the lowered HLO.

Usage::

    program = StepProgram(builder, ctx)        # builder: () -> step callable
    out = program(*args)                       # build on demand
    program.observe()                          # Stage-2 feedback
    out = program.step(*args)                  # or: both in one call
    program.issue(*args); program.await_all()  # or: in flight, then joined
    lowered = program.lower(*meta_args)        # the dry-run's record
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import TraceLog
from repro_torch.runtime import spans
from repro_torch.runtime.exec_cache import DEFAULT_CAPACITY, ExecutableCache

_PROGRAM_IDS = itertools.count()


def _block_until_ready() -> None:
    """Wait for the card's queued work (no-op on a CPU-only run)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepHandle:
    """The pending result of one :meth:`StepProgram.issue`: the launches
    are queued on the card when the handle exists; ``ready`` flips once
    the program's next :meth:`StepProgram.await_all` has passed it."""

    __slots__ = ("out", "t0", "ready")

    def __init__(self, out, t0: Optional[float]):
        self.out = out
        self.t0 = t0
        self.ready = False


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (``meta`` ones by their shape and
    dtype; tensors reached twice count once)."""
    seen, n = set(), 0
    for t in pytree.tree_leaves(tree):
        if torch.is_tensor(t) and id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


def meta_like(tree):
    """``tree`` with every tensor and numpy array replaced by a ``meta``
    tensor of its shape and dtype (the arguments :meth:`StepProgram.lower`
    takes); other leaves pass unchanged."""
    def meta(x):
        if isinstance(x, np.ndarray):
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            return torch.empty(x.shape, dtype=dtype, device="meta")
        if torch.is_tensor(x):
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x
    return pytree.tree_map(meta, tree)


@dataclasses.dataclass
class LoweredStep:
    """What :meth:`StepProgram.lower` gives: the collectives the step
    issued on this rank (``log.traced``: outside ``ctx.unrecorded()``,
    the reference's scan body once; ``log.executed``: all), the bytes of
    this rank's arguments and outputs, the plan signature of the slots
    the step touched, and the wall of the lowering."""

    log: TraceLog
    argument_bytes: int
    output_bytes: int
    plan_signature: Tuple
    lower_s: float


class StepProgram:
    """One step function's runtime: executable cache + replay recorder.

    ``ctx`` is any object with the ParallelCtx program API —
    ``register_program`` / ``unregister_program`` / ``recording`` /
    ``observe_program`` / ``plan_signature`` (``models/tp.py``).  A ctx
    with no live communicators has a constant signature, so exactly one
    callable is built per batch-shape bucket.
    """

    def __init__(self, builder: Callable[[], Callable], ctx, *,
                 name: str = "", capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.perf_counter):
        self.name = name or f"program-{next(_PROGRAM_IDS)}"
        self.ctx = ctx
        self._builder = builder
        self.cache = ExecutableCache(capacity)
        self._clock = clock
        self._measured = getattr(ctx, "timing_kind",
                                 lambda: "sim")() == "measured"
        self._last_elapsed_s: Optional[float] = None
        self._pending: list = []        # issued, un-awaited StepHandles
        self._issued = 0
        self._awaits = 0
        self._shape_keys: set = set()
        self._prev_plan_sig: Optional[Tuple] = None
        self._plan_rekeys = 0
        ctx.register_program(self.name)

    # -- lifecycle -------------------------------------------------------------

    def signature(self, *, shape_key=None) -> Tuple:
        """The executable-cache key: this program's plan signature,
        extended by the batch-shape bucket ``shape_key`` when given (each
        bucket keys its own entry, so the cache accounting sees every
        shape change)."""
        sig = self.ctx.plan_signature(self.name)
        if shape_key is None:
            return sig
        self._shape_keys.add(shape_key)
        return (shape_key, sig)

    def _lookup(self, shape_key):
        """(callable, built): the cached callable for the current key, or
        a fresh one from the builder (installed after its first run)."""
        key = self.signature(shape_key=shape_key)
        self._note_plan(key if shape_key is None else key[1])
        fn = self.cache.get(key)
        return (fn, False) if fn is not None else (self._builder(), True)

    def _install(self, fn, shape_key) -> None:
        post = self.signature(shape_key=shape_key)
        self.cache.put(post, fn)
        self._prev_plan_sig = post if shape_key is None else post[1]

    def __call__(self, *args, shape_key=None, **kwargs):
        """Run one step through the plan-keyed executable cache."""
        fn, built = self._lookup(shape_key)
        with self.ctx.recording(self.name):
            out = self._timed(fn, args, kwargs)
        if built:
            self._install(fn, shape_key)
        return out

    def _note_plan(self, plan_sig: Tuple) -> None:
        if (self._prev_plan_sig is not None
                and plan_sig != self._prev_plan_sig):
            self._plan_rekeys += 1
        self._prev_plan_sig = plan_sig

    def _timed(self, fn, args, kwargs):
        """Run the step (in the span ``step``); in measured mode,
        wall-clock it to completion so observe() can feed the duration to
        the timing source."""
        if not self._measured:
            with spans.span("step", self.name):
                return fn(*args, **kwargs)
        t0 = self._clock()
        with spans.span("step", self.name):
            out = fn(*args, **kwargs)
        _block_until_ready()
        self._last_elapsed_s = self._clock() - t0
        return out

    # -- issue/await lifecycle (DESIGN.md §11) ---------------------------------

    def issue(self, *args, shape_key=None, **kwargs) -> StepHandle:
        """Launch one step WITHOUT waiting on it (same cache protocol as
        ``__call__``); the result lands at :meth:`await_all`."""
        t0 = self._clock() if self._measured else None
        fn, built = self._lookup(shape_key)
        with self.ctx.recording(self.name), \
                spans.span("step", self.name, self._issued):
            out = fn(*args, **kwargs)
        if built:
            self._install(fn, shape_key)
        handle = StepHandle(out, t0)
        self._pending.append(handle)
        self._issued += 1
        return handle

    def await_all(self) -> list:
        """Barrier every issued step, close the ctx's issue windows and
        run ONE Stage-2 observation; returns the outputs in issue order."""
        handles, self._pending = self._pending, []
        outs = [h.out for h in handles]
        if handles and self._measured:
            _block_until_ready()
            self._last_elapsed_s = self._clock() - handles[0].t0
        for h in handles:
            h.ready = True
        self.ctx.await_all()
        if handles:
            self._awaits += 1
            self.observe()
        return outs

    def observe(self) -> bool:
        """Stage-2 feedback for one executed step; True when a share
        moved (the next call re-keys)."""
        elapsed, self._last_elapsed_s = self._last_elapsed_s, None
        return self.ctx.observe_program(self.name, elapsed_s=elapsed)

    def step(self, *args, **kwargs):
        """Execute + observe in one call — the common host-loop tick."""
        out = self(*args, **kwargs)
        self.observe()
        return out

    def lower(self, *args, **kwargs) -> LoweredStep:
        """Run a freshly built step once on ``meta`` arguments (the
        dry-run path): the same builder as a live call, under a scratch
        recorder ``name/lower`` that is unregistered afterwards, so the
        replay log a later live call feeds to Stage 2 stays as it was.
        The step's collectives log into a trace scope of the ctx's mesh.
        The result is not cached (it is not a callable)."""
        fn = self._builder()
        mesh = getattr(self.ctx, "mesh", None)
        scratch = self.ctx.register_program(f"{self.name}/lower")
        t0 = time.perf_counter()
        try:
            with contextlib.ExitStack() as stack:
                log = (stack.enter_context(mesh.tracing())
                       if mesh is not None else TraceLog())
                stack.enter_context(self.ctx.recording(scratch))
                out = fn(*args, **kwargs)
            sig = self.ctx.plan_signature(scratch)
        finally:
            self.ctx.unregister_program(scratch)
        return LoweredStep(log=log, argument_bytes=tree_bytes((args, kwargs)),
                           output_bytes=tree_bytes(out), plan_signature=sig,
                           lower_s=time.perf_counter() - t0)

    def close(self) -> None:
        """Retire the program: drop its recorders and cached callables."""
        self.ctx.unregister_program(self.name)
        self.cache.clear()
        self._pending.clear()

    # -- reporting -------------------------------------------------------------

    @property
    def plan_rekeys(self) -> int:
        return self._plan_rekeys

    def report(self) -> Dict[str, Any]:
        """The program's counters; under ``counters``, when a profiled
        step counted any, the span counters (``runtime/spans.py``) read
        and reset."""
        out = {"program": self.name,
               "executable_cache": self.cache.report(),
               "issued": self._issued, "awaits": self._awaits,
               "in_flight": len(self._pending),
               "plan_rekeys": self._plan_rekeys,
               "shape_buckets": sorted(self._shape_keys)}
        counted = spans.counters()
        if counted:
            out["counters"] = counted
        return out



@contextlib.contextmanager
def program_scope(builder: Callable[[], Callable], ctx, **kwargs):
    """``with program_scope(builder, ctx) as prog:`` — a StepProgram that
    unregisters its recorders on exit (for tools and tests that build
    programs against long-lived memoized communicators)."""
    prog = StepProgram(builder, ctx, **kwargs)
    try:
        yield prog
    finally:
        prog.close()
