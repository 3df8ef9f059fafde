"""Batched serving engines over the decode step.

Port of ``src/repro/serving/engine.py``: the wave engine
(:class:`ServeEngine`) and the continuous-batching paged engine
(:class:`PagedServeEngine`), with the reference's scheduling, sampling and
reports.  Both run on the device their parameters live on; the host side
(scheduler, block tables, sampling) stays numpy.  Temperature sampling
keeps the reference's ``np.random.default_rng(seed)``; logits cross to
the host as float32.

Wave engine: requests are admitted in waves that fill the free slots; each
wave's prompts are prefilled together through the decode path
(teacher-forced, one fused call per prompt position), then the engine
emits one fused decode step per tick for every active slot.  Admitted
slots get their cache rows zeroed (batch axis 1, in place).  Unequal
prompts are right-aligned: shorter prompts see hold tokens first, which
attention masks out via kv_valid / position overwrites.

Every step runs through the engine's
:class:`~repro_torch.runtime.program.StepProgram` issue/await lifecycle,
so the executable-cache and issue/await reports read as the reference's.

Both engines are one-device, as the reference's: they hold a local
cache (``seq_shard=None``) and sample full-vocab logits, so they refuse a
ctx with a model axis.  Serving across devices is the serve program
(``launch/steps.build_serve_program``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx
from repro_torch.models.transformer import (DecodeConfig, PagedConfig,
                                            decode_step, init_cache,
                                            init_paged_pool,
                                            paged_decode_step)
from repro_torch.runtime.program import StepProgram
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.scheduler import ContinuousScheduler, PagedRequest


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    _last: int = 0


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4               # max concurrent requests
    cache_len: int = 128
    eos_id: int = -1             # -1: never stops early


def _one_device(ctx: ParallelCtx) -> None:
    if ctx.tp_size > 1:
        raise ValueError(
            f"the serving engines are one-device (a local cache, full-vocab "
            f"logits sampled on the host) and take no model axis (tp = "
            f"{ctx.tp_size}); serve across devices with "
            f"launch/steps.build_serve_program")


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    """Logits to the host as float32 (exact for bf16 and f32 values)."""
    return logits.float().cpu().numpy()


class ServeEngine:
    def __init__(self, params, cfg: ArchConfig, ctx: ParallelCtx,
                 scfg: ServeConfig, seed: int = 0):
        _one_device(ctx)
        self.p = params
        self.cfg = cfg
        self.ctx = ctx
        self.scfg = scfg
        self.device = params["embed"].device
        self.dcfg = DecodeConfig(cache_len_local=scfg.cache_len,
                                 seq_shard=None)
        self.cache = init_cache(cfg, ctx, self.dcfg, scfg.slots,
                                device=self.device)
        self.pos = np.zeros(scfg.slots, np.int32)
        self.active: List[Optional[Request]] = [None] * scfg.slots
        self.queue: List[Request] = []
        self.rng = np.random.default_rng(seed)
        self._next_rid = 0
        self._finished: Dict[int, List[int]] = {}
        self._program = StepProgram(self._decode_builder, ctx)
        self._ticks = 0

    def _decode_builder(self):
        """The step callable the StepProgram caches (one per plan)."""
        return lambda p, c, t, pos: decode_step(p, c, t, pos, self.cfg,
                                                self.ctx, self.dcfg)

    def comm_report(self) -> Dict[str, object]:
        """Per-axis FlexLink tuning + plan-cache stats for this engine
        (each axis block includes the active TimingSource kind and the
        per-slot Stage-2 trajectory), plus its StepProgram's
        executable-cache stats and a serving block (DESIGN.md §13)."""
        rep = dict(self.ctx.comm_report())
        rep["executable_cache"] = self._program.cache.report()
        rep["program"] = self._program.report()
        rep["serving"] = {
            "engine": "wave",
            "ticks": self._ticks,
            "slots": self.scfg.slots,
            "active": sum(1 for r in self.active if r is not None),
            "queued": len(self.queue),
            "finished": len(self._finished),
        }
        return rep

    # -- client API -----------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16,
               temperature: float = 0.0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new, temperature))
        return rid

    def finished(self) -> Dict[int, List[int]]:
        return dict(self._finished)

    # -- internals --------------------------------------------------------------
    def _fused_step(self, tokens: np.ndarray) -> np.ndarray:
        # StepProgram tick via the issue/await lifecycle (DESIGN.md §11):
        # the fused step's launches are queued on the device, and
        # await_all barriers it and runs the Stage-2 observation
        self._program.issue(
            self.p, self.cache,
            torch.tensor(tokens[:, None], device=self.device),
            torch.tensor(self.pos, device=self.device))
        logits, self.cache = self._program.await_all()[-1]
        return _host_logits(logits)

    def _admit_wave(self) -> None:
        """Fill free slots; prefill the admitted prompts together."""
        free = [s for s in range(self.scfg.slots) if self.active[s] is None]
        wave = []
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            self.active[slot] = req
            self.pos[slot] = 0
            wave.append((slot, req))
        if not wave:
            return
        # zero the admitted slots' cache rows (batch axis 1), in place
        slot_ids = torch.tensor([s for s, _ in wave], device=self.device)
        for leaf in self.cache.values():
            leaf[:, slot_ids] = 0
        max_len = max(len(r.prompt) for _, r in wave)
        # teacher-forced prefill: one fused call per prompt position; slots
        # whose prompt is exhausted (or inactive) repeat a hold token at a
        # frozen position; their state advance is rolled back by kv_valid
        # masking (attention) or by never sampling from them (ssm rollback
        # is avoided by right-aligning: shorter prompts start later).
        starts = {s: max_len - len(r.prompt) for s, r in wave}
        for t in range(max_len - 1):            # last token enters at tick
            toks = np.zeros(self.scfg.slots, np.int32)
            for s, r in wave:
                if t >= starts[s]:
                    toks[s] = r.prompt[t - starts[s]]
            self._fused_step(toks)
            for s, r in wave:
                if t >= starts[s]:
                    self.pos[s] += 1
        for s, r in wave:
            r._last = r.prompt[-1]

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0:
            return int(logits.argmax())
        z = logits / req.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self.rng.choice(len(p), p=p))

    def tick(self) -> int:
        """Admit + one fused decode step for all active slots."""
        if self.ctx.fault_clock is not None:
            # serving's fabric time is the tick counter: flapping rails
            # ride the same hysteresis rule as training steps
            self.ctx.fault_clock.advance(self._ticks)
        self._ticks += 1
        if any(s is None for s in self.active) and self.queue:
            self._admit_wave()
        act = [s for s in range(self.scfg.slots) if self.active[s]]
        if not act:
            return 0
        toks = np.zeros(self.scfg.slots, np.int32)
        for s in act:
            toks[s] = self.active[s]._last
        logits = self._fused_step(toks)
        for s in act:
            self.pos[s] += 1
            req = self.active[s]
            nxt = self._sample(logits[s], req)
            req.out.append(nxt)
            req._last = nxt
            if len(req.out) >= req.max_new or nxt == self.scfg.eos_id:
                self._finished[req.rid] = req.out
                self.active[s] = None
        return len(act)

    def run_until_drained(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not any(self.active):
                break
            self.tick()

    def save_tuning(self, path: Optional[str] = None) -> int:
        """Persist the engine's converged Stage-1 shares to the warm-start
        TuningProfile (control/profile.py)."""
        return self.ctx.save_tuning_profile(path)

    def close(self) -> None:
        """Retire the engine's StepProgram: drop its replay recorders from
        the (memoized, process-global) communicators and its compiled
        executables.  Call when discarding an engine in a process that
        keeps serving through other engines on the same axes."""
        self._program.close()


# ---------------------------------------------------------------------------
# continuous batching over a paged KV cache (DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedServeConfig:
    """Shape/policy knobs of the continuous-batching engine.

    max_requests        : concurrent admitted requests (block-table rows,
                          logits rows) — R
    cache_len           : per-request token cap (prompt + max_new); rounds
                          up to whole blocks for the gather span
    kv_block            : tokens per physical KV block
    n_blocks            : pool blocks per layer; 0 -> auto-size so every
                          request row can hold a full cache_len (no
                          preemption pressure)
    max_tokens_in_flight: packed-row budget per tick — the top batch-shape
                          bucket
    min_bucket          : smallest bucket of the power-of-two ladder
    attn_impl           : "reference" | "kernel" (PagedConfig.attn_impl)
    """
    max_requests: int = 8
    cache_len: int = 128
    kv_block: int = 16
    n_blocks: int = 0
    max_tokens_in_flight: int = 32
    min_bucket: int = 8
    eos_id: int = -1
    attn_impl: str = "reference"


class PagedServeEngine:
    """In-flight (continuous) batching: requests are admitted into free
    token budget every tick — not in waves — with K/V in fixed-size pool
    blocks mapped by per-request block tables (serving/paged_kv.py) and
    tick planning by serving/scheduler.py.

    Every tick packs context-phase (prefill-chunk) and generation-phase
    (decode) rows into ONE fused :func:`paged_decode_step`, padded up to a
    power-of-two bucket so admission-driven shape changes re-key onto the
    StepProgram's executable cache (``shape_key``).
    The packed layout replaces the wave engine's right-aligned prompt
    padding: bucket-padding rows cost zero attention FLOP-mass and zero
    KV blocks, and prefill never burns a full wave-width step per prompt
    position.

    Greedy token streams are bit-identical to :class:`ServeEngine` for
    the same admitted set (the correctness contract): the dense
    block-gather reference path feeds chunked_attention the exact operands
    the wave path does, and preemption/resume re-prefills ``prompt + out``
    teacher-forced, reproducing the evicted K/V exactly.  Requires
    ``ceil(gather_span/512) == ceil(cache_len/512)`` so both paths chunk
    identically — true whenever cache_len is a multiple of kv_block, and
    of everything <= 512 otherwise rounded within the same chunk.
    """

    def __init__(self, params, cfg: ArchConfig, ctx: ParallelCtx,
                 scfg: PagedServeConfig, seed: int = 0):
        _one_device(ctx)
        self.p = params
        self.cfg = cfg
        self.ctx = ctx
        self.scfg = scfg
        maxb = -(-scfg.cache_len // scfg.kv_block)
        n_blocks = scfg.n_blocks or maxb * scfg.max_requests
        self.pcfg = PagedConfig(block_size=scfg.kv_block,
                                n_blocks=n_blocks,
                                max_blocks_per_req=maxb,
                                attn_impl=scfg.attn_impl)
        self.device = params["embed"].device
        self.pool = init_paged_pool(cfg, ctx, self.pcfg, device=self.device)
        self.kv = PagedKVCache(n_blocks, scfg.kv_block, maxb,
                               scfg.max_requests)
        self.sched = ContinuousScheduler(
            self.kv, max_requests=scfg.max_requests,
            max_tokens_in_flight=scfg.max_tokens_in_flight,
            eos_id=scfg.eos_id)
        # power-of-two bucket ladder, topped by the exact budget
        self.buckets: List[int] = []
        b = max(1, scfg.min_bucket)
        while b < scfg.max_tokens_in_flight:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(scfg.max_tokens_in_flight)
        self.rng = np.random.default_rng(seed)
        self._next_rid = 0
        self._finished: Dict[int, List[int]] = {}
        # one exec-cache entry per (bucket, plan) pair
        self._program = StepProgram(self._step_builder, ctx,
                                    capacity=4 * len(self.buckets))
        self._ticks = 0
        self._steps = 0
        self._real_rows = 0
        self._padded_rows = 0
        self._peak_rows = 0
        self._last_rows = 0
        self._bucket_steps: Dict[int, int] = {}
        # host wall time of each packed step, issue to logits on the host
        # (the logits copy waits for the device, so no extra sync)
        self._step_s: List[float] = []

    def _step_builder(self):
        """The step callable the StepProgram caches, one per shape_key
        bucket (the reference's per-bucket executables)."""
        return (lambda p, pool, toks, pos, rows, tables, sample:
                paged_decode_step(p, pool, toks, pos, rows, tables, sample,
                                  self.cfg, self.ctx, self.pcfg))

    def _bucket(self, n_rows: int) -> int:
        for b in self.buckets:
            if n_rows <= b:
                return b
        return self.buckets[-1]

    # -- client API -----------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int = 16,
               temperature: float = 0.0) -> int:
        if len(prompt) + max_new > self.scfg.cache_len:
            raise ValueError(
                f"prompt+max_new = {len(prompt) + max_new} exceeds "
                f"cache_len {self.scfg.cache_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(PagedRequest(rid, list(prompt), max_new,
                                       temperature))
        return rid

    def finished(self) -> Dict[int, List[int]]:
        return dict(self._finished)

    # -- internals ------------------------------------------------------------

    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        if temperature <= 0:
            return int(logits.argmax())
        z = logits / temperature
        z = z - z.max()
        prob = np.exp(z) / np.exp(z).sum()
        return int(self.rng.choice(len(prob), p=prob))

    def tick(self) -> int:
        """Plan (admit / pack / maybe preempt), run ONE fused packed step,
        sample sequence-frontier rows, retire finished requests.  Returns
        the number of real (non-padding) rows processed."""
        if self.ctx.fault_clock is not None:
            self.ctx.fault_clock.advance(self._ticks)
        self._ticks += 1
        plan = self.sched.plan_tick()
        if not plan.rows:
            return 0
        t_b = self._bucket(plan.n_rows)
        tokens = np.zeros(t_b, np.int32)
        positions = np.zeros(t_b, np.int32)
        row_req = np.full(t_b, -1, np.int32)
        for i, (row, pos, tok) in enumerate(plan.rows):
            tokens[i] = tok
            positions[i] = pos
            row_req[i] = row
        sample_rows = np.zeros(self.scfg.max_requests, np.int32)
        for row, idx in plan.sample_rows.items():
            sample_rows[row] = idx
        # issue/await lifecycle (DESIGN.md §11): the packed step's decode
        # collectives are in flight while the host finishes the tick
        dev = self.device
        t0 = time.perf_counter()
        self._program.issue(
            self.p, self.pool, torch.tensor(tokens, device=dev),
            torch.tensor(positions, device=dev),
            torch.tensor(row_req, device=dev),
            torch.tensor(self.kv.tables, device=dev),
            torch.tensor(sample_rows, device=dev), shape_key=t_b)
        logits, self.pool = self._program.await_all()[-1]
        logits = _host_logits(logits)
        self._step_s.append(time.perf_counter() - t0)
        sampled = {}
        for row in plan.sample_rows:
            req = self.sched.active[row]
            sampled[row] = self._sample(logits[row], req.temperature)
        for req in self.sched.commit(plan, sampled):
            self._finished[req.rid] = req.out
        self._steps += 1
        self._real_rows += plan.n_rows
        self._padded_rows += t_b - plan.n_rows
        self._peak_rows = max(self._peak_rows, plan.n_rows)
        self._last_rows = plan.n_rows
        self._bucket_steps[t_b] = self._bucket_steps.get(t_b, 0) + 1
        return plan.n_rows

    def run_until_drained(self, max_ticks: int = 10000) -> None:
        for _ in range(max_ticks):
            if not self.sched.has_work():
                break
            self.tick()

    # -- reporting / lifecycle ------------------------------------------------

    def serving_report(self) -> Dict[str, object]:
        ec = self._program.cache.report()
        lookups = ec["hits"] + ec["rebuilds"]
        return {
            "engine": "paged",
            "ticks": self._ticks,
            "steps": self._steps,
            "tokens_in_flight": {
                "budget": self.scfg.max_tokens_in_flight,
                "peak": self._peak_rows,
                "last": self._last_rows,
            },
            "rows": {"real": self._real_rows, "padded": self._padded_rows},
            "buckets": {str(b): n
                        for b, n in sorted(self._bucket_steps.items())},
            "batch_bucket_cache": {
                "hits": ec["hits"], "rebuilds": ec["rebuilds"],
                "hit_rate": round(ec["hits"] / lookups, 4)
                if lookups else 0.0,
            },
            "scheduler": self.sched.report(),
            "kv_blocks": self.kv.report(),
            "step_ms": {
                "median": float(np.median(self._step_s)) * 1e3
                if self._step_s else 0.0,
                "max": max(self._step_s, default=0.0) * 1e3,
            },
        }

    def comm_report(self) -> Dict[str, object]:
        rep = dict(self.ctx.comm_report())
        rep["executable_cache"] = self._program.cache.report()
        rep["program"] = self._program.report()
        rep["serving"] = self.serving_report()
        return rep

    def save_tuning(self, path: Optional[str] = None) -> int:
        return self.ctx.save_tuning_profile(path)

    def close(self) -> None:
        self._program.close()
