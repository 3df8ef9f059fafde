"""FlexCommunicator — the paper's *Communicator* (§3.1) + NCCL-shaped API,
on torch process groups.

Port of ``src/repro/core/communicator.py``.  The control plane (Stage-1
slots, Stage-2 balancers, plan cache, replay recorders, warm starts) is the
reference's line for line, so the same call sequence gives the same plans,
``plan_signature()`` and TuningProfile JSON.  The data plane differs in
where it runs: the reference is one SPMD program that names a mesh axis,
the port has one communicator per rank process, holding the rank's
:class:`~repro_torch.launch.mesh.Mesh` (the axis's process groups) where
the reference holds an axis name.  Every rank must then reach the same
plan for the same call, or the ring deadlocks: the ``sim`` timing source
is seeded alike on every rank, and under ``timing="measured"`` each
step's wall time is max-reduced over the ranks the plans span before the
balancer sees it (:meth:`FlexCommunicator.observe_recorders`).  With
``compress`` the timing model chooses per slot which secondary routes
carry a wire codec; the plan names it and the data plane runs the codec
kernels (core/collectives.py, K2-K5).

The communicator is the DATA plane plus its recorders; the CONTROL plane
lives in ``repro.control`` (DESIGN.md §8) and is delegated to:

  * abstract the node's heterogeneous links into a unified path pool
    (``links.NodeProfile``);
  * own one :class:`~repro.control.SlotController` per (collective,
    ring-size, payload-bucket) — Stage-1 tuning (Algorithm 1, the paper's
    "~10 s profiling phase") runs lazily per slot, or is skipped entirely
    when the configured :class:`~repro.control.TuningProfile` warm-starts
    the shares;
  * build a quantized :class:`~repro.core.routing.RoutePlan` per call from
    the current shares and serve every collective through the single
    ``routing.execute`` driver;
  * route per-call timings from the configured
    :class:`~repro.control.TimingSource` (simulated by default, wall-clock
    derived in measured mode) into each slot's Stage-2
    Evaluator/LoadBalancer and adopt its adjustments;
  * stay NCCL-API compatible: ``all_reduce/all_gather/reduce_scatter/
    all_to_all/broadcast`` with the usual signatures, plus a pure-"NCCL"
    mode (single-path) so the baseline is the same code path minus
    aggregation.

Share changes imply new jit variants (shapes change); shares are quantized
onto the plan grain and plans are memoized in an explicit
:class:`~repro.core.routing.PlanCache` keyed by ``(op, bucket, shares)``,
whose hit/miss/re-trace counters ``report()`` surfaces — Stage 2 moves one
unit at a time, so the cache stays tiny (DESIGN.md §2).

Two hooks serve the StepProgram runtime (DESIGN.md §7): per-program
:class:`ReplayRecorder`\\ s keep interleaved step functions' Stage-2 replay
logs disjoint on one memoized communicator, and ``plan_signature()``
freezes the current quantized plans into the executable-cache key that
lets an oscillation back to a known plan reuse its compiled step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.control import (DegradedTimingSource,
                                 MeasuredTimingSource, PROBE_PERIOD,
                                 SimTimingSource, SlotController,
                                 TimingSource, TuningProfile)
from repro_torch.core import collectives as mp
from repro_torch.core import routing
from repro_torch.core.balancer import LoadBalancer
from repro_torch.core.codecs import (canonical_spec, codecs_for_pricing,
                                     get_codec, parse_compress)
from repro_torch.core.links import LinkSpec, NodeProfile, PROFILES
from repro_torch.core.pipeline import StageTimes, optimal_chunk_bytes
from repro_torch.core.routing import PlanCache, RoutePlan
from repro_torch.core.simulator import PathTimingModel
from repro_torch.core.topology import Collective
from repro_torch.core.tuner import SHARE_GRID, TuneResult

#: map link-kind order of a profile onto the three route classes of
#: ``collectives.py``: the primary link, the first secondary (staged/host
#: path) and the remaining secondary (ortho/NIC path).
ROUTE_BY_SLOT = (mp.PATH_PRIMARY, mp.PATH_STAGED, mp.PATH_ORTHO)

#: payload-size buckets (bytes) that get independently tuned shares — the
#: paper's Stage 2 exists because the optimum varies with message size.
SIZE_BUCKETS = tuple(int(2 ** p) for p in range(20, 31))  # 1 MiB .. 1 GiB


def bucket_for(nbytes: int) -> int:
    for b in SIZE_BUCKETS:
        if nbytes <= b:
            return b
    return SIZE_BUCKETS[-1]


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Frozen: ``dataclasses.astuple`` of this config is part of the
    ``comm_init_rank`` memo key, so post-init mutation would silently alias
    (or split) communicators.  Build a new config instead of mutating."""

    backend: str = "flexlink"          # "flexlink" | "nccl"
    #: the port's default fabric is one H100 node (the reference's is
    #: "tpu_v5e"); nvlink/pcie/rdma map to primary/staged/ortho
    profile: str = "h100"
    runtime_balancing: bool = True
    measurement_noise: float = 0.0     # simulator noise for the balancer loop
    seed: int = 0
    #: Stage-2 TimingSource kind: "sim" closes the loop on the analytic
    #: simulator (historical behavior, bit-identical); "measured" on
    #: wall-clock step durations reported by the StepProgram runtime
    #: (control/timing.py — the simulator then only seeds apportionment
    #: weights).
    timing: str = "sim"
    #: secondary-path collective algorithm fed to PathTimingModel: "ring"
    #: (the paper's design) or "tree" (§6 future work, recursive doubling).
    secondary_algo: str = "ring"
    #: TuningProfile JSON path ("" = off): converged Stage-1 shares are
    #: warm-started from it, skipping the profiling phase entirely.
    tuning_cache: str = ""
    #: secondary-path wire-codec spec ("" = off, the byte-identical
    #: default), e.g. ``"secondary=fp8"`` or ``"staged=bf16,ortho=fp8"``
    #: (core/codecs.py, DESIGN.md §12).  The timing model still *chooses*
    #: per slot whether each codec pays; the primary path never compresses.
    compress: str = ""
    #: canonical fault-schedule spec ("" = static fabric, the
    #: byte-identical default) — DESIGN.md §14.  The communicator never
    #: parses it; it lives on the config purely as a memo-key
    #: discriminator, so a faulted run can never share a memoized
    #: communicator with a fault-free run.  (The fault tier's live
    #: transitions come with ROADMAP queue 1 item 13.)
    fault: str = ""
    #: registry-isolation tag: part of the comm_init_rank memo key.  Live
    #: workloads no longer need it — per-program ReplayRecorders keep their
    #: Stage-2 replay logs disjoint on a shared communicator — but tools
    #: that must not share BALANCER state either (dry-run, shape probes)
    #: still set a distinct tag to get their own registry entry.
    tag: str = ""


class ReplayRecorder:
    """Two-phase issued-call log for ONE step program.

    ``record`` collects the (op, nbytes, window) of every ``plan_for``
    during tracing; the first observed step after a trace PROMOTES the
    pending list to the replay log (replacing the previous one).  This
    keeps true per-step multiplicity (a 48-layer step replays 48 calls —
    the paper's "last 10 collective calls" window is per call, not per
    step) while re-traces after a Stage-2 share move replace the log
    instead of double-counting into it.  One recorder per step program:
    interleaved programs on a shared communicator each keep their own
    multiset — and each issue scope of a program (a gradient bucket, a
    decode gather) keeps its own sub-recorder named ``program/tag``, so
    interleaved in-flight buckets stay disjoint too (DESIGN.md §11).

    ``window`` is the issue-window id the call was traced under (``None``
    outside any issue scope): at observe time the communicator resolves it
    to the window's population — the contention factor the call's Stage-2
    timings are priced at.
    """

    __slots__ = ("_pending", "_trace_log", "touched")

    def __init__(self):
        self._pending: list = []
        self._trace_log: list = []
        #: every (op, bucket) slot this program's traces ever resolved —
        #: its plan *footprint*.  The executable-cache signature is
        #: restricted to these slots, so another program tuning or moving
        #: a slot this one never touches cannot spuriously re-key it.
        self.touched: set = set()

    def record(self, op: Collective, nbytes: int,
               window: Optional[int] = None) -> None:
        self._pending.append((op, nbytes, window))

    def touch(self, op: Collective, bucket: int) -> None:
        self.touched.add((op, bucket))

    def issued_calls(self) -> list:
        """The replay multiset for one executed step: the calls traced
        since the last observed step if any (a fresh trace), else the last
        promoted trace."""
        return list(self._pending) if self._pending else list(self._trace_log)

    def promote(self) -> None:
        if self._pending:
            self._trace_log = list(self._pending)
            self._pending.clear()

    def reset(self) -> None:
        self._pending.clear()
        self._trace_log.clear()
        self.touched.clear()


class _ActiveRecorder:
    """Re-entrant-safe scope: route ``plan_for`` records to one recorder.
    Tracks the recorder's NAME alongside it so nested issue scopes can
    derive their sub-recorder names (``parent/tag``)."""

    __slots__ = ("_comm", "_rec", "_name", "_prev", "_prev_name")

    def __init__(self, comm: "FlexCommunicator", rec: ReplayRecorder,
                 name: Optional[str] = None):
        self._comm = comm
        self._rec = rec
        self._name = name
        self._prev: Optional[ReplayRecorder] = None
        self._prev_name: Optional[str] = None

    def __enter__(self):
        self._prev = self._comm._active_recorder
        self._prev_name = self._comm._active_name
        self._comm._active_recorder = self._rec
        self._comm._active_name = self._name
        return self._rec

    def __exit__(self, *exc):
        self._comm._active_recorder = self._prev
        self._comm._active_name = self._prev_name
        return False


class _IssueScope:
    """One in-flight plan's trace scope (DESIGN.md §11).

    Entering routes traced calls to the ``parent/tag`` sub-recorder and
    tags them with the current issue WINDOW — all scopes issued between
    two await barriers share one window, and a call's Stage-2 contention
    factor is its window's population.  Exiting restores the parent
    recorder; the window stays open until :meth:`FlexCommunicator.
    await_barrier` closes it.
    """

    __slots__ = ("_comm", "_tag", "_inner", "_prev_window")

    def __init__(self, comm: "FlexCommunicator", tag: str):
        self._comm = comm
        self._tag = tag
        self._inner: Optional[_ActiveRecorder] = None
        self._prev_window: Optional[int] = None

    def __enter__(self):
        comm = self._comm
        parent = comm._active_name
        name = f"{parent}/{self._tag}" if parent else f"/{self._tag}"
        rec = comm._recorders.setdefault(name, ReplayRecorder())
        wid = comm._ensure_window()
        comm._issue_windows[wid].add(name)
        self._inner = _ActiveRecorder(comm, rec, name)
        self._inner.__enter__()
        self._prev_window = comm._active_window
        comm._active_window = wid
        return rec

    def __exit__(self, *exc):
        self._comm._active_window = self._prev_window
        self._inner.__exit__(*exc)
        return False


class FlexCommunicator:
    """One communicator per (mesh axis, ring size) — like an ncclComm."""

    def __init__(self, axis_name: str, n_ranks: int,
                 config: Optional[CommConfig] = None,
                 ortho_name: Optional[str] = None, mesh=None):
        self.config = config or CommConfig()
        self.axis_name = axis_name
        self.ortho_name = ortho_name
        self.n_ranks = n_ranks
        #: this rank's Mesh (launch/mesh.py): the data plane runs on its
        #: process groups.  None leaves a control-plane-only communicator
        #: (tuning, plans, reports), as the reference's is outside
        #: shard_map.
        self.mesh = mesh
        if mesh is not None and mesh.axis_size(axis_name) != n_ranks:
            raise ValueError(f"axis {axis_name!r} spans "
                             f"{mesh.axis_size(axis_name)} ranks, not "
                             f"{n_ranks}")
        self.profile: NodeProfile = PROFILES[self.config.profile]
        #: the profile name that keys slot lookups and save_tuning; the
        #: reference moves it on live fabric transitions, which come with
        #: the fault tier (ROADMAP queue 1 item 13)
        self._effective_profile: str = self.config.profile
        self.model = PathTimingModel(self.profile,
                                     noise=self.config.measurement_noise,
                                     seed=self.config.seed,
                                     secondary_algo=self.config.secondary_algo)
        #: Stage-2 TimingSource (control/timing.py): where per-call
        #: per-path timings come from.  A degraded profile (some link
        #: member below nominal health — ``--degrade``) wraps the measured
        #: source with the per-instance fault overlay: wall-clock cannot
        #: attribute slowness to ONE rail, so the degraded model emulates
        #: the per-NIC counters hardware would provide.  The sim source
        #: needs no wrapper — the member healths live in its profile.
        self.timing: TimingSource = (
            MeasuredTimingSource(self.model)
            if self.config.timing == "measured"
            else SimTimingSource(self.model))
        if self.config.timing == "measured" and not self.profile.healthy:
            self.timing = DegradedTimingSource(self.timing)
        # validate the compress spec at construction so a bad --compress
        # fails loudly here, not at the first collective
        parse_compress(self.config.compress)
        #: memoized per-slot codec choice (DESIGN.md §12): (op, bucket) ->
        #: {link: codec_name}.  Seeded from a TuningProfile warm start,
        #: else decided once by the timing model's choose_codecs.
        self._codec_choice: Dict[Tuple[Collective, int], Dict[str, str]] = {}
        #: control plane: one SlotController per tuned (op, size-bucket).
        self._slots: Dict[Tuple[Collective, int], SlotController] = {}
        #: Stage-1 warm-start store (control/profile.py); empty when no
        #: cache path is configured.
        self._profile_store = TuningProfile.load(
            self.config.tuning_cache or None)
        #: quantized-plan cache (op, bucket, plan identity) -> RoutePlan
        #: with hit/miss/re-trace stats — the jit-variant cache of
        #: DESIGN.md §2.
        self.plan_cache = PlanCache()
        #: per-program replay recorders (DESIGN.md §7).  Each StepProgram
        #: registers its own ReplayRecorder, so interleaved train / serve /
        #: dry-run programs sharing this memoized communicator keep
        #: disjoint replay multisets.  The default recorder catches direct
        #: (program-less) use of the data plane — the pre-runtime behavior.
        self._recorders: Dict[str, ReplayRecorder] = {}
        self._default_recorder = ReplayRecorder()
        self._active_recorder = self._default_recorder
        self._active_name: Optional[str] = None
        #: issue/await windows (DESIGN.md §11): window id -> the set of
        #: issue-scope names that joined it.  A window's population is the
        #: contention factor every call traced under it is priced at; the
        #: registry is tiny (one window per overlap region per trace) and
        #: promoted logs may still reference old ids, so entries are never
        #: pruned.
        self._issue_windows: Dict[int, set] = {}
        self._window_seq = 0
        self._open_window: Optional[int] = None
        self._active_window: Optional[int] = None
        #: depth of open :meth:`unrecorded` scopes
        self._unrecorded = 0

    # -- replay recorders ------------------------------------------------------

    def register_recorder(self, name: str) -> ReplayRecorder:
        """Create (or return) the replay recorder for one step program.
        Idempotent: communicators are memoized across ctx rebuilds, so a
        re-registered program keeps its log."""
        return self._recorders.setdefault(name, ReplayRecorder())

    def recorder(self, name: str) -> ReplayRecorder:
        return self._recorders[name]

    def unregister_recorder(self, name: str) -> None:
        """Drop a program's recorder AND its issue sub-recorders (the
        ``name/...`` family a bucketed step registers lazily)."""
        doomed = [name] + [n for n in self._recorders
                           if n.startswith(name + "/")]
        for n in doomed:
            rec = self._recorders.pop(n, None)
            if rec is not None and rec is self._active_recorder:
                self._active_recorder = self._default_recorder
                self._active_name = None

    def family_recorders(self, name: Optional[str] = None) -> list:
        """One program's recorder plus its issue sub-recorders, base
        first.  ``None`` names the default (program-less) recorder, whose
        sub-recorders are keyed ``/tag``.  Observation and footprint
        queries go through the family so a bucketed step's per-bucket
        logs all feed Stage 2 (and all sign the executable cache)."""
        if name is None:
            base = self._default_recorder
            prefix = "/"
        else:
            base = self._recorders[name]
            prefix = name + "/"
        subs = [rec for n, rec in sorted(self._recorders.items())
                if n.startswith(prefix) and not n.endswith("/lower")
                and "/lower/" not in n]
        return [base] + subs

    def family_footprint(self, name: Optional[str] = None) -> set:
        """Union of the family's touched (op, bucket) slots."""
        out: set = set()
        for rec in self.family_recorders(name):
            out |= rec.touched
        return out

    def recording(self, rec: ReplayRecorder, name: Optional[str] = None):
        """Context manager routing every ``plan_for`` traced inside it to
        ``rec`` — a StepProgram wraps each executable call in this so its
        traces land in its own recorder.  ``name`` lets nested issue
        scopes derive their ``name/tag`` sub-recorders."""
        return _ActiveRecorder(self, rec, name)

    @contextlib.contextmanager
    def unrecorded(self):
        """Calls inside repeat calls the step already made: ``plan_for``
        neither touches nor records them, and takes the slot's current plan
        without a plan-cache lookup.  The reference records a collective
        once per TRACE (``lax.scan`` traces its layer body once, and the
        backward and the remat recompute trace nothing new); an eager step
        runs every call, so the layer loop's later layers and the
        checkpoint recompute run inside this scope."""
        self._unrecorded += 1
        try:
            yield
        finally:
            self._unrecorded -= 1

    # -- issue/await windows (DESIGN.md §11) -----------------------------------

    def issue_scope(self, tag: str):
        """Trace scope for one in-flight plan: calls traced inside land in
        the active recorder's ``/tag`` sub-recorder and join the open
        issue window.  All scopes issued before the next
        :meth:`await_barrier` share the window — its population is the
        contention factor their Stage-2 timings are priced at."""
        return _IssueScope(self, tag)

    def _ensure_window(self) -> int:
        if self._open_window is None:
            self._window_seq += 1
            self._open_window = self._window_seq
            self._issue_windows[self._open_window] = set()
        return self._open_window

    def await_barrier(self) -> None:
        """Close the open issue window: scopes issued after this start a
        fresh one (and stop contending with the drained transfers)."""
        self._open_window = None

    def window_population(self, window: Optional[int]) -> float:
        """The contention factor for a call traced under ``window``: how
        many plans were in flight with it (>= 1.0)."""
        if window is None:
            return 1.0
        return float(max(len(self._issue_windows.get(window, ())), 1))

    def issued_calls(self):
        """Default-recorder replay multiset (direct, program-less use)."""
        return self._default_recorder.issued_calls()

    def replayed_bytes(self, op: Collective) -> int:
        """Total logged payload bytes for one collective across EVERY
        replay recorder (default + per-program) — the byte accounting
        behind the cluster report's ``a2a`` block (DESIGN.md §15)."""
        total = 0
        for rec in (self._default_recorder, *self._recorders.values()):
            for o, nbytes, _window in rec.issued_calls():
                if o is op:
                    total += int(nbytes)
        return total

    def touched_buckets(self, op: Collective) -> list:
        """Size buckets of the live slots for one collective — the
        footprint fallback when no replay log exists (dryrun runs with
        ``runtime_balancing=False``, so the log never grows there)."""
        return sorted(b for (o, b) in self._slots if o is op)

    def reset_issued(self) -> None:
        """Clear EVERY replay log — the default recorder and all registered
        program recorders.  Explicit-isolation tool only (tests, retiring a
        workload)."""
        self._default_recorder.reset()
        for rec in self._recorders.values():
            rec.reset()

    def observe_executed_step(
            self, recorder: Optional[ReplayRecorder] = None, *,
            elapsed_s: Optional[float] = None) -> bool:
        """Host-side Stage-2 hook: record one executed step's collectives.

        Replays ``recorder`` (default: the program-less default recorder)
        into the slot controllers.  ``elapsed_s`` is the step's measured
        wall-clock duration (block-until-ready timing from the StepProgram
        runtime); a MeasuredTimingSource apportions it over the replay
        multiset before the per-call replay, a SimTimingSource ignores it.
        Returns True when any share moved — the caller's next plan lookup
        registers as a re-trace in the plan cache and flips the
        executable-cache signature (DESIGN.md §2, §7).
        """
        rec = recorder if recorder is not None else self._default_recorder
        return self.observe_recorders([rec], elapsed_s=elapsed_s)

    def observe_recorders(self, recorders, *,
                          elapsed_s: Optional[float] = None) -> bool:
        """Stage-2 feedback for one executed step whose trace spans several
        recorders — a program's base recorder plus its issue sub-recorders
        (one per in-flight bucket, :meth:`family_recorders`).  The merged
        multiset apportions a measured duration exactly as a single log
        would; each call then replays at its issue window's contention
        factor (serial calls at exactly 1.0 — the bitwise parity case)."""
        calls: list = []
        for rec in recorders:
            rec.promote()
            calls.extend(rec.issued_calls())
        if (elapsed_s is not None and calls and self._balancing_active):
            elapsed_s = self._agreed_elapsed(elapsed_s)
            self.timing.ingest_step(
                [(op, self.n_ranks, bucket_for(n), n,
                  self.slot(op, bucket_for(n)).fractions())
                 for op, n, _w in calls], elapsed_s)
        # control_state covers class shares AND member weights: a member
        # drain re-keys the executed plan exactly like a class move does
        before = {k: s.control_state() for k, s in self._slots.items()}
        for op, nbytes, window in calls:
            self.record_call(op, nbytes,
                             contention=self.window_population(window))
        after = {k: s.control_state() for k, s in self._slots.items()}
        return before != after

    def _agreed_elapsed(self, elapsed_s: float) -> float:
        """The step's wall time every rank of the plans' span agrees on: the
        max over the axis group and, with an ortho route, over the ortho
        group too (after the card's queued work has finished).  Each rank
        reads its own clock; without this, measured-mode balancers on
        different ranks could move shares apart and the next staged ring
        would deadlock.  Control-plane-only communicators keep theirs."""
        if self.mesh is None or self.timing.kind != "measured":
            return elapsed_s
        dev = self.mesh.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = torch.tensor([float(elapsed_s)], dtype=torch.float64,
                         device=dev)
        for axis in (self.axis_name, self.ortho_name):
            if axis is not None and self.mesh.axis_size(axis) > 1:
                t = self.mesh.all_reduce(t, axis, op="max")
        return float(t.item())

    # -- control plane (delegated to repro.control) ---------------------------

    @property
    def path_names(self) -> Tuple[str, ...]:
        names = [self.profile.primary.name]
        names += [l.name for l in self.profile.secondary]
        return tuple(names[: len(ROUTE_BY_SLOT)])

    def route_of(self, path_name: str) -> str:
        return ROUTE_BY_SLOT[self.path_names.index(path_name)]

    @property
    def _balancing_active(self) -> bool:
        return (self.config.runtime_balancing
                and self.config.backend != "nccl" and self.n_ranks > 1)

    # transitional read-only views of the slot registry: external tools
    # (benchmarks, tests) reach the live Stage-1/Stage-2 objects through
    # the historical dict attributes.
    @property
    def _tuned(self) -> Dict[Tuple[Collective, int], TuneResult]:
        return {k: s.tuned for k, s in self._slots.items()}

    @property
    def _balancers(self) -> Dict[Tuple[Collective, int], LoadBalancer]:
        return {k: s.balancer for k, s in self._slots.items()}

    def _member_layout(self, sc: SlotController) -> Optional[Dict[str, Tuple]]:
        """The slot's plan-visible instance subdivision keyed by ROUTE
        class, in each link's member-declaration order — what
        ``build_plan`` canonicalizes into the plan's ``member_layout``.
        Plan-visible = the last SETTLED drain state (control/slots.py), so
        an in-flight drain does not re-jit per unit move."""
        weights = sc.plan_member_weights()
        if not weights:
            return None
        out: Dict[str, Tuple] = {}
        for link, w in weights.items():
            if link not in self.path_names:
                continue
            order = self.profile.link(link).member_names
            out[self.route_of(link)] = tuple((m, w.get(m, 0)) for m in order)
        return out or None

    def _plan_units(self, op: Collective,
                    shares: Mapping[str, int]) -> Tuple:
        """Quantized-plan identity of grid-unit ``shares`` (keyed by LINK
        name): mirrors ``build_plan``'s share→chunk_units mapping, so the
        slot's probe snapping (control/slots.py) compares exactly what the
        data plane would execute.  (The bucket-dependent staged pipeline
        depth is not part of this identity — a probe that changes only the
        depth still re-keys the plan, it just probes one grain further.
        The member layout is constant across candidate class-share moves,
        so the snapping search keys on chunk_units exactly as before.)"""
        routed = {self.route_of(p): u for p, u in shares.items()}
        plan = routing.build_plan(op, self.axis_name, routed, self.ortho_name)
        return plan.chunk_units

    def slot_controllers(self) -> Tuple[SlotController, ...]:
        """Every tuned slot's controller — the public surface for
        cross-communicator reporting (e.g. the cluster rollup)."""
        return tuple(self._slots.values())

    # -- wire codecs (DESIGN.md §12) -------------------------------------------

    def _algo_key(self) -> str:
        """The TuningProfile algo-key component: the secondary algorithm,
        with the canonical compress spec folded in when compression is on.
        Compressed tunings live under their own warm-start keys (shares
        tuned against codec pricing are not valid for raw wire), and the
        default keys stay exactly historical."""
        spec = canonical_spec(self.config.compress)
        base = self.config.secondary_algo
        return f"{base}+{spec}" if spec else base

    def slot_codecs(self, op: Collective, bucket: int) -> Dict[str, str]:
        """Chosen wire codec per LINK for one slot ({} = all raw).  The
        timing model decides whether each configured codec PAYS at this
        bucket (``choose_codecs``): tiny messages never compress, and the
        primary path is structurally excluded.  Memoized — the choice is
        part of the slot's tuned identity (and warm starts pre-seed it
        from the TuningProfile via :meth:`slot`)."""
        key = (op, bucket)
        got = self._codec_choice.get(key)
        if got is not None:
            return got
        chosen: Dict[str, str] = {}
        if (self.config.compress and self.config.backend != "nccl"
                and self.n_ranks > 1):
            route_of = {p: self.route_of(p) for p in self.path_names}
            cands = codecs_for_pricing(self.config.compress, route_of,
                                       self.profile.primary.name)
            chosen = self.model.choose_codecs(op, self.n_ranks, bucket,
                                              cands)
        self._codec_choice[key] = chosen
        return chosen

    def slot(self, op: Collective, bucket: int) -> SlotController:
        """The SlotController for one (op, size-bucket); created on first
        use — warm from the TuningProfile when it has a matching entry,
        else by running Algorithm 1 cold.  Each slot carries its fabric
        tier (the profile's — "inter" on a cluster's NIC-tier
        communicator) and the plan quantizer that snaps measured-mode
        probes to the RoutePlan grain."""
        key = (op, bucket)
        sc = self._slots.get(key)
        if sc is not None:
            return sc
        primary = self.profile.primary.name
        probe = PROBE_PERIOD if self.timing.kind == "measured" else None
        quantizer = lambda shares, _op=op: self._plan_units(_op, shares)  # noqa: E731
        members = {l: m for l, m in self.profile.multi_member_links().items()
                   if l in self.path_names}
        if self.config.backend == "nccl" or self.n_ranks <= 1:
            sc = SlotController.tune_cold(
                op, bucket, [primary], primary,
                self.timing.stage1_measure(op, self.n_ranks, bucket),
                tier=self.profile.tier)
        else:
            algo_key = self._algo_key()
            saved = self._profile_store.lookup(
                self._effective_profile, algo_key, op,
                self.n_ranks, bucket, SHARE_GRID)
            if saved is not None and set(saved) <= set(self.path_names):
                saved_members = self._profile_store.lookup_members(
                    self._effective_profile, algo_key, op,
                    self.n_ranks, bucket, SHARE_GRID)
                saved_codecs = self._profile_store.lookup_codecs(
                    self._effective_profile, algo_key, op,
                    self.n_ranks, bucket, SHARE_GRID)
                if saved_codecs is not None:
                    # the warm-started plan must execute the codec choice
                    # the cold run tuned against, not re-decide it
                    self._codec_choice[key] = dict(saved_codecs)
                sc = SlotController.warm_start(op, bucket, saved, primary,
                                               probe_period=probe,
                                               tier=self.profile.tier,
                                               plan_quantizer=quantizer,
                                               members=members,
                                               member_weights=saved_members,
                                               codecs=self.slot_codecs(
                                                   op, bucket))
            else:
                chosen = self.slot_codecs(op, bucket)
                # fixpoint: the initial choice prices each codec on the
                # FULL payload, but the tuner may route only a sliver down
                # a compressed path, where the setup term flips the sign —
                # re-choose at the converged fractions and re-tune.  The
                # set only ever shrinks, so this terminates.
                while True:
                    codec_objs = ({l: get_codec(c)
                                   for l, c in chosen.items()} or None)
                    sc = SlotController.tune_cold(
                        op, bucket, list(self.path_names), primary,
                        self.timing.stage1_measure(op, self.n_ranks, bucket,
                                                   codecs=codec_objs),
                        probe_period=probe, tier=self.profile.tier,
                        plan_quantizer=quantizer, members=members,
                        codecs=chosen)
                    if not chosen:
                        break
                    refined = self.model.choose_codecs(
                        op, self.n_ranks, bucket,
                        {l: get_codec(c) for l, c in chosen.items()},
                        fracs=sc.tuned.fractions())
                    if refined == chosen:
                        break
                    chosen = refined
                    self._codec_choice[key] = chosen
        self._slots[key] = sc
        return sc

    def tune(self, op: Collective, payload_bytes: int) -> TuneResult:
        """Stage 1 (Algorithm 1) for one (op, size-bucket); memoized."""
        return self.slot(op, bucket_for(payload_bytes)).tuned

    def shares_for(self, op: Collective, payload_bytes: int) -> Dict[str, int]:
        """Current grid-unit shares keyed by *route class*."""
        sc = self.slot(op, bucket_for(payload_bytes))
        return {self.route_of(p): s for p, s in sc.shares.items() if s > 0}

    def record_call(self, op: Collective, payload_bytes: int,
                    contention: float = 1.0) -> None:
        """Stage 2: report one call's timings to its slot controller.  The
        timings come from the configured TimingSource — the simulator
        (default) or wall-clock-derived estimates (measured mode).
        ``contention`` is the in-flight plan demand the call ran under
        (its issue window's population; 1.0 for serial calls)."""
        if not self._balancing_active:
            return
        sc = self.slot(op, bucket_for(payload_bytes))
        timings = self.timing.timings_for(
            op, self.n_ranks, payload_bytes, sc.fractions(),
            bucket=sc.bucket, member_weights=sc.member_weights() or None,
            contention=contention, codecs=sc.codec_objects())
        sc.report(timings)

    def save_tuning(self, path: Optional[str] = None) -> int:
        """Record every tuned slot's Stage-1 shares into the profile store
        and write it to ``path`` (default: ``config.tuning_cache``).
        Single-path modes (nccl backend, degenerate rings) are never
        recorded — their "tuning" is trivial and would collide with the
        real entries.  Returns the number of entries recorded."""
        n = 0
        if self.config.backend == "nccl" or self.n_ranks <= 1:
            return n
        for (op, bucket), sc in self._slots.items():
            self._profile_store.record(
                self._effective_profile, self._algo_key(), op,
                self.n_ranks, bucket, SHARE_GRID, sc.tuned.shares,
                iterations=sc.tuned.iterations,
                converged=sc.tuned.converged,
                members=sc.member_weights() or None,
                # with compression configured, an EMPTY choice is a tuned
                # verdict (refinement dropped every codec) and must be
                # recorded as {} so the warm start restores it instead of
                # re-running the full-payload choose_codecs; without
                # --compress the field is omitted entirely (byte-compatible
                # cache files)
                codecs=(dict(sc.codecs) if self.config.compress else None))
            n += 1
        target = path or self.config.tuning_cache
        if target and n:
            self._profile_store.save(target)
        return n

    def tuning_status(self) -> Dict[str, Dict[str, object]]:
        """Warm/cold provenance per tuned slot (dry-run reporting)."""
        return {f"{op.value}@{bucket}": sc.status()
                for (op, bucket), sc in sorted(
                    self._slots.items(),
                    key=lambda kv: (kv[0][0].value, kv[0][1]))}

    # -- plan construction ----------------------------------------------------

    @property
    def _staged_link(self) -> Optional[LinkSpec]:
        sec = self.profile.secondary
        return sec[0] if sec else None

    def staged_substeps_for(self, op: Collective, bucket: int,
                            shares: Mapping[str, int]) -> int:
        """Chunk-pipeline depth for the staged ring of one size bucket.

        Uses the §3.1 double-buffered pipeline model: pick the chunk size
        minimizing staged-segment completion time, then split the segment
        into that many sub-chunks (clamped to the double-buffer minimum and
        the HLO-size cap).  Pure host-side arithmetic, derived from the
        BUCKET size (not the exact call size) so the plan is a pure
        function of the cache key (op, bucket, shares).
        """
        link = self._staged_link
        frac = shares.get(mp.PATH_STAGED, 0) / SHARE_GRID
        seg_bytes = float(bucket) * frac
        if link is None or seg_bytes <= 0:
            return 1
        st = StageTimes(pd2h_GBps=link.effective_GBps,
                        h2cd_GBps=link.effective_GBps,
                        per_chunk_us=link.step_latency_us)
        chunk = optimal_chunk_bytes(seg_bytes, st)
        n_chunks = int(math.ceil(seg_bytes / chunk))
        return max(routing.DEFAULT_STAGED_SUBSTEPS,
                   min(n_chunks, routing.MAX_STAGED_SUBSTEPS))

    def _bucket_plan(self, op: Collective, bucket: int) -> RoutePlan:
        """Current quantized plan for one (op, bucket) slot, resolved
        through the PlanCache (so a Stage-2 share move registers as a
        re-trace on the slot).  Pure host arithmetic — no replay-log
        side effects."""
        if self.config.backend == "nccl" or self.n_ranks <= 1:
            return self.plan_cache.lookup(
                op, bucket,
                lambda: routing.build_plan(op, self.axis_name, None,
                                           self.ortho_name))

        def build() -> RoutePlan:
            sc = self.slot(op, bucket)
            shares = {self.route_of(p): s
                      for p, s in sc.shares.items() if s > 0}
            # route-class keyed codec choice: canonicalization inside
            # build_plan drops entries for inactive classes, so the
            # no-codec plan stays bit-identical (DESIGN.md §12)
            path_codecs = ({self.route_of(l): c
                            for l, c in sc.codecs.items()
                            if l in self.path_names} or None)
            return routing.build_plan(
                op, self.axis_name, shares, self.ortho_name,
                staged_substeps=self.staged_substeps_for(op, bucket, shares),
                member_layout=self._member_layout(sc),
                path_codecs=path_codecs)

        return self.plan_cache.lookup(op, bucket, build)

    def plan_for(self, op: Collective, x: torch.Tensor) -> RoutePlan:
        """Memoized RoutePlan for one call (Stage-2 observation happens
        after the step via ``observe_executed_step``)."""
        nbytes = x.numel() * x.element_size()
        bucket = bucket_for(nbytes)
        if self._unrecorded:
            plan = self.plan_cache.current(op, bucket)
            return plan if plan is not None else self._bucket_plan(op, bucket)
        # footprint tracking is unconditional (even nccl / balancing-off):
        # the executable-cache signature needs to know which slots this
        # program's step closes over
        self._active_recorder.touch(op, bucket)
        if (self.config.backend != "nccl" and self.n_ranks > 1
                and self.config.runtime_balancing):
            # the replay log only feeds Stage 2 — don't grow it on
            # communicators whose host loop never drains it (baseline /
            # degenerate / balancing-off modes)
            self._active_recorder.record(op, nbytes, self._active_window)
        return self._bucket_plan(op, bucket)

    def plan_signature(self, touched: Optional[set] = None) -> Tuple:
        """Frozen identity of the tuned slots' CURRENT quantized plans —
        the executable-cache key half owned by this communicator.

        ``touched`` (a set of (op, bucket), normally a program recorder's
        footprint) restricts the signature to the slots one program's step
        actually closes over, so a sibling program tuning or oscillating
        a slot this one never uses cannot spuriously re-key it; ``None``
        signs over every tuned slot.

        Each slot is refreshed through the PlanCache first, so a Stage-2
        move that changed the quantized split is recorded as hit/retrace
        on the slot BEFORE the snapshot (``PlanCache.plan_signature``) is
        taken — an executable-cache hit on a previously-seen signature
        therefore still shows up in plan-cache stats as the paper's
        "return to a known plan" event.
        """
        slots = sorted(self._slots, key=lambda k: (k[0].value, k[1]))
        if touched is not None:
            slots = [k for k in slots if k in touched]
        for op, bucket in slots:
            self._bucket_plan(op, bucket)
        want = {(op.value, bucket) for op, bucket in slots}
        return tuple(r for r in self.plan_cache.plan_signature()
                     if (r[0], r[1]) in want)

    # -- data plane (NCCL-shaped; every rank of the axis calls it) ------------
    #
    # all_reduce, all_gather and reduce_scatter are differentiable
    # (routing.execute): the backward runs the transpose collective over
    # the same plan, codecs stripped, unrecorded.

    def _data_mesh(self):
        if self.mesh is None:
            raise RuntimeError(f"communicator on {self.axis_name!r} has no "
                               f"mesh: build it with mesh= for the data "
                               f"plane")
        return self.mesh

    def all_reduce(self, x: torch.Tensor, accumulate=None) -> torch.Tensor:
        mesh = self._data_mesh()
        plan = self.plan_for(Collective.ALL_REDUCE, x)
        return routing.execute(plan, x, mesh, accumulate=accumulate)

    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        mesh = self._data_mesh()
        plan = self.plan_for(Collective.ALL_GATHER, x)
        g = routing.execute(plan, x, mesh)
        return routing.tile_gathered(g, x) if tiled else g

    def reduce_scatter(self, x: torch.Tensor,
                       accumulate=None) -> torch.Tensor:
        mesh = self._data_mesh()
        plan = self.plan_for(Collective.REDUCE_SCATTER, x)
        return routing.execute(plan, x, mesh, accumulate=accumulate)

    def all_to_all(self, x: torch.Tensor, split_axis: int = 0,
                   concat_axis: int = 0) -> torch.Tensor:
        mesh = self._data_mesh()
        plan = self.plan_for(Collective.ALL_TO_ALL, x)
        return routing.execute_all_to_all(plan, x, mesh, split_axis,
                                          concat_axis)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        # single-path: broadcast payloads are small; the tuner would
        # deactivate secondaries anyway (latency-bound).
        return self._data_mesh().broadcast(x, self.axis_name, root)

    # -- reporting -------------------------------------------------------------

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        rollup = SlotController.rollup(self._slots.values())
        for (op, bucket), sc in self._slots.items():
            desc = sc.describe(self.model, self.n_ranks)
            out[f"{op.value}@{bucket}"] = desc
            # "offloaded bytes saved": what the wire codecs took off the
            # secondary paths, rolled up per fabric tier (DESIGN.md §12)
            row = rollup.get(sc.tier)
            if row is not None:
                row["offloaded_bytes_saved"] = (
                    row.get("offloaded_bytes_saved", 0)
                    + desc["wire"]["bytes_saved"])
        out["tier"] = self.profile.tier
        out["rollup"] = rollup
        out["timing_source"] = self.timing.kind
        out["plan_cache"] = self.plan_cache.report()
        if self._recorders:
            out["programs"] = {
                name: {"replay_len": len(rec.issued_calls())}
                for name, rec in sorted(self._recorders.items())}
        return out


# ---------------------------------------------------------------------------
# NCCL-compatible module-level API (paper: "drop-in replacement compatible
# with the NCCL API").  Mirrors ncclAllReduce & friends for code written
# against a communicator handle.
# ---------------------------------------------------------------------------

_COMMS: Dict[Tuple, FlexCommunicator] = {}


def comm_init_rank(axis_name: str, n_ranks: int,
                   config: Optional[CommConfig] = None,
                   ortho_name: Optional[str] = None,
                   mesh=None) -> FlexCommunicator:
    """ncclCommInitRank analogue, memoized per (axis, size, config, ortho,
    mesh).

    Construction runs Stage-1 tuning lazily but holds the balancer state —
    sharing one communicator per key is what makes Stage-2 adjustments
    visible to every step function on that axis (and avoids re-tuning when
    ``ParallelCtx`` is rebuilt, e.g. per launcher or test).
    """
    cfg = config or CommConfig()
    key = (axis_name, n_ranks, ortho_name, dataclasses.astuple(cfg), mesh)
    if key not in _COMMS:
        _COMMS[key] = FlexCommunicator(axis_name, n_ranks, cfg, ortho_name,
                                       mesh)
    return _COMMS[key]


def comm_destroy_all() -> None:
    _COMMS.clear()
