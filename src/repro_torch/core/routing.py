"""RoutePlan engine — FlexLink's plan→execute split, on torch process
groups.

Port of ``src/repro/core/routing.py``.  A hashable, quantized
:class:`RoutePlan` names WHAT to do (collective, mesh axes, per-path chunk
units, staged pipeline depth, accumulate policy) and a single generic
:func:`execute` driver owns HOW — payload partition, per-path dispatch
through the :class:`PathExecutor` registry, and merge.  The plan is the
reference's, field for field, so plan equality, hashes and
``plan_signature()`` carry over; only execution differs: the reference
runs inside ``shard_map`` and names axes, the port runs on each rank's
process and resolves the plan's axis names through the rank's
:class:`~repro_torch.launch.mesh.Mesh`, which every executor and
:func:`execute` take.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives as cx
from repro_torch.core.collectives import (CHUNK_GRID, PATH_ORDER, PATH_ORTHO,
                                          PATH_PRIMARY, PATH_STAGED)
from repro_torch.core.pipeline import N_BUFFERS
from repro_torch.core.topology import Collective
from repro_torch.kernels import ops as kops

#: accumulate policies for the staged ring's per-step reduce (DESIGN.md §3).
ACC_AUTO = "auto"              # kernel_fp32 for inexact dtypes, native for ints
ACC_KERNEL_FP32 = "kernel_fp32"  # K1 chunk_accumulate, fp32 accumulator
ACC_NATIVE = "native"          # plain a + b

#: default staged-ring pipeline depth — the §3.1 double-buffer (2 in-flight
#: sub-chunks); the communicator widens this for large payloads.
DEFAULT_STAGED_SUBSTEPS = N_BUFFERS

#: hard cap on sub-chunk pipelining (the reference's: its lowered
#: ppermute count scales with the depth, substeps x (N-1) per staged ring).
MAX_STAGED_SUBSTEPS = 8


# ---------------------------------------------------------------------------
# RoutePlan
# ---------------------------------------------------------------------------

#: one path class's instance subdivision: ((member, weight), ...) in the
#: link's member-declaration order, gcd-normalized.  See
#: :func:`canonical_member_layout`.
MemberLayout = Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...]

#: per-path wire codecs: ((path_class, codec_name), ...) in PATH_ORDER, only
#: non-primary classes with a real codec.  See :func:`canonical_path_codecs`.
PathCodecs = Tuple[Tuple[str, str], ...]


def canonical_path_codecs(codecs: Optional[Mapping[str, str]],
                          units: Mapping[str, int]) -> PathCodecs:
    """Canonicalize a per-class codec assignment into plan identity.

    Same cache-key hygiene rules as :func:`canonical_member_layout`:

    * the primary class is dropped unconditionally — the NVLink path never
      compresses (the paper's lossless contract; core/codecs.py);
    * classes carrying no payload are dropped — a drained class moves no
      wire bytes to encode;
    * "off"/empty entries are dropped — so every no-codec plan, including
      one built by a --compress launch whose pricing declined compression,
      is bit-identical to the pre-codec model's (plan hash, equality, and
      ``plan_signature()`` all unchanged; the DESIGN.md §12 parity
      contract).
    """
    if not codecs:
        return ()
    rows = []
    for cls in PATH_ORDER:
        if cls == PATH_PRIMARY or units.get(cls, 0) <= 0:
            continue
        name = codecs.get(cls, "")
        if name and name != "off":
            rows.append((cls, str(name)))
    return tuple(rows)


def canonical_member_layout(
        layout: Optional[Mapping[str, Sequence[Tuple[str, int]]]],
        units: Mapping[str, int]) -> MemberLayout:
    """Canonicalize a per-class member weight layout into plan identity.

    Rules (each one exists for cache-key hygiene):

    * classes carrying no payload are dropped — a drained class has no
      member subdivision to address;
    * weights are gcd-normalized — (8, 8, 2) and (16, 16, 4) describe the
      same subdivision and must not be distinct jit/exec cache keys;
    * an all-equal vector is dropped entirely — the *uniform* layout IS
      the class-level plan, which is what makes a uniform-member fabric's
      plans (and ``plan_signature()``) bit-identical to the pre-member
      model (the DESIGN.md §10 parity contract).  Zero-weight members are
      kept: (1, 1, 0) is a live 2-of-3 drain, not a 2-member uniform.
    """
    if not layout:
        return ()
    rows = []
    for cls in PATH_ORDER:
        if cls not in layout or units.get(cls, 0) <= 0:
            continue
        weights = [(str(m), int(w)) for m, w in layout[cls]]
        if len(weights) < 2:
            continue
        nz = [w for _, w in weights if w > 0]
        if not nz:
            continue
        g = math.gcd(*nz) if len(nz) > 1 else nz[0]
        norm = tuple((m, w // g) for m, w in weights)
        vals = {w for _, w in norm}
        if len(vals) == 1:
            continue                      # uniform: collapses to the class
        rows.append((cls, norm))
    return tuple(rows)


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """One quantized, hashable routing decision for one collective call.

    ``chunk_units`` maps each *active* path to its share of the payload in
    ``grain`` units (PATH_ORDER order, only nonzero entries) — the same
    quantization that bounds the jit-variant cache (DESIGN.md §2).  Two
    calls with equal plans lower to identical HLO, which is exactly what
    makes the plan a cache key.

    ``member_layout`` is the instance dimension (DESIGN.md §10): for each
    class whose link has diverging members (one rail drained), the
    gcd-normalized member weight vector its chunk units subdivide by.
    Uniform layouts canonicalize AWAY (see
    :func:`canonical_member_layout`), so the healthy fabric's plans are
    identical to the class-level model's.  The layout is part of the
    plan's identity — a member drain re-keys the PlanCache slot and the
    executable cache — but does NOT change the lowered HLO: instances of
    one class share the class's executor and mesh axis, and their payload
    split maps to per-instance channel/NIC assignment on real hardware,
    which XLA does not expose.  The timing model and the control plane
    are where the subdivision is priced and steered.
    """

    collective: Collective
    axis_name: str
    ortho_name: Optional[str]
    chunk_units: Tuple[Tuple[str, int], ...]
    grain: int = CHUNK_GRID
    staged_substeps: int = DEFAULT_STAGED_SUBSTEPS
    accumulate: str = ACC_AUTO
    member_layout: MemberLayout = ()
    #: per-path wire codecs (DESIGN.md §12) — canonicalized so no-codec
    #: plans stay bit-identical to the pre-codec model; a codec choice
    #: re-keys the PlanCache slot and the executable cache (the frozen plan
    #: IS the key), changes the staged/ortho executors' lowering to the
    #: encode→permute→decode-accumulate composites, and is priced by the
    #: PathTimingModel at wire bytes.
    path_codecs: PathCodecs = ()

    def units(self) -> Dict[str, int]:
        return dict(self.chunk_units)

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(p for p, _ in self.chunk_units)

    @property
    def is_primary_only(self) -> bool:
        return self.paths == (PATH_PRIMARY,)

    def member_weights(self, path: str) -> Optional[Tuple[Tuple[str, int], ...]]:
        """The (non-uniform) instance weights of one path class, if any."""
        for cls, weights in self.member_layout:
            if cls == path:
                return weights
        return None

    def codec_for(self, path: str) -> str:
        """The wire codec of one path class ("" = raw bytes)."""
        for cls, name in self.path_codecs:
            if cls == path:
                return name
        return ""


def build_plan(collective: Collective, axis_name: str,
               shares: Optional[Mapping[str, int]] = None,
               ortho_name: Optional[str] = None, *,
               grain: int = CHUNK_GRID,
               staged_substeps: int = DEFAULT_STAGED_SUBSTEPS,
               accumulate: str = ACC_AUTO,
               member_layout: Optional[Mapping[str, Sequence[Tuple[str, int]]]]
               = None,
               path_codecs: Optional[Mapping[str, str]] = None) -> RoutePlan:
    """Quantize a share vector into a RoutePlan.

    ``shares=None`` (or an ortho share with no ortho axis) degrades to the
    primary-only plan.  all_to_all has no ortho detour that avoids primary
    links, so any ortho share folds into the staged route — the balancer
    never routes a2a via ortho (see tests/test_routing.py).

    ``member_layout`` maps path classes to per-instance weight sequences
    (the communicator supplies each link's live member weights); it is
    canonicalized so only genuinely diverging instance layouts become part
    of the plan's identity.  The a2a ortho→staged fold drops the ortho
    class's layout rather than merging it: the two classes subdivide over
    DIFFERENT physical links, so a combined weight vector would be
    meaningless.

    ``path_codecs`` maps non-primary path classes to wire codec names
    (core/codecs.py); entries canonicalize away unless the class both
    carries payload and names a real codec, so default plans stay
    bit-identical.  The a2a fold likewise drops the ortho codec — the
    folded units travel the staged class's links under the staged codec.
    """
    if shares is None:
        units: Dict[str, int] = {PATH_PRIMARY: grain}
    else:
        order = [p for p in PATH_ORDER
                 if not (p == PATH_ORTHO and ortho_name is None)]
        units = {p: u for p, u in
                 cx.quantize_shares(shares, order, grain).items() if u > 0}
    if collective is Collective.ALL_TO_ALL and PATH_ORTHO in units:
        units[PATH_STAGED] = units.get(PATH_STAGED, 0) + units.pop(PATH_ORTHO)
        if member_layout and PATH_ORTHO in member_layout:
            member_layout = {c: w for c, w in member_layout.items()
                             if c != PATH_ORTHO}
    chunk_units = tuple((p, units[p]) for p in PATH_ORDER if p in units)
    substeps = max(1, min(int(staged_substeps), MAX_STAGED_SUBSTEPS))
    return RoutePlan(collective=collective, axis_name=axis_name,
                     ortho_name=ortho_name,
                     chunk_units=chunk_units, grain=grain,
                     staged_substeps=substeps, accumulate=accumulate,
                     member_layout=canonical_member_layout(member_layout,
                                                           units),
                     path_codecs=canonical_path_codecs(path_codecs, units))



def resolve_accumulate(plan: RoutePlan, dtype,
                       override: Optional[Callable] = None
                       ) -> Optional[Callable]:
    """The staged ring's per-step reduce for this plan + payload dtype.

    Returns None for the native ``a + b``; otherwise the K1
    ``chunk_accumulate`` closure with an fp32 accumulator — the
    mixed-precision detail that keeps bf16 ring reductions from losing low
    bits across N-1 sequential steps.  Under ``ACC_AUTO`` the kernel is
    only injected for SUB-32-bit real floats: integers stay exact on
    native add; float64/complex must NOT be rounded through an fp32
    accumulator (that would contradict the lossless contract); and for
    float32 an fp32 accumulator is bitwise identical to the native add,
    so the kernel would be pure overhead.  ``ACC_KERNEL_FP32`` forces the
    kernel (the caller accepts fp32 rounding, e.g. an explicit f64
    opt-in) and rejects dtypes the kernel cannot represent.
    """
    if override is not None:
        return override
    if plan.accumulate == ACC_NATIVE:
        return None
    if plan.accumulate == ACC_KERNEL_FP32:
        if not dtype.is_floating_point:
            raise TypeError(
                f"accumulate policy {ACC_KERNEL_FP32!r} requires a real "
                f"floating payload, got {dtype}")
        return kops.ring_accumulate_fn(torch.float32)
    # ACC_AUTO
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return kops.ring_accumulate_fn(torch.float32)
    return None


# ---------------------------------------------------------------------------
# PathExecutor registry
# ---------------------------------------------------------------------------

#: PathExecutor(segment, plan, accumulate, mesh) -> per-path partial result.
PathExecutor = Callable[[torch.Tensor, RoutePlan, Optional[Callable], object],
                        torch.Tensor]

_EXECUTORS: Dict[Tuple[Collective, str], PathExecutor] = {}


def register_executor(collective: Collective, path: str):
    """Register the implementation of one (collective, path) cell.  New path
    classes plug in here without touching the driver."""
    def deco(fn: PathExecutor) -> PathExecutor:
        _EXECUTORS[(collective, path)] = fn
        return fn
    return deco


def executor_for(collective: Collective, path: str) -> PathExecutor:
    try:
        return _EXECUTORS[(collective, path)]
    except KeyError:
        raise NotImplementedError(
            f"no PathExecutor registered for ({collective.value!r}, "
            f"{path!r})") from None


# -- all_reduce --------------------------------------------------------------

@register_executor(Collective.ALL_REDUCE, PATH_PRIMARY)
def _ar_primary(seg, plan, acc, mesh):
    return mesh.all_reduce(seg, plan.axis_name)


@register_executor(Collective.ALL_REDUCE, PATH_STAGED)
def _ar_staged(seg, plan, acc, mesh):
    return cx.ring_all_reduce(seg, mesh, plan.axis_name, acc,
                              substeps=plan.staged_substeps,
                              codec=plan.codec_for(PATH_STAGED))


@register_executor(Collective.ALL_REDUCE, PATH_ORTHO)
def _ar_ortho(seg, plan, acc, mesh):
    return cx.ortho_all_reduce(seg, mesh, plan.axis_name, plan.ortho_name,
                               codec=plan.codec_for(PATH_ORTHO))


# -- all_gather --------------------------------------------------------------

@register_executor(Collective.ALL_GATHER, PATH_PRIMARY)
def _ag_primary(seg, plan, acc, mesh):
    return mesh.all_gather(seg, plan.axis_name)


@register_executor(Collective.ALL_GATHER, PATH_STAGED)
def _ag_staged(seg, plan, acc, mesh):
    return cx.ring_all_gather(seg, mesh, plan.axis_name,
                              substeps=plan.staged_substeps,
                              codec=plan.codec_for(PATH_STAGED))


@register_executor(Collective.ALL_GATHER, PATH_ORTHO)
def _ag_ortho(seg, plan, acc, mesh):
    return cx.ortho_all_gather(seg, mesh, plan.axis_name, plan.ortho_name,
                               codec=plan.codec_for(PATH_ORTHO))


# -- reduce_scatter (segments are [lead, f_p] column groups) -----------------

@register_executor(Collective.REDUCE_SCATTER, PATH_PRIMARY)
def _rs_primary(seg, plan, acc, mesh):
    return mesh.reduce_scatter(seg, plan.axis_name)


@register_executor(Collective.REDUCE_SCATTER, PATH_STAGED)
def _rs_staged(seg, plan, acc, mesh):
    return cx.ring_reduce_scatter(seg, mesh, plan.axis_name, acc,
                                  substeps=plan.staged_substeps,
                                  codec=plan.codec_for(PATH_STAGED))


@register_executor(Collective.REDUCE_SCATTER, PATH_ORTHO)
def _rs_ortho(seg, plan, acc, mesh):
    red = cx.ortho_all_reduce(seg, mesh, plan.axis_name, plan.ortho_name,
                              codec=plan.codec_for(PATH_ORTHO))
    n = mesh.axis_size(plan.axis_name)
    idx = mesh.axis_index(plan.axis_name)
    part = seg.shape[0] // n
    return red[idx * part:(idx + 1) * part]


# -- all_to_all (segments are [lead, f_p] column groups; ortho folds into
#    staged at plan-build time, so only two cells exist) ---------------------

@register_executor(Collective.ALL_TO_ALL, PATH_PRIMARY)
def _a2a_primary(seg, plan, acc, mesh):
    return mesh.all_to_all(seg, plan.axis_name)


@register_executor(Collective.ALL_TO_ALL, PATH_STAGED)
def _a2a_staged(seg, plan, acc, mesh):
    return cx.ring_all_to_all(seg, mesh, plan.axis_name,
                              codec=plan.codec_for(PATH_STAGED))

# ---------------------------------------------------------------------------
# the generic driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _CollectiveSpec:
    """Per-collective layout contract consumed by :func:`execute`.

    layout="payload"  : partition the flat payload; every path moves a flat
                        segment (all_reduce, all_gather).
    layout="columns"  : per-rank structure lives on the leading axis; paths
                        get column groups of the [lead, F] view so every
                        sub-collective preserves the rank-chunk layout
                        (reduce_scatter, all_to_all).
    """

    layout: str
    stacked: bool = False        # payload layout: results are [n, seg] stacks
    scatters_lead: bool = False  # columns layout: output lead = lead / n


_SPECS: Dict[Collective, _CollectiveSpec] = {
    Collective.ALL_REDUCE: _CollectiveSpec(layout="payload"),
    Collective.ALL_GATHER: _CollectiveSpec(layout="payload", stacked=True),
    Collective.REDUCE_SCATTER: _CollectiveSpec(layout="columns",
                                               scatters_lead=True),
    Collective.ALL_TO_ALL: _CollectiveSpec(layout="columns"),
}


def execute(plan: RoutePlan, x: torch.Tensor, mesh, *,
            accumulate: Optional[Callable] = None) -> torch.Tensor:
    """Run one multi-path collective on this rank: partition → dispatch →
    merge.

    This is the ONLY place that splits payload across paths and reassembles
    per-path results; the four ``flex_*`` entry points and the communicator
    data plane all land here.  ``x`` is this rank's tensor in the
    collective's canonical form (all_to_all: split axis leading;
    reduce_scatter: leading dim divisible by the axis size).  Paths run in
    PATH_ORDER, one after the other, so every rank issues the same
    sequence of collectives.  Primary-only plans short-circuit to the
    native collective.

    Every collective here is differentiable (all-reduce, all-gather,
    reduce-scatter and all-to-all): see :class:`_Execute`.
    """
    if plan.collective in _TRANSPOSE:
        return _Execute.apply(x, plan, mesh, accumulate)
    return _run(plan, x, mesh, accumulate)


def _run(plan: RoutePlan, x: torch.Tensor, mesh,
         accumulate: Optional[Callable]) -> torch.Tensor:
    """The forward-only body of :func:`execute`."""
    spec = _SPECS[plan.collective]
    if plan.is_primary_only:
        # whole payload through the ONE registered primary executor — the
        # same cell mixed plans use for their primary segment
        return executor_for(plan.collective, PATH_PRIMARY)(x, plan, None,
                                                           mesh)
    acc = resolve_accumulate(plan, x.dtype, accumulate)
    units = plan.units()
    disp = {p: executor_for(plan.collective, p) for p in plan.paths}
    if spec.layout == "payload":
        segs, pad = cx.partition_payload(x, units, PATH_ORDER, plan.grain)
        outs = {p: disp[p](seg, plan, acc, mesh) for p, seg in segs.items()}
        if spec.stacked:            # each outs[p] is [n, seg_len]
            n = mesh.axis_size(plan.axis_name)
            per_rank = cx.merge_columns(outs, PATH_ORDER, pad)
            return per_rank.reshape((n,) + tuple(x.shape))
        return cx.merge_payload(outs, PATH_ORDER, pad, x.shape, x.dtype)
    # columns layout
    n = mesh.axis_size(plan.axis_name)
    lead = x.shape[0]
    if lead % n != 0:
        raise ValueError(
            f"{plan.collective.value}: leading dim {lead} must divide the "
            f"axis size {n}")
    feat = x.reshape(lead, -1)
    segs, pad = cx.partition_columns(feat, units, PATH_ORDER, plan.grain)
    outs = {p: disp[p](seg, plan, acc, mesh) for p, seg in segs.items()}
    merged = cx.merge_columns(outs, PATH_ORDER, pad)
    out_lead = lead // n if spec.scatters_lead else lead
    return merged.reshape((out_lead,) + tuple(x.shape[1:]))


#: each differentiable collective's transpose: the collective its
#: backward runs on the cotangent
_TRANSPOSE = {Collective.ALL_REDUCE: Collective.ALL_REDUCE,
              Collective.ALL_GATHER: Collective.REDUCE_SCATTER,
              Collective.REDUCE_SCATTER: Collective.ALL_GATHER,
              Collective.ALL_TO_ALL: Collective.ALL_TO_ALL}


def transpose_plan(plan: RoutePlan) -> RoutePlan:
    """The plan a collective's backward runs: its transpose collective
    over the SAME routes, units, grain, substeps and accumulate policy,
    with the wire codecs stripped (the straight-through estimator of the
    reference's codec composites, collectives.py:198, 227, 272)."""
    return dataclasses.replace(plan, collective=_TRANSPOSE[plan.collective],
                               path_codecs=())


class _Execute(torch.autograd.Function):
    """One multi-path collective under autograd, with the reference's
    transposes under ``shard_map(check_vma=False)``:

    * all-reduce: the cotangent all-reduced (psum's transpose is psum);
    * all-gather ([n, *x] stacked): the stacked cotangent reduce-scattered
      over the rank dim, so rank r gets sum_k g_k[r] (psum the whole
      cotangent, then take the rank's own row, the codec all-gather VJP
      of reference collectives.py:272-282); the reduce-scatter's column
      groups are the gather's payload segments, route for route;
    * reduce-scatter: the cotangent all-gathered back to x's shape;
    * all-to-all (split = concat = axis 0, equal blocks): its own
      transpose, since block j of rank r lands as block r of rank j; the
      cotangent runs the same plan, column group for column group, on the
      primary collective and the staged ring alike.

    The forward runs the plan as it is, codecs included; the backward runs
    :func:`transpose_plan` through :func:`execute`, on the routes the
    forward took.  Nothing here records a call: the backward reuses the
    forward's plan and never asks a communicator for one.  Every rank
    builds the same graph, so their backwards issue the same collectives
    in the same order; on CUDA they run on autograd's device thread, on
    the stream the forward used.  The backward's collectives trace as the
    forward's did (``Mesh.untraced``): a repeated layer's transposes
    repeat too.
    """

    @staticmethod
    def forward(ctx, x, plan, mesh, accumulate):
        ctx.plan, ctx.mesh, ctx.accumulate = plan, mesh, accumulate
        ctx.shape = x.shape
        ctx.traced = mesh.traced_now
        with torch.no_grad():
            return _run(plan, x, mesh, accumulate)

    @staticmethod
    def backward(ctx, g):
        scope = (contextlib.nullcontext() if ctx.traced
                 else ctx.mesh.untraced())
        with scope:
            gx = execute(transpose_plan(ctx.plan), g.contiguous(), ctx.mesh,
                         accumulate=ctx.accumulate)
        return gx.reshape(ctx.shape), None, None, None


# ---------------------------------------------------------------------------
# flex_* entry points (thin wrappers: canonicalize → plan → execute)
# ---------------------------------------------------------------------------

def flex_all_reduce(x: torch.Tensor, mesh, axis_name: str, *,
                    shares: Optional[Mapping[str, int]] = None,
                    ortho_name: Optional[str] = None,
                    accumulate: Optional[Callable] = None,
                    substeps: int = DEFAULT_STAGED_SUBSTEPS) -> torch.Tensor:
    """Share-partitioned multi-path all-reduce (lossless)."""
    plan = build_plan(Collective.ALL_REDUCE, axis_name, shares, ortho_name,
                      staged_substeps=substeps)
    return execute(plan, x, mesh, accumulate=accumulate)


def tile_gathered(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[n, *x.shape] stacked gather result -> tiled-along-axis-0 layout."""
    n = g.shape[0]
    if x.ndim:
        return g.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return g.reshape(-1)


def flex_all_gather(x: torch.Tensor, mesh, axis_name: str, *,
                    shares: Optional[Mapping[str, int]] = None,
                    ortho_name: Optional[str] = None,
                    tiled: bool = False,
                    substeps: int = DEFAULT_STAGED_SUBSTEPS) -> torch.Tensor:
    """Share-partitioned multi-path all-gather.

    Returns rank-major stacked result ``[n, *x.shape]`` (or tiled along axis
    0 when ``tiled=True``), identical to ``lax.all_gather``.
    """
    plan = build_plan(Collective.ALL_GATHER, axis_name, shares, ortho_name,
                      staged_substeps=substeps)
    g = execute(plan, x, mesh)
    return tile_gathered(g, x) if tiled else g


def flex_reduce_scatter(x: torch.Tensor, mesh, axis_name: str, *,
                        shares: Optional[Mapping[str, int]] = None,
                        ortho_name: Optional[str] = None,
                        accumulate: Optional[Callable] = None,
                        substeps: int = DEFAULT_STAGED_SUBSTEPS
                        ) -> torch.Tensor:
    """Share-partitioned reduce-scatter over leading dim (divisible by n)."""
    if x.shape[0] % mesh.axis_size(axis_name) != 0:
        raise ValueError("leading dim must divide the axis size")
    plan = build_plan(Collective.REDUCE_SCATTER, axis_name, shares,
                      ortho_name, staged_substeps=substeps)
    return execute(plan, x, mesh, accumulate=accumulate)


def execute_all_to_all(plan: RoutePlan, x: torch.Tensor, mesh,
                       split_axis: int = 0,
                       concat_axis: int = 0) -> torch.Tensor:
    """all_to_all canonicalization shared by flex_all_to_all and the
    communicator data plane: validate split==concat, move the split axis
    to the front for the generic driver (primary-only plans short-circuit
    inside it) and move it back.
    """
    if split_axis != concat_axis:
        raise NotImplementedError("all_to_all requires split==concat axis")
    res = execute(plan, torch.movedim(x, split_axis, 0), mesh)
    return torch.movedim(res, 0, split_axis)


def flex_all_to_all(x: torch.Tensor, mesh, axis_name: str, *,
                    split_axis: int = 0, concat_axis: int = 0,
                    shares: Optional[Mapping[str, int]] = None,
                    ortho_name: Optional[str] = None,
                    substeps: int = DEFAULT_STAGED_SUBSTEPS) -> torch.Tensor:
    """Share-partitioned all-to-all; restricted to ``split_axis ==
    concat_axis`` (the expert-parallel dispatch pattern); ortho shares fold
    into the staged route at plan time."""
    plan = build_plan(Collective.ALL_TO_ALL, axis_name, shares, ortho_name,
                      staged_substeps=substeps)
    return execute_all_to_all(plan, x, mesh, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# PlanCache — the jit-variant plan cache (DESIGN.md §2), with stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    retraces: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class PlanCache:
    """Plan cache keyed by the *quantized* plan identity per size bucket.

    The builder runs every lookup (plan construction is cheap host
    arithmetic); what is cached is the plan's identity.  A *miss* means
    this quantized plan was never seen for this ``(op, bucket)`` — and
    therefore any jitted step closing over it traces a new variant.  A
    *retrace* counts every lookup (hit or miss) where the slot flips to a
    DIFFERENT plan than it last resolved to: Stage 2 moved enough share to
    change the quantized split, so callers must re-trace — returning to a
    previously-seen plan is a hit AND a retrace.  Share moves that
    quantize to the same chunk_units are plain hits — no new jit variant
    exists, so the stats match the DESIGN.md §2 claim exactly, measured
    instead of asserted.
    """

    def __init__(self):
        self._plans: Dict[Tuple, RoutePlan] = {}
        self._slot: Dict[Tuple, Tuple] = {}
        self.stats = PlanCacheStats()

    def __len__(self) -> int:
        return len(self._plans)

    def plan_signature(self) -> Tuple:
        """Frozen snapshot of the slot→plan mapping: what every ``(op,
        bucket)`` slot LAST resolved to, in a canonical order.  This is the
        raw half of the executable-cache key (runtime/exec_cache.py); the
        communicator's ``plan_signature()`` refreshes each slot through
        :meth:`lookup` first so Stage-2 moves register as hit/retrace
        before the snapshot is taken.
        """
        rows = [(op.value, bucket, key[2])
                for (op, bucket), key in self._slot.items()]
        return tuple(sorted(rows, key=lambda r: (r[0], r[1])))

    def current(self, collective: Collective,
                bucket: int) -> Optional[RoutePlan]:
        """The plan the slot last resolved to (None before its first
        lookup), without touching the stats."""
        key = self._slot.get((collective, bucket))
        return None if key is None else key[2]

    def lookup(self, collective: Collective, bucket: int,
               builder: Callable[[], RoutePlan]) -> RoutePlan:
        plan = builder()
        # the frozen plan is its own identity: dataclass equality/hash cover
        # every field, so new fields can never silently miss the key
        key = (collective, bucket, plan)
        slot = (collective, bucket)
        # a slot flipping to ANY different plan — new or previously seen —
        # forces the caller to re-trace its jitted step
        if slot in self._slot and self._slot[slot] != key:
            self.stats.retraces += 1
        cached = self._plans.get(key)
        if cached is not None:
            self.stats.hits += 1
            plan = cached
        else:
            self.stats.misses += 1
            self._plans[key] = plan
        self._slot[slot] = key
        return plan

    def report(self) -> Dict[str, int]:
        out = self.stats.as_dict()
        out["size"] = len(self)
        return out
