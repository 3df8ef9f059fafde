"""Named-axis meshes over ``torch.distributed`` process groups, and the
harness that runs one function on every rank.

Port of ``src/repro/launch/mesh.py`` and ``src/repro/compat/axes.py``.  In
the reference one SPMD program sees a ``jax.make_mesh`` and names its axes
inside ``shard_map``; here every rank is a process, and a :class:`Mesh`
maps each axis name to the process groups of this rank's line along it.
Ranks take mesh coordinates in the order ``jax.make_mesh`` gives devices:
row-major over the axis tuple, so rank r sits at
``np.unravel_index(r, shape)``.

Each axis has two channels, each its own process group over the same
ranks: ``"primary"`` carries the native collective and ``"staged"`` the
explicit point-to-point ring, the separate channel the reference models
with ``ppermute`` (ROADMAP, route classes).  The axes a mesh has among
:data:`PLANE` (pod, node, data), outermost first, are its gradient plane
(:attr:`Mesh.plane`): the two-tier cluster ``(node, data, model)``, the
three-tier ``(pod, node, data, model)`` (the reference's
``make_cluster_mesh`` with ``pods > 1``) and the legacy multi-pod
``(pod, data, model)``.  When the plane has two axes or more the mesh also
gets one primary group over this rank's plane, for reductions, gathers
and all_to_alls over several axes at once (``all_reduce(x, ("node",
"data"))``, the reference's ``lax.psum`` over an axis tuple); its ranks
are in row-major plane order, so rank (pod, node, i) of a (p, n, m) plane
is its ``(pod * n + node) * m + i``-th member.

The wire follows the backend, chosen by the caller and never by catching
an error:

* ``"nccl"``: one card per rank; tensors go to NCCL where they lie;
* ``"gloo"``: every point-to-point transfer and reduction goes through an
  explicit host copy (gloo's send/recv take host tensors only), so
  ``wire == "host"``; on CUDA tensors the partition, merge and the ring's
  accumulate kernel stay on the card.

The mesh's collectives never write into their inputs.

A dry mesh (:meth:`Mesh.dry`, ``wire == "dry"``) has the same lines,
coords, peers and plane as a live one and no process group: the dry-run's
production meshes ((16, 16), (2, 16, 16); :func:`make_production_mesh`),
which one process lowers a step on as one of their ranks.  Its
collectives take ``meta`` tensors only (they raise on any other) and
return ``meta`` tensors of the result's shape and dtype.  A live mesh
given ``meta`` tensors does the same and touches no wire (a step lowered
on a live rank, ``StepProgram.lower``); the choice goes by the tensor's
device type.  Every collective a mesh issues over an axis wider than 1
lands in every open :class:`TraceLog` as ``(op, axis, dtype, bytes)``:
the reference's HLO op name, the axis (``"node+data"`` for a tuple of
plane axes), the dtype's name and this rank's operand bytes (a permute
logs one entry a tensor, as ``ppermute`` lowers to one
``collective_permute`` a leaf).  A dry mesh keeps one log open for its
life (:attr:`Mesh.log`); :meth:`Mesh.tracing` opens one on any mesh.
Each entry counts as ``executed``, and as ``traced`` too unless it was
issued inside :meth:`Mesh.untraced` (``ParallelCtx.unrecorded``: a
layer loop's later layers and the checkpoint recompute), the reference's
scan body traced once.  The backward of a differentiable collective is
traced as its forward was.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: axis names the reference's meshes use, outermost first
AXES = ("pod", "node", "data", "model")
#: the axes a gradient plane may have, outermost first: what a step's
#: gradients and metrics sum over
PLANE = ("pod", "node", "data")
CHANNELS = ("primary", "staged")


class TraceLog:
    """The collectives a mesh issued while the log was open, each ``(op,
    axis, dtype, bytes)`` with ``bytes`` this rank's operand bytes:
    ``executed`` holds every one, ``traced`` those issued outside
    :meth:`Mesh.untraced`."""

    def __init__(self):
        self.traced: List[Tuple[str, str, str, int]] = []
        self.executed: List[Tuple[str, str, str, int]] = []

    def add(self, entry: Tuple[str, str, str, int], traced: bool) -> None:
        self.executed.append(entry)
        if traced:
            self.traced.append(entry)

    def structure(self, which: str = "traced") -> Dict[str, int]:
        """Calls by ``op@axis`` (the reference's collective structure)."""
        out: Dict[str, int] = {}
        for op, axis, _, _ in getattr(self, which):
            k = f"{op}@{axis}"
            out[k] = out.get(k, 0) + 1
        return out

    def bytes_by(self, which: str = "executed") -> Dict[str, int]:
        """Operand bytes of this rank by ``op@axis``."""
        out: Dict[str, int] = {}
        for op, axis, _, n in getattr(self, which):
            k = f"{op}@{axis}"
            out[k] = out.get(k, 0) + n
        return out


def _axis_label(axis) -> str:
    return "+".join(axis) if isinstance(axis, tuple) else axis


class Mesh:
    """This rank's view of a named mesh over the default process group.

    Without ``ranks`` the mesh spans the whole world, and every rank of the
    default group must build the same mesh, in the same order of calls:
    each axis line gets its process groups from ``dist.new_group``, which
    is then collective over the whole world.  ``ranks`` (the global ranks
    the mesh spans, in mesh order) builds a mesh over part of the world,
    the survivors of an elastic node loss: only those ranks call, and each
    builds just the groups it belongs to, with
    ``use_local_synchronization``, so ranks that have left take no part.
    The mesh's ``rank`` and ``coords`` are then the position in ``ranks``;
    its lines and peers keep global ranks.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 device: str = "cuda", ranks: Optional[Sequence[int]] = None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised default process "
                               "group (run_ranks sets one up)")
        local = ranks is not None
        #: the global ranks of the mesh, in mesh order
        all_ranks = (tuple(int(r) for r in ranks) if local
                     else tuple(range(dist.get_world_size())))
        if dist.get_rank() not in all_ranks:
            raise ValueError(f"rank {dist.get_rank()} is not one of the "
                             f"mesh's ranks {all_ranks}")
        self._place(shape, axes, all_ranks, all_ranks.index(dist.get_rank()))
        shape, axes = self.shape, self.axes
        self.backend = dist.get_backend()
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {self.backend!r}: gloo or nccl")
        self.wire = "host" if self.backend == "gloo" else "nccl"
        if device == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif device == "cpu":
            if self.backend == "nccl":
                raise ValueError("the nccl backend needs device='cuda'")
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"device {device!r}: cuda or cpu")
        me = dist.get_rank()
        grid = np.array(self.ranks).reshape(shape)

        def group(members: Tuple[int, ...]):
            """The group over ``members``: every rank calls for every
            group of a whole-world mesh, only the members for a mesh over
            ``ranks`` (each rank joins one group of each family, in the
            same order, so the members agree on the group's name)."""
            if not local:
                return dist.new_group(list(members))
            if me in members:
                return dist.new_group(list(members),
                                      use_local_synchronization=True)
            return None

        for i, a in enumerate(axes):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            for line in lines:
                members = tuple(int(r) for r in line)
                for ch in CHANNELS:
                    g = group(members)
                    if me in members:
                        self._groups[(a, ch)] = g
        if len(self.plane) > 1:
            # every plane, in the same order on every rank
            idx = [axes.index(a) for a in self.plane]
            rest = [i for i in range(len(axes)) if i not in idx]
            planes = np.transpose(grid, rest + idx).reshape(
                -1, int(np.prod([shape[i] for i in idx])))
            for plane in planes:
                members = tuple(int(r) for r in plane)
                g = group(members)
                if me in members:
                    self._groups[(self.plane, "primary")] = g

    @classmethod
    def dry(cls, shape: Sequence[int], axes: Sequence[str],
            rank: int = 0) -> "Mesh":
        """Rank ``rank``'s view of a mesh with no process group: the same
        lines, coords, peers and plane as a live mesh of that shape; its
        collectives take and return ``meta`` tensors and log into
        :attr:`log`, open for the mesh's life."""
        self = cls.__new__(cls)
        shape = tuple(int(s) for s in shape)
        world = int(np.prod(shape))
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a {world}-rank mesh")
        self._place(shape, axes, tuple(range(world)), rank)
        self.backend = self.wire = "dry"
        self.device = torch.device("meta")
        #: the dry mesh's trace log, open for its life
        self.log = TraceLog()
        self._logs.append(self.log)
        return self

    def _place(self, shape, axes, ranks: Tuple[int, ...], rank: int) -> None:
        """Shape, axes, this rank's coords and lines and the plane: what a
        live and a dry mesh share."""
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ")
        for a in axes:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r}; one of {AXES}")
        self.shape = shape
        self.axes = axes
        self.ranks = ranks
        self.world = len(ranks)
        self.rank = rank
        if int(np.prod(shape)) != self.world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                             f"{int(np.prod(shape))} ranks, the world has "
                             f"{self.world}")
        self.coords = tuple(int(c) for c in np.unravel_index(rank, shape))
        me = ranks[rank]
        grid = np.array(ranks).reshape(shape)
        # axis -> the global ranks of this rank's line, by axis index
        self._line: Dict[str, Tuple[int, ...]] = {}
        self._groups: Dict[Tuple[str, str], Any] = {}
        for i, a in enumerate(axes):
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                members = tuple(int(r) for r in line)
                if me in members:
                    self._line[a] = members
        #: the mesh's gradient plane: its axes among PLANE, outermost first
        self.plane = tuple(a for a in PLANE if a in axes)
        self._logs: List[TraceLog] = []
        self._untraced = 0

    # -- axis introspection (compat/axes.py) ----------------------------------

    def axis_size(self, axis) -> int:
        """The size of one axis, or the product over a tuple of axes."""
        if isinstance(axis, tuple):
            return int(np.prod([self.axis_size(a) for a in axis]))
        return self.shape[self.axes.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]

    def peer(self, axis: str, index: int) -> int:
        """Global rank of the rank at ``index`` (mod the axis size) on this
        rank's line along ``axis``."""
        line = self._line[axis]
        return line[index % len(line)]

    def group(self, axis, channel: str = "primary"):
        """The process group of ``axis`` on ``channel``; a tuple of axes
        takes the plane's primary group, so its axes wider than 1 must be
        the plane's, in the plane's order."""
        if isinstance(axis, tuple):
            wide = tuple(a for a in axis if self.axis_size(a) > 1)
            if wide != tuple(a for a in self.plane
                             if self.axis_size(a) > 1):
                raise ValueError(f"axes {axis}: a tuple spans the mesh's "
                                 f"plane {self.plane}")
            axis = self.plane
        return self._groups[(axis, channel)]

    # -- the trace log ----------------------------------------------------------

    @contextlib.contextmanager
    def tracing(self):
        """A fresh :class:`TraceLog` that every collective this mesh
        issues inside the scope lands in."""
        log = TraceLog()
        self._logs.append(log)
        try:
            yield log
        finally:
            self._logs.remove(log)

    @contextlib.contextmanager
    def untraced(self):
        """Collectives issued inside repeat ones the step's trace already
        holds: they log as executed, not as traced."""
        self._untraced += 1
        try:
            yield
        finally:
            self._untraced -= 1

    @property
    def traced_now(self) -> bool:
        """Whether a collective issued now logs as traced."""
        return not self._untraced

    def _issue(self, op: str, axis, x: torch.Tensor) -> bool:
        """Log one collective of ``x`` over ``axis`` (an axis wider than 1)
        into the open trace logs; True when ``x`` is a ``meta`` tensor,
        whose result the caller makes without the wire."""
        if self._logs:
            entry = (op, _axis_label(axis),
                     str(x.dtype).removeprefix("torch."),
                     x.numel() * x.element_size())
            for log in self._logs:
                log.add(entry, self.traced_now)
        return x.device.type == "meta"

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        """A dry mesh's refusal of a tensor that is not ``meta`` (on an
        axis of size 1 too, where no collective is issued)."""
        if self.wire == "dry":
            for x in xs:
                if x.device.type != "meta":
                    raise ValueError(f"dry mesh: a {x.device.type} tensor; "
                                     f"a dry mesh takes meta tensors only")

    # -- the wire -------------------------------------------------------------

    def _wire_in(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``x`` that the wire may write into: on the
        host for gloo, where ``x`` lies for nccl."""
        if self.wire == "host":
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone(memory_format=torch.contiguous_format)

    def _wire_out(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device)

    def all_reduce(self, x: torch.Tensor, axis,
                   op: str = "sum") -> torch.Tensor:
        """Sum (or max) over ``axis``, or over a tuple of plane axes:
        ``lax.psum`` / ``lax.pmax``."""
        self._check([x])
        if self.axis_size(axis) == 1:
            return x.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._issue("all_reduce", axis, x):
            return torch.empty_like(x)
        h = self._wire_in(x)
        dist.all_reduce(h, op=red, group=self.group(axis))
        return self._wire_out(h, x)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum`` under autograd: the sum over ``axis`` on the primary
        group, whose backward all-reduces the cotangent (psum's transpose
        under ``shard_map(check_vma=False)``)."""
        return _PSum.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """[n, *x.shape], entry j from axis index j (from the j-th rank of
        the plane, for a tuple of plane axes): ``lax.all_gather``."""
        self._check([x])
        n = self.axis_size(axis)
        if n == 1:
            return x.clone()[None]
        if self._issue("all_gather", axis, x):
            return x.new_empty((n,) + tuple(x.shape))
        h = self._wire_in(x)
        bufs = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(bufs, h, group=self.group(axis))
        return self._wire_out(torch.stack(bufs), x)

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over ``axis``, this rank's 1/n of the leading dim:
        ``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``.  On the
        host wire this is a gloo all-reduce and a slice (the same sums)."""
        self._check([x])
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: leading dim {x.shape[0]} "
                             f"does not divide by {n}")
        if n == 1:
            return x.clone()
        lead = x.shape[0] // n
        if self._issue("reduce_scatter", axis, x):
            return x.new_empty((lead,) + tuple(x.shape[1:]))
        h = self._wire_in(x)
        if self.wire == "host":
            dist.all_reduce(h, group=self.group(axis))
            i = self.axis_index(axis)
            out = h[i * lead:(i + 1) * lead]
        else:
            out = torch.empty((lead,) + tuple(h.shape[1:]), dtype=h.dtype,
                              device=h.device)
            dist.reduce_scatter_tensor(out, h, group=self.group(axis))
        return self._wire_out(out, x)

    def all_to_all(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Block j of the leading dim goes to axis index j (the j-th rank
        of the plane, for a tuple of plane axes); the result's block j
        comes from index j: ``lax.all_to_all(..., 0, 0, tiled=True)``."""
        self._check([x])
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: leading dim {x.shape[0]} does "
                             f"not divide by {n}")
        if n == 1:
            return x.clone()
        if self._issue("all_to_all", axis, x):
            return torch.empty_like(x)
        h = self._wire_in(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=self.group(axis))
        return self._wire_out(out, x)

    def broadcast(self, x: torch.Tensor, axis: str, root: int) -> torch.Tensor:
        """Every rank of the line gets the tensor of axis index ``root``."""
        self._check([x])
        if self.axis_size(axis) == 1:
            return x.clone()
        if self._issue("broadcast", axis, x):
            return torch.empty_like(x)
        h = self._wire_in(x)
        dist.broadcast(h, src=self.peer(axis, root), group=self.group(axis))
        return self._wire_out(h, x)

    def permute(self, xs: Sequence[torch.Tensor], axis: str, send_to: int,
                recv_from: int, channel: str = "staged"
                ) -> List[torch.Tensor]:
        """One ``lax.ppermute`` step for every tensor of ``xs`` at once:
        send each to axis index ``send_to``, receive its counterpart from
        ``recv_from`` (the caller's permutation, seen from this rank).  All
        transfers are posted before any is waited on; tensor j travels
        under tag j.  ``meta`` tensors (all of ``xs`` or none) are logged
        and answered without the wire."""
        self._check(xs)
        if self.axis_size(axis) == 1:
            return [x.clone() for x in xs]
        metas = [self._issue("collective_permute", axis, x) for x in xs]
        if any(metas):
            if not all(metas):
                raise ValueError("permute: meta tensors mixed with others")
            return [torch.empty_like(x) for x in xs]
        group = self.group(axis, channel)
        dst, src = self.peer(axis, send_to), self.peer(axis, recv_from)
        sends = [self._wire_in(x) for x in xs]
        recvs = [torch.empty_like(h) for h in sends]
        ops = []
        for j, (s, r) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, s, dst, group, tag=j))
            ops.append(dist.P2POp(dist.irecv, r, src, group, tag=j))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [self._wire_out(r, x) for r, x in zip(recvs, xs)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry-run's production mesh, rank 0's view of it: one pod (16,
    16) over ("data", "model"), or two (2, 16, 16) over ("pod", "data",
    "model"), the pod axis crossing DCN.  A dry mesh: 256 or 512 ranks
    need no process group to lower a step."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.dry(shape, axes)


def mesh_dims(mesh: Mesh) -> Tuple[int, int, int]:
    """(pods, dp, tp) of a ("pod"?, ["node",] "data", "model") mesh."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    return sizes.get("pod", 1), sizes.get("data", 1), sizes.get("model", 1)


def mesh_nodes(mesh: Mesh) -> int:
    """The node axis's size (1 when the mesh has none)."""
    return dict(zip(mesh.axes, mesh.shape)).get("node", 1)


def without_node(mesh: Mesh, node: int) -> Tuple[int, ...]:
    """The global ranks of a (node, data, model) mesh without node
    ``node``, in row-major order: the survivors of its loss, in the order
    of the mesh they rebuild."""
    grid = np.array(mesh.ranks).reshape(mesh.shape)
    axis = mesh.axes.index("node")
    return tuple(int(r) for r in np.delete(grid, node, axis=axis).ravel())


class _PSum(torch.autograd.Function):
    """:meth:`Mesh.psum`: all-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.traced = mesh.traced_now
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        scope = (contextlib.nullcontext() if ctx.traced
                 else ctx.mesh.untraced())
        with scope:
            return ctx.mesh.all_reduce(g, ctx.axis), None, None


# ---------------------------------------------------------------------------
# run_ranks: one function on every rank, each rank a spawned process
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, backend, device, port, timeout_s, args,
               results) -> None:
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        out = fn(*args)
        if device == "cuda":
            torch.cuda.synchronize()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, *, backend: str = "gloo",
              device: str = "cuda", timeout_s: float = 300.0,
              args: tuple = ()) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks and return each rank's result,
    by rank.

    Each rank is a process started with the ``spawn`` method (CUDA does not
    survive ``fork``), joined to a default process group of ``backend`` over a
    TCP store that this process hosts on a free local port (so any rank, rank 0
    too, may leave while the others build new groups: an elastic node loss),
    with ``timeout_s`` as the group timeout, so a hung collective fails within
    it instead of holding the caller (a test run, a chip call) until its own
    limit.  ``fn`` and ``args`` must pickle, and ``fn`` must live in a
    module a fresh interpreter can import.  With ``device="cuda"``, nccl
    puts rank r on card r (and raises when there are fewer cards than
    ranks); gloo puts every rank on card 0, and its wire goes through the
    host.  Raises with
    the failing rank's traceback if any rank fails, and a TimeoutError if
    the ranks have not all answered after ``timeout_s``; every process is
    stopped before it returns."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA card")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"nccl runs one card per rank: {world} "
                               f"ranks, {torch.cuda.device_count()} cards")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device, store.port,
                               timeout_s, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(got)} of "
                                   f"{world} ranks silent after "
                                   f"{timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} exited "
                                       f"with code {procs[dead[0]].exitcode}"
                                       " and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        del store
    return [got[r] for r in range(world)]
