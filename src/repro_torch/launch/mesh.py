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
with ``ppermute`` (ROADMAP, route classes).  A mesh with a ``"node"`` axis
(the two-tier cluster, ``(node, data, model)`` as the reference's
``make_cluster_mesh`` orders it) also gets one primary group over this
rank's (node, data) plane, :data:`PLANE`, for reductions over both axes
at once (``all_reduce(x, PLANE)``, the reference's ``lax.psum`` over an
axis tuple).

The wire follows the backend, chosen by the caller and never by catching
an error:

* ``"nccl"``: one card per rank; tensors go to NCCL where they lie;
* ``"gloo"``: every point-to-point transfer and reduction goes through an
  explicit host copy (gloo's send/recv take host tensors only), so
  ``wire == "host"``; on CUDA tensors the partition, merge and the ring's
  accumulate kernel stay on the card.

The mesh's collectives never write into their inputs.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: axis names the reference's meshes use, outermost first
AXES = ("pod", "node", "data", "model")
_LATER = {"pod": "ROADMAP queue 1 item 14 (pod tier)"}
#: the gradient plane of a cluster mesh: the axes a step's metrics sum over
PLANE = ("node", "data")
CHANNELS = ("primary", "staged")


class Mesh:
    """This rank's view of a named mesh over the default process group.

    Every rank of the default group must build the same mesh, in the same
    order of calls: each axis line gets its process groups from
    ``dist.new_group``, which is collective over the whole world.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 device: str = "cuda"):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ")
        for a in axes:
            if a in _LATER:
                raise NotImplementedError(f"mesh axis {a!r} is not ported: "
                                          f"{_LATER[a]}")
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r}; one of {AXES}")
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised default process "
                               "group (run_ranks sets one up)")
        self.shape = shape
        self.axes = axes
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if int(np.prod(shape)) != self.world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                             f"{int(np.prod(shape))} ranks, the world has "
                             f"{self.world}")
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
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             shape))
        grid = np.arange(self.world).reshape(shape)
        # axis -> the global ranks of this rank's line, by axis index
        self._line: Dict[str, Tuple[int, ...]] = {}
        self._groups: Dict[Tuple[str, str], Any] = {}
        for i, a in enumerate(axes):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                for ch in CHANNELS:
                    g = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        self._groups[(a, ch)] = g
                if self.rank in ranks:
                    self._line[a] = ranks
        if all(a in axes for a in PLANE):
            # every (node, data) plane, in the same order on every rank
            idx = [axes.index(a) for a in PLANE]
            rest = [i for i in range(len(axes)) if i not in idx]
            planes = np.transpose(grid, rest + idx).reshape(
                -1, int(np.prod([shape[i] for i in idx])))
            for plane in planes:
                ranks = tuple(int(r) for r in plane)
                g = dist.new_group(list(ranks))
                if self.rank in ranks:
                    self._groups[(PLANE, "primary")] = g

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

    def group(self, axis: str, channel: str = "primary"):
        return self._groups[(axis, channel)]

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
        """Sum (or max) over ``axis``, or over the :data:`PLANE` tuple:
        ``lax.psum`` / ``lax.pmax``."""
        if self.axis_size(axis) == 1:
            return x.clone()
        h = self._wire_in(x)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(h, op=red, group=self.group(axis))
        return self._wire_out(h, x)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum`` under autograd: the sum over ``axis`` on the primary
        group, whose backward all-reduces the cotangent (psum's transpose
        under ``shard_map(check_vma=False)``)."""
        return _PSum.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[n, *x.shape], entry j from axis index j: ``lax.all_gather``."""
        n = self.axis_size(axis)
        if n == 1:
            return x.clone()[None]
        h = self._wire_in(x)
        bufs = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(bufs, h, group=self.group(axis))
        return self._wire_out(torch.stack(bufs), x)

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over ``axis``, this rank's 1/n of the leading dim:
        ``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``.  On the
        host wire this is a gloo all-reduce and a slice (the same sums)."""
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: leading dim {x.shape[0]} "
                             f"does not divide by {n}")
        if n == 1:
            return x.clone()
        lead = x.shape[0] // n
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

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Block j of the leading dim goes to axis index j; the result's
        block j comes from index j: ``lax.all_to_all(..., 0, 0,
        tiled=True)``."""
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: leading dim {x.shape[0]} does "
                             f"not divide by {n}")
        if n == 1:
            return x.clone()
        h = self._wire_in(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=self.group(axis))
        return self._wire_out(out, x)

    def broadcast(self, x: torch.Tensor, axis: str, root: int) -> torch.Tensor:
        """Every rank of the line gets the tensor of axis index ``root``."""
        if self.axis_size(axis) == 1:
            return x.clone()
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
        under tag j."""
        if self.axis_size(axis) == 1:
            return [x.clone() for x in xs]
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


class _PSum(torch.autograd.Function):
    """:meth:`Mesh.psum`: all-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


# ---------------------------------------------------------------------------
# run_ranks: one function on every rank, each rank a spawned process
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, device, port, timeout_s, args,
               results) -> None:
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
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
    survive ``fork``), joined to a default process group of ``backend``
    over a TCP store on a free local port, with ``timeout_s`` as the group
    timeout, so a hung collective fails within it instead of holding the
    caller (a test run, a chip call) until its own limit.  ``fn`` and
    ``args`` must pickle, and ``fn`` must live in a module a fresh
    interpreter can import.  With ``device="cuda"``, nccl puts rank r on
    card r (and raises when there are fewer cards than ranks); gloo puts
    every rank on card 0, and its wire goes through the host.  Raises with
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
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device, port,
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
    return [got[r] for r in range(world)]
