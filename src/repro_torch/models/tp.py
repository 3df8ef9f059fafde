"""Parallelism context — how model code reaches the communication backend.

Port of ``src/repro/models/tp.py`` for one device and for a (data, model)
mesh.  Model layers call collectives only through a ``ParallelCtx``.  On
one device every collective is the identity and there are no
communicators: constant signature, no Stage-2 feedback, empty reports.
With an axis wider than 1 the ctx holds the rank's
:class:`~repro_torch.launch.mesh.Mesh` and takes that axis's
:class:`FlexCommunicator` from the memoized ``comm_init_rank`` registry,
the model axis's first and the data axis's second, each with the other as
its ortho axis, as the reference's.  The model axis carries the
tensor-parallel combines (``tp_all_reduce``, ``tp_all_gather``,
``tp_reduce_scatter``), differentiable through ``routing.execute``, and
the small softmax statistics (``tp_psum_small`` / ``tp_pmax_small`` on
the mesh's primary group); ``grad_all_reduce`` runs the data axis's
multi-path all-reduce.  The program API (``register_program``,
``recording``, ``observe_program``, ``plan_signature``, ``comm_report``,
``tuning_status``, ``save_tuning_profile``) reads and feeds those
communicators as the reference's does, and :meth:`unrecorded` keeps
repeated calls of one step out of their replay logs.  ``metrics_reduce``
sums the step's metrics over the data axis in one small all-reduce, and
``ef_codec_name`` / ``ef_active_for`` answer whether a gradient reduce
crosses a lossy wire codec.  Issue scopes for in-flight gradient buckets
come with the bucketer (ROADMAP queue 1 item 8).

Still raising, each with the ROADMAP queue 1 item that lifts it: a node
axis (item 12) and a pod axis (item 14).  Serving across devices (item
11) raises in the decode paths (models/layers.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.communicator import (CommConfig, FlexCommunicator,
                                           comm_init_rank)

_LATER = (("node_size", "a node axis is not ported yet (ROADMAP queue 1 "
           "item 12)"),
          ("pod_size", "a pod axis is not ported yet (ROADMAP queue 1 "
           "item 14)"))


@dataclasses.dataclass
class ParallelCtx:
    """Axis names, sizes and communicators for one step function.

    tp_axis : tensor-parallel axis ("model"); with tp_size > 1 the ctx
              needs the rank's ``mesh`` and builds the axis's communicator
    dp_axis : data-parallel axis ("data"), likewise
    mesh    : this rank's Mesh (launch/mesh.py); None on one device
    """

    tp_axis: Optional[str] = None
    dp_axis: Optional[str] = None
    node_axis: Optional[str] = None
    pod_axis: Optional[str] = None
    tp_size: int = 1
    dp_size: int = 1
    node_size: int = 1
    pod_size: int = 1
    comm_config: CommConfig = dataclasses.field(default_factory=CommConfig)
    mesh: Optional[object] = None
    _tp_comm: Optional[FlexCommunicator] = None
    _dp_comm: Optional[FlexCommunicator] = None

    def __post_init__(self):
        for field, msg in _LATER:
            if getattr(self, field) > 1:
                raise NotImplementedError(f"ParallelCtx: {msg}")
        tp = bool(self.tp_axis) and self.tp_size > 1
        dp = bool(self.dp_axis) and self.dp_size > 1
        if (tp or dp) and self.mesh is None:
            raise ValueError("ParallelCtx: an axis wider than 1 needs the "
                             "rank's mesh")
        if tp:
            self._tp_comm = comm_init_rank(
                self.tp_axis, self.tp_size, self.comm_config,
                ortho_name=self.dp_axis if dp else None, mesh=self.mesh)
        if dp:
            self._dp_comm = comm_init_rank(
                self.dp_axis, self.dp_size, self.comm_config,
                ortho_name=self.tp_axis if tp else None, mesh=self.mesh)

    # -- plan-engine plumbing -------------------------------------------------

    def comms(self) -> Tuple[FlexCommunicator, ...]:
        """The live communicators behind this ctx (tp, then dp)."""
        return tuple(c for c in (self._tp_comm, self._dp_comm)
                     if c is not None)

    @contextlib.contextmanager
    def unrecorded(self):
        """Every communicator's :meth:`FlexCommunicator.unrecorded` scope:
        the calls inside repeat ones the step's trace already recorded."""
        with contextlib.ExitStack() as stack:
            for comm in self.comms():
                stack.enter_context(comm.unrecorded())
            yield

    # -- StepProgram registration (runtime/program.py, DESIGN.md §7) ----------

    def register_program(self, name: str) -> str:
        for comm in self.comms():
            comm.register_recorder(name)
        return name

    def unregister_program(self, name: str) -> None:
        for comm in self.comms():
            comm.unregister_recorder(name)

    @contextlib.contextmanager
    def recording(self, name: str):
        """Route every collective called inside to ``name``'s recorders."""
        with contextlib.ExitStack() as stack:
            for comm in self.comms():
                stack.enter_context(comm.recording(comm.recorder(name),
                                                   name=name))
            yield

    def await_all(self, tree=None):
        """Close the communicators' issue windows; returns ``tree``."""
        for comm in self.comms():
            comm.await_barrier()
        return tree

    def observe_program(self, name: str,
                        elapsed_s: Optional[float] = None) -> bool:
        """Stage-2 feedback from ONE program's replay logs; True when any
        share moved (the program's next signature lookup re-keys)."""
        changed = False
        for comm in self.comms():
            changed |= comm.observe_recorders(comm.family_recorders(name),
                                              elapsed_s=elapsed_s)
        return changed

    def timing_kind(self) -> str:
        """"measured" if any communicator balances on wall-clock steps,
        else "sim" ("none" without live communicators)."""
        kinds = {c.timing.kind for c in self.comms()}
        if "measured" in kinds:
            return "measured"
        return "sim" if kinds else "none"

    def save_tuning_profile(self, path: Optional[str] = None) -> int:
        """Persist every communicator's converged Stage-1 shares to the
        warm-start cache; returns the entries recorded."""
        return sum(c.save_tuning(path) for c in self.comms())

    def tuning_status(self) -> Dict[str, Dict[str, object]]:
        return {c.axis_name: c.tuning_status() for c in self.comms()}

    def plan_signature(self, program: Optional[str] = None) -> Tuple:
        """Frozen tuple of the communicators' current quantized plans — the
        StepProgram executable-cache key (restricted to ``program``'s
        footprint when given)."""
        sigs = []
        for c in self.comms():
            touched = c.family_footprint(program) if program else None
            sigs.append((c.axis_name, c.plan_signature(touched)))
        return tuple(sigs)

    def comm_report(self) -> Dict[str, object]:
        return {c.axis_name: c.report() for c in self.comms()}

    def ef_codec_name(self, payload_dtype: str = "float32") -> str:
        """The wire codec the comm config enables that loses bits for
        ``payload_dtype`` gradient payloads ("" when compression is off or
        exact for that dtype): whether error-feedback residuals exist."""
        from repro_torch.core.codecs import lossy_codec_name
        return lossy_codec_name(self.comm_config.compress, payload_dtype)

    def ef_active_for(self, nbytes: int, dtype, expert: bool = False) -> bool:
        """Does the reduce of one gradient bucket of ``nbytes`` traverse a
        wire codec that loses bits for ``dtype``?  Queries the codec
        choice of the slot the data-axis all-reduce uses; expert grads
        never cross a codec."""
        from repro_torch.core.codecs import get_codec
        from repro_torch.core.communicator import bucket_for
        from repro_torch.core.topology import Collective
        if expert or self._dp_comm is None:
            return False
        name = str(dtype).removeprefix("torch.")
        slot = self._dp_comm.slot(Collective.ALL_REDUCE, bucket_for(nbytes))
        return any(not get_codec(c).lossless_for(name)
                   for c in slot.codecs.values())

    # -- tensor-parallel collectives (identity without a tensor axis) ---------

    def tp_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self._tp_comm is None:
            return x
        return self._tp_comm.all_reduce(x)

    def tp_all_gather(self, x: torch.Tensor, tiled: bool = True
                      ) -> torch.Tensor:
        if self._tp_comm is None:
            return x
        return self._tp_comm.all_gather(x, tiled=tiled)

    def tp_reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        if self._tp_comm is None:
            return x
        return self._tp_comm.reduce_scatter(x)

    # small latency-bound reductions (softmax stats) stay on the primary
    # group, as the reference's plain lax.psum / lax.pmax
    def tp_psum_small(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_axis is None or self.tp_size <= 1:
            return x
        return self.mesh.psum(x, self.tp_axis)

    def tp_pmax_small(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the model axis of a value that carries no gradient
        (the reference applies it to a ``stop_gradient``)."""
        if self.tp_axis is None or self.tp_size <= 1:
            return x
        return self.mesh.all_reduce(x.detach(), self.tp_axis, op="max")

    def tp_index(self) -> int:
        """This rank's coordinate on the model axis."""
        if self.tp_axis is None or self.tp_size <= 1:
            return 0
        return self.mesh.axis_index(self.tp_axis)

    # -- data-parallel collectives --------------------------------------------

    def grad_all_reduce(self, grads):
        """Sum every tensor of the ``grads`` tree over the data axis through
        the FlexLink communicator (the identity on one device); a data
        axis without a communicator takes the mesh's plain all-reduce."""
        if self._dp_comm is not None:
            return pytree.tree_map(self._dp_comm.all_reduce, grads)
        if self.dp_axis and self.dp_size > 1:
            return pytree.tree_map(
                lambda g: self.mesh.all_reduce(g, self.dp_axis), grads)
        return grads

    def metrics_reduce(self, sums: Dict[str, torch.Tensor],
                       means: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
        """ONE small all-reduce of every step metric stacked in a float32
        vector over the data axis: ``sums`` come back summed over the
        ranks (the loss, pre-scaled per rank), ``means`` divided by the
        rank count (values replicated after the gradient sync).  Without
        a data axis the inputs pass through."""
        means = means or {}
        if not (self.dp_axis and self.dp_size > 1):
            return {**sums, **means}
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=self.mesh.device
                                            ).reshape(())
                            for v in list(sums.values())
                            + list(means.values())])
        red = self.mesh.all_reduce(vals, self.dp_axis)
        out = {k: red[i] for i, k in enumerate(sums)}
        for j, k in enumerate(means):
            out[k] = red[len(sums) + j] / self.dp_size
        return out

    # -- sizing helpers --------------------------------------------------------

    def shard(self, n: int, what: str = "dim") -> int:
        assert n % max(self.tp_size, 1) == 0, \
            f"{what}={n} not divisible by tp={self.tp_size}"
        return n // max(self.tp_size, 1)


def single_device_ctx() -> ParallelCtx:
    return ParallelCtx()
