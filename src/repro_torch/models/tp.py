"""Parallelism context — how model code reaches the communication backend.

Port of ``src/repro/models/tp.py`` for one device, a (data, model) mesh,
the (node, data, model) and (pod, node, data, model) cluster meshes and
the legacy multi-pod (pod, data, model) mesh.  Model layers call collectives
only through a ``ParallelCtx``.  On one device every collective is the
identity and there are no communicators: constant signature, no Stage-2
feedback, empty reports.
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
crosses a lossy wire codec.  :meth:`ParallelCtx.issue` scopes one
in-flight gradient bucket (train/bucketer.py): its calls land in the
program's ``name/tag`` sub-recorders and share the open issue window, and
on a card its work runs on a side stream the ctx owns, which
:meth:`ParallelCtx.join_issued` (a consumer inside the step) and
:meth:`ParallelCtx.await_all` (the step's end) join back into the current
stream.  The sequence-sharded decode (models/layers.py) issues its Q
gather the same way, from every layer of the decode stack: a scope that
``repeats`` a trace's first one runs unrecorded in the same window, where
a gradient bucket's scope refuses to.  ``dp_psum_small`` /
``dp_pmax_small`` are the data axis's plain reductions (the decode's
log-sum-exp merge over a batch-1 cache split over data x model).
The expert-parallel span of the MoE ``ep_a2a`` dispatch is the data
axis alone on a (data, model) mesh (``ep_axes``, ``ep_size``,
``ep_spec_axis``): ``ep_all_to_all`` is the data axis's flex
all_to_all, differentiable through ``routing.execute``, and
``expert_grad_reduce`` is the identity, as the reference's ``pod_psum``
without a pod axis.

A node axis wider than 1 is the cluster (DESIGN.md §9, §15): the ctx
takes (or synthesizes with ``cluster_for``, with as many pods as the pod
axis spans) the :class:`ClusterTopology`, builds the node axis's
communicator on the NIC tier's profile with the data axis (else the
model axis) as its ortho axis and, when the cluster has the pod axis's
pods, the pod axis's communicator on the pod tier's spine profile with
the node axis as its ortho axis, and composes them with the data axis's
into a :class:`~repro_torch.cluster.communicator.ClusterCommunicator`:
``grad_all_reduce`` is then the hierarchical all-reduce over every tier,
the ep span is (pod, node, data) and ``ep_all_to_all`` the rail-local
decomposition, ``metrics_reduce`` sums over the mesh's gradient plane
group, and ``comm_report`` adds the cluster's block.  On the legacy
(pod, data, model) mesh, and on a cluster without a pod tier, the pod
axis has no communicator: gradients and expert gradients take a plain
``pod_psum`` after the flex reduce, as the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.communicator import (CommConfig, FlexCommunicator,
                                           comm_init_rank)
from repro_torch.runtime import spans


@dataclasses.dataclass
class ParallelCtx:
    """Axis names, sizes and communicators for one step function.

    tp_axis : tensor-parallel axis ("model"); with tp_size > 1 the ctx
              needs the rank's ``mesh`` and builds the axis's communicator
    dp_axis : data-parallel axis ("data"), likewise
    node_axis : inter-node axis ("node"), crossing the cluster's NIC tier;
              gradient reduction becomes the hierarchical all-reduce
    pod_axis : pod axis ("pod"): on a cluster mesh with a pod tier it
              crosses the spine as its own communicator and joins the
              compositions and the ep span; on the legacy pod-only mesh
              it stays a plain psum (gradient reduction only)
    cluster : the ClusterTopology behind the node axis; synthesized from
              the comm profile (``cluster_for``) when left None
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
    cluster: Optional[object] = None      # ClusterTopology
    mesh: Optional[object] = None
    #: the FabricClock driving live health transitions (repro_torch.faults,
    #: DESIGN.md §14) — set by ``FabricClock.attach``; None on the
    #: fault-free (byte-identical) path.
    fault_clock: Optional[object] = None
    _tp_comm: Optional[FlexCommunicator] = None
    _dp_comm: Optional[FlexCommunicator] = None
    _node_comm: Optional[FlexCommunicator] = None
    _pod_comm: Optional[FlexCommunicator] = None
    _cluster_comm: Optional[object] = None  # ClusterCommunicator
    #: the stream issue scopes run on (a CUDA ctx with live
    #: communicators; made by the first scope)
    side_stream: Optional[torch.cuda.Stream] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        tp = bool(self.tp_axis) and self.tp_size > 1
        dp = bool(self.dp_axis) and self.dp_size > 1
        node = bool(self.node_axis) and self.node_size > 1
        pod = bool(self.pod_axis) and self.pod_size > 1
        want_pods = self.pod_size if pod else 1
        if node:
            self._check_cluster(want_pods)
        if (tp or dp or node or pod) and self.mesh is None:
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
        if node:
            self._init_cluster(dp, tp, want_pods)

    def _check_cluster(self, want_pods: int) -> None:
        """Synthesize the node axis's cluster when none is given, and
        refuse one that does not fit the mesh or the comm profile."""
        from repro_torch.cluster.topology import cluster_for
        if self.cluster is None:
            self.cluster = cluster_for(self.comm_config.profile,
                                       self.node_size, pods=want_pods)
        if self.cluster.n_nodes != self.node_size:
            raise ValueError(
                f"cluster {self.cluster.name!r} has "
                f"{self.cluster.n_nodes} nodes but the mesh's node "
                f"axis spans {self.node_size}")
        if self.cluster.node.name != self.comm_config.profile:
            raise ValueError(
                f"cluster {self.cluster.name!r} is built from "
                f"{self.cluster.node.name!r} nodes but the comm "
                f"profile is {self.comm_config.profile!r} — reports, "
                f"timing constants and warm-start keys would describe "
                f"a fabric that never ran")
        if self.cluster.n_pods > 1 and self.cluster.n_pods != want_pods:
            raise ValueError(
                f"cluster {self.cluster.name!r} has "
                f"{self.cluster.n_pods} pods but the mesh's pod axis "
                f"spans {want_pods}")

    def _init_cluster(self, dp: bool, tp: bool, want_pods: int) -> None:
        """The node tier's communicator, the pod tier's when the cluster
        has the pod axis's pods, and the cluster's composition (reference
        tp.py:113-148)."""
        from repro_torch.cluster.communicator import ClusterCommunicator
        # the NIC tier is its own communicator: same CommConfig knobs, the
        # tier profile's link pool, so its SlotControllers balance the
        # inter tier independently of the intra fabric
        inter_cfg = dataclasses.replace(
            self.comm_config, profile=self.cluster.nic_tier.name)
        ortho = self.dp_axis if dp else (self.tp_axis if tp else None)
        self._node_comm = comm_init_rank(
            self.node_axis, self.node_size, inter_cfg, ortho_name=ortho,
            mesh=self.mesh)
        if want_pods > 1 and self.cluster.n_pods == want_pods:
            # the spine tier is its own communicator too: same knobs, the
            # pod tier profile's link pool, so it tunes, drains,
            # compresses and re-keys like the tiers below it
            pod_cfg = dataclasses.replace(
                self.comm_config, profile=self.cluster.pod_tier.name)
            self._pod_comm = comm_init_rank(
                self.pod_axis, self.pod_size, pod_cfg,
                ortho_name=self.node_axis, mesh=self.mesh)
        self._cluster_comm = ClusterCommunicator(
            self.cluster, self._dp_comm, self._node_comm, self._pod_comm)

    # -- plan-engine plumbing -------------------------------------------------

    def comms(self) -> Tuple[FlexCommunicator, ...]:
        """The live communicators behind this ctx (tp, dp, then the
        cluster's NIC tier, then its pod tier)."""
        return tuple(c for c in (self._tp_comm, self._dp_comm,
                                 self._node_comm, self._pod_comm)
                     if c is not None)

    def observe_executed_step(self) -> bool:
        """Stage-2 feedback from every communicator's default recorder
        (direct use of the data plane, outside a StepProgram, which uses
        :meth:`observe_program`); True when any balancer moved a share
        (the reference's ``ParallelCtx.observe_executed_step``,
        tp.py:151)."""
        changed = False
        for comm in self.comms():
            changed |= comm.observe_executed_step()
        return changed

    def reset_issued(self) -> None:
        """Clear every communicator's issued-call replay log (the
        reference's ``ParallelCtx.reset_issued``, tp.py:331).  The log is
        shared by every ctx on the same memoized communicator, so this is
        for explicit isolation only."""
        for comm in self.comms():
            comm.reset_issued()

    @contextlib.contextmanager
    def unrecorded(self):
        """Every communicator's :meth:`FlexCommunicator.unrecorded` scope,
        and the mesh's :meth:`~repro_torch.launch.mesh.Mesh.untraced`: the
        calls inside repeat ones the step's trace already recorded."""
        with contextlib.ExitStack() as stack:
            for comm in self.comms():
                stack.enter_context(comm.unrecorded())
            if self.mesh is not None:
                stack.enter_context(self.mesh.untraced())
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

    # -- issue/await overlap scopes (DESIGN.md §11) ----------------------------

    @contextlib.contextmanager
    def issue(self, tag: str, repeats: bool = False):
        """Mark the collectives called inside as ONE in-flight plan.

        Their replay records land in the active program's ``name/tag``
        sub-recorder and join the open issue window on every
        communicator; all plans issued before the next :meth:`await_all`
        share the window.  On a card the scope's work runs on
        :attr:`side_stream`, which first waits for the current stream (the
        producer of what the scope reads); a consumer reads its results
        after :meth:`join_issued`.  Every rank must issue the same scopes
        in the same order.  A ctx without live communicators no-ops.

        Inside :meth:`unrecorded` a scope is refused unless ``repeats``
        says it repeats one the step already issued (a decode stack's
        layers >= 1, the reference's one scope a ``lax.scan`` trace): its
        calls then run unrecorded, in the same window.  A gradient
        bucket's scope never repeats, and an unrecorded one would be a
        lost record."""
        comms = self.comms()
        if not repeats and any(c.suppressed for c in comms):
            raise RuntimeError(f"issue({tag!r}) inside unrecorded(): a "
                               f"gradient bucket issued from a repeated "
                               f"call would go unrecorded")
        with contextlib.ExitStack() as stack:
            stack.enter_context(spans.span("sync.bucket", tag))
            for comm in comms:
                stack.enter_context(comm.issue_scope(tag))
            if comms and self.mesh.device.type == "cuda":
                if self.side_stream is None:
                    self.side_stream = torch.cuda.Stream(self.mesh.device)
                self.side_stream.wait_stream(
                    torch.cuda.current_stream(self.mesh.device))
                stack.enter_context(torch.cuda.stream(self.side_stream))
            yield

    def join_issued(self, tree):
        """The current stream waits for the side stream's work so far, and
        the CUDA tensors of ``tree`` (made there) are marked as used by the
        current stream, so the caching allocator keeps them until its work
        is done; the issue windows stay open.  Returns ``tree``."""
        side = self.side_stream
        if side is not None:
            cur = torch.cuda.current_stream(side.device)
            cur.wait_stream(side)
            for t in pytree.tree_leaves(tree):
                if torch.is_tensor(t) and t.is_cuda:
                    t.record_stream(cur)
        return tree

    def await_all(self, tree=None):
        """Barrier for every issued plan: :meth:`join_issued` on ``tree``,
        then the communicators' open issue windows close.  Returns
        ``tree``."""
        self.join_issued(tree)
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
        """Per-axis communicator reports; a cluster ctx adds the cluster's
        topology, cross-tier rollup and a2a block under ``"cluster"``, and
        a ctx with a fault clock its report under ``"faults"``."""
        out: Dict[str, object] = {c.axis_name: c.report()
                                  for c in self.comms()}
        if self._cluster_comm is not None:
            out["cluster"] = self._cluster_comm.summary()
        if self.fault_clock is not None:
            out["faults"] = self.fault_clock.report()
        return out

    def apply_health_state(self, degrades) -> Dict[str, object]:
        """Broadcast one committed fabric state to every live
        communicator (FabricClock's commit hook); returns the per-axis
        transition records of the ones that actually changed."""
        out: Dict[str, object] = {}
        for comm in self.comms():
            info = comm.apply_health_state(degrades)
            if info:
                out[comm.axis_name] = info
        return out

    def ef_codec_name(self, payload_dtype: str = "float32") -> str:
        """The wire codec the comm config enables that loses bits for
        ``payload_dtype`` gradient payloads ("" when compression is off or
        exact for that dtype): whether error-feedback residuals exist."""
        from repro_torch.core.codecs import lossy_codec_name
        return lossy_codec_name(self.comm_config.compress, payload_dtype)

    def ef_active_for(self, nbytes: int, dtype, expert: bool = False) -> bool:
        """Does the reduce of one gradient bucket of ``nbytes`` traverse a
        wire codec that loses bits for ``dtype``?  Queries the codec
        choice of every slot the reduce crosses: the data-axis all-reduce,
        or on a cluster each leg of the hierarchical one; expert grads
        never cross a codec."""
        from repro_torch.core.codecs import get_codec
        from repro_torch.core.communicator import bucket_for
        from repro_torch.core.topology import Collective
        legs = []   # (communicator, collective, payload bytes) traversed
        if expert:
            pass
        elif self._cluster_comm is not None:
            tiers = self._cluster_comm.comms()
            if len(tiers) > 1:
                nb = nbytes
                for t in tiers[:-1]:
                    legs.append((t, Collective.REDUCE_SCATTER, nb))
                    nb = max(nb // t.n_ranks, 1)
                legs.append((tiers[-1], Collective.ALL_REDUCE, nb))
                for t in reversed(tiers[:-1]):
                    legs.append((t, Collective.ALL_GATHER, nb))
                    nb *= t.n_ranks
            else:
                legs = [(c, Collective.ALL_REDUCE, nbytes) for c in tiers]
        elif self._dp_comm is not None:
            legs.append((self._dp_comm, Collective.ALL_REDUCE, nbytes))
        name = str(dtype).removeprefix("torch.")
        return any(not get_codec(c).lossless_for(name)
                   for comm, op, n in legs
                   for c in comm.slot(op, bucket_for(n)).codecs.values())

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
        """Sum every tensor of the ``grads`` tree over the data, node and
        pod axes (the identity on one device): with a node axis the
        cluster's hierarchical all-reduce (one RoutePlan a leg, the pod
        tier's too when it has a communicator), else the data axis's flex
        all-reduce (a data axis without a communicator takes the mesh's
        plain all-reduce); a pod axis without a communicator (the legacy
        pod-only mesh) then takes a plain ``pod_psum``."""
        if self.mesh is None:
            return grads

        def red(g):
            if self._cluster_comm is not None:
                g = self._cluster_comm.all_reduce(g)
                return g if self._pod_comm is not None else self.pod_psum(g)
            if self._dp_comm is not None:
                g = self._dp_comm.all_reduce(g)
            elif self.dp_axis and self.dp_size > 1:
                g = self.mesh.all_reduce(g, self.dp_axis)
            return self.pod_psum(g)
        return pytree.tree_map(red, grads)

    def dp_all_to_all(self, x: torch.Tensor, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
        if self._dp_comm is None:
            return x
        return self._dp_comm.all_to_all(x, split_axis, concat_axis)

    def dp_index(self) -> int:
        """This rank's coordinate on the data axis."""
        if self.dp_axis is None or self.dp_size <= 1:
            return 0
        return self.mesh.axis_index(self.dp_axis)

    # small latency-bound reductions over the data axis (the batch-1
    # decode's softmax statistics), on the primary group as the tp ones
    def dp_psum_small(self, x: torch.Tensor) -> torch.Tensor:
        if self.dp_axis is None or self.dp_size <= 1:
            return x
        return self.mesh.psum(x, self.dp_axis)

    def dp_pmax_small(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the data axis of a value that carries no gradient."""
        if self.dp_axis is None or self.dp_size <= 1:
            return x
        return self.mesh.all_reduce(x.detach(), self.dp_axis, op="max")

    # -- node-axis (NIC tier) collectives --------------------------------------

    def node_psum(self, x: torch.Tensor) -> torch.Tensor:
        """Plain node-axis reduction on the mesh's primary group (small
        latency-bound payloads)."""
        if self.node_axis is None or self.node_size <= 1:
            return x
        return self.mesh.psum(x, self.node_axis)

    def node_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Bandwidth-bound node-axis reduction through the NIC tier's flex
        communicator (rail / xrail / host_tcp pool) when one is live."""
        if self._node_comm is None:
            return self.node_psum(x)
        return self._node_comm.all_reduce(x)

    def node_index(self) -> int:
        """This rank's coordinate on the node axis."""
        if self.node_axis is None or self.node_size <= 1:
            return 0
        return self.mesh.axis_index(self.node_axis)

    # -- pod-axis collectives --------------------------------------------------

    def pod_psum(self, x: torch.Tensor) -> torch.Tensor:
        """Plain pod-axis reduction on the mesh's primary group: the
        legacy pod-only mesh's, where the pod tier has no link pool; on a
        three-tier cluster the pod axis rides its own communicator."""
        if self.pod_axis is None or self.pod_size <= 1:
            return x
        return self.mesh.psum(x, self.pod_axis)

    def pod_index(self) -> int:
        """This rank's coordinate on the pod axis."""
        if self.pod_axis is None or self.pod_size <= 1:
            return 0
        return self.mesh.axis_index(self.pod_axis)

    # -- expert-parallel span (MoE ep_a2a dispatch, DESIGN.md §15) ------------

    @property
    def ep_axes(self) -> Tuple[str, ...]:
        """Mesh axes the expert dimension shards over, outermost first:
        (pod, node, data) on a cluster mesh, the tiers the cluster
        composes, so ``ep_all_to_all`` and the expert specs agree on the
        combined rank order."""
        axes = []
        if self._pod_comm is not None:
            axes.append(self.pod_axis)
        if self._node_comm is not None:
            axes.append(self.node_axis)
        if self.dp_axis and self.dp_size > 1:
            axes.append(self.dp_axis)
        return tuple(axes)

    @property
    def ep_size(self) -> int:
        """Expert-parallel ways: the product of the ep axes' sizes."""
        sizes = {self.pod_axis: self.pod_size, self.node_axis:
                 self.node_size, self.dp_axis: self.dp_size}
        s = 1
        for a in self.ep_axes:
            s *= sizes[a]
        return s

    def ep_index(self) -> int:
        """This rank's combined index on the ep span, outermost-major:
        ``(pod * n + node) * dp + data`` on a three-tier mesh."""
        g = 0
        for a in self.ep_axes:
            g = g * self.mesh.axis_size(a) + self.mesh.axis_index(a)
        return g

    def ep_spec_axis(self):
        """The expert-dim entry of ``param_specs``: None, an axis name, or
        the outermost-major axis tuple."""
        axes = self.ep_axes
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    def ep_all_to_all(self, x: torch.Tensor, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
        """Expert-dispatch all_to_all over the ep span: the flat data-axis
        flex all_to_all on a single-node mesh; on a cluster mesh the
        rail-local decomposition of ``ClusterCommunicator.ep_all_to_all``
        (intra shuffle, rail-aligned NIC leg, spine leg)."""
        if self._cluster_comm is not None:
            return self._cluster_comm.ep_all_to_all(x, split_axis,
                                                    concat_axis)
        return self.dp_all_to_all(x, split_axis, concat_axis)

    def expert_grad_reduce(self, g: torch.Tensor) -> torch.Tensor:
        """Reduce one ep_a2a expert grad over the gradient axes outside
        the expert-parallel span: the backward all_to_all already summed
        it over every ep tier (data, plus node and pod when their
        communicators are live), so only a pod axis without a
        communicator is left, a plain ``pod_psum``."""
        if self._pod_comm is None:
            return self.pod_psum(g)
        return g

    def metrics_reduce(self, sums: Dict[str, torch.Tensor],
                       means: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
        """ONE small all-reduce of every step metric stacked in a float32
        vector over the gradient axes wider than 1 (pod, node, data; all
        at once on the mesh's gradient plane group): ``sums`` come back
        summed over the ranks (the loss, pre-scaled per rank), ``means``
        divided by the rank count (values replicated after the gradient
        sync).  Without such an axis the inputs pass through."""
        means = means or {}
        present = tuple(a for a, n in ((self.pod_axis, self.pod_size),
                                       (self.node_axis, self.node_size),
                                       (self.dp_axis, self.dp_size))
                        if a and n > 1)
        if not present:
            return {**sums, **means}
        # on the mesh's device, or meta for a lowered step
        dev = next((v.device for v in sums.values()
                    if torch.is_tensor(v) and v.device.type == "meta"),
                   self.mesh.device)
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=dev).reshape(())
                            for v in list(sums.values())
                            + list(means.values())])
        axis = present if len(present) > 1 else present[0]
        red = self.mesh.all_reduce(vals, axis)
        n_ranks = self.mesh.axis_size(axis)
        out = {k: red[i] for i, k in enumerate(sums)}
        for j, k in enumerate(means):
            out[k] = red[len(sums) + j] / n_ranks
        return out

    # -- sizing helpers --------------------------------------------------------

    def shard(self, n: int, what: str = "dim") -> int:
        assert n % max(self.tp_size, 1) == 0, \
            f"{what}={n} not divisible by tp={self.tp_size}"
        return n // max(self.tp_size, 1)


def single_device_ctx() -> ParallelCtx:
    return ParallelCtx()
