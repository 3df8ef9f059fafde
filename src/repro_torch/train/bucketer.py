"""GradBucketer — size-targeted, reverse-ordered gradient buckets
(DESIGN.md §11).

Port of ``src/repro/train/bucketer.py``.  The monolithic ``sync_grads``
fires one reduce per parameter leaf after the full backward pass, so the
wire idles during compute and compute idles during sync.  Bucketing
partitions the gradient tree into ``bucket_mb``-sized slabs, each issued
as ONE RoutePlan (a single flat concatenated payload) inside its own
``ctx.issue(tag)`` scope, in *reverse* leaf order: the backward produces
the last leaves' gradients first.

Packing rules (the reference's):
  * pieces are whole leaves, or axis-0 row slabs of leaves bigger than
    the target — for stacked ``[L, ...]`` parameters that is per-layer
    granularity, taken from the END of the stack first;
  * buckets are dtype-homogeneous (pieces concatenate into one flat
    payload) and kind-homogeneous: ep_a2a expert grads reduce through
    ``ctx.expert_grad_reduce``, never in one plan with dense grads;
  * a piece larger than the target gets a bucket of its own.

Leaf order is JAX's: dicts flatten by SORTED key (``torch.utils._pytree``
keeps insertion order, and ``init_params`` inserts ``embed, final_norm,
lm_head, layers``), so a tree built by the port and the same tree
converted from the reference give the reference's buckets, tags and
plans.  Results come back in the caller's own structure.

The reference's XLA scheduler overlaps its buckets with the backward.
Eagerly, a bucket overlaps only if it is launched from the backward:
:class:`BucketSync` takes each leaf's gradient the moment it is complete
(``ready``, called by the train step's tensor hooks, or by :meth:`sync`
after the backward) and issues bucket k once its pieces are all ready
and buckets 0..k-1 are issued, so the issue order, tags, plans and
recorders are those of the reference's post-backward loop either way.
Each bucket's concatenation, error feedback, reduce and the copy of
each slab of a split leaf into that leaf's place run inside its issue
scope — on the ctx's side stream on a card — and the caller joins them
with ``ctx.await_all`` before it reads the result.

Bucketed and monolithic sync are bit-exact on inputs whose sums every
order rounds alike: the reduce is elementwise over the same ranks, and
concatenation and slicing only re-address elements.

Error feedback (DESIGN.md §12): with a LOSSY wire codec, each bucket sends
gradient + residual and keeps the local encode/decode roundtrip's error
(``ops.wire_roundtrip``: K2 then K4 for fp8) as the next step's residual
(EF-SGD).  The roundtrip is gated PER BUCKET on the codec the bucket's
slot actually chose (``ctx.ef_active_for``); a bucket whose slots ship
exact bytes skips it and keeps a zero residual.  The reference returns a
new residual tree; the port writes the caller's in place (the optimizer
state is updated in place throughout the port), which spares a second
param-sized tree on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops


def tree_paths(tree, path: tuple = ()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) in JAX's flatten order: dicts by sorted key,
    lists and tuples by index."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, path + (i,))]
    return [(path, tree)]


def tree_rebuild(template, leaves):
    """The inverse of :func:`tree_paths`: ``leaves`` (in its order) put
    into ``template``'s structure, dict insertion order kept."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("tree_rebuild: more leaves than the template has")
    return out


def is_expert_param(path) -> bool:
    """ep_a2a expert leaves — grads already summed over the ep ranks by
    the backward all_to_all."""
    return "experts" in path


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class BucketPiece:
    """One contiguous chunk of one grad leaf.

    ``rows`` is an axis-0 ``[start, stop)`` slab for leaves split across
    buckets, or None for a whole leaf.
    """

    leaf: int                           # index into the flattened leaves
    rows: Optional[Tuple[int, int]]
    nbytes: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        if self.rows is None:
            return x
        return x[self.rows[0]:self.rows[1]]


@dataclasses.dataclass(frozen=True)
class GradBucket:
    tag: str                            # issue-scope tag: "g0", "g1", ...
    pieces: Tuple[BucketPiece, ...]
    nbytes: int
    dtype: str
    expert: bool


class GradBucketer:
    """Static bucket plan for one grad tree structure.

    Built from leaf shapes and dtypes only (meta tensors will do), so
    the same bucketer serves every step of a built step callable.
    """

    def __init__(self, grads, *, bucket_mb: float, ep: bool = False):
        if bucket_mb <= 0:
            raise ValueError("GradBucketer needs bucket_mb > 0; "
                             "bucket_mb=0 is the monolithic path")
        flat = tree_paths(grads)
        # the structure only: leaves are never kept
        self._template = tree_rebuild(grads, [None] * len(flat))
        self.n_leaves = len(flat)
        self.target_bytes = max(int(bucket_mb * 2 ** 20), 1)
        self.buckets = self._pack(flat, ep)

    def _pieces(self, flat, ep) -> List[Tuple[BucketPiece, str, bool]]:
        """(piece, dtype, expert) in issue order: reverse leaf order,
        and reverse slab order within a split leaf."""
        out: List[Tuple[BucketPiece, str, bool]] = []
        for i in reversed(range(len(flat))):
            path, g = flat[i]
            expert = ep and is_expert_param(path)
            dtype = _dtype_name(g.dtype)
            nbytes = int(g.numel()) * g.element_size()
            lead = g.shape[0] if g.ndim >= 1 else 0
            if nbytes > self.target_bytes and lead > 1:
                row_bytes = max(nbytes // lead, 1)
                per = max(self.target_bytes // row_bytes, 1)
                for start in reversed(range(0, lead, per)):
                    stop = min(start + per, lead)
                    out.append((BucketPiece(i, (start, stop),
                                            (stop - start) * row_bytes),
                                dtype, expert))
            else:
                out.append((BucketPiece(i, None, nbytes), dtype, expert))
        return out

    def _pack(self, flat, ep) -> Tuple[GradBucket, ...]:
        buckets: List[GradBucket] = []
        cur: List[BucketPiece] = []
        cur_bytes = 0
        cur_key: Optional[Tuple[str, bool]] = None

        def close():
            nonlocal cur, cur_bytes
            if cur:
                buckets.append(GradBucket(
                    tag=f"g{len(buckets)}", pieces=tuple(cur),
                    nbytes=cur_bytes, dtype=cur_key[0],
                    expert=cur_key[1]))
                cur, cur_bytes = [], 0

        for piece, dtype, expert in self._pieces(flat, ep):
            key = (dtype, expert)
            if cur and (key != cur_key
                        or cur_bytes + piece.nbytes > self.target_bytes):
                close()
            cur_key = key
            cur.append(piece)
            cur_bytes += piece.nbytes
        close()
        return tuple(buckets)

    # -- trees in the plan's leaf order ----------------------------------------

    def leaves(self, tree) -> list:
        """``tree``'s leaves in the plan's order (JAX's)."""
        out = [g for _, g in tree_paths(tree)]
        if len(out) != self.n_leaves:
            raise ValueError(
                f"tree has {len(out)} leaves but the bucket plan was built "
                f"for {self.n_leaves}")
        return out

    def unflatten(self, leaves):
        """Leaves in the plan's order -> the structure the plan was built
        from."""
        return tree_rebuild(self._template, leaves)

    # -- execution -------------------------------------------------------------

    @staticmethod
    def _ef_applies(ctx, b: GradBucket, codec: str) -> bool:
        """Does bucket ``b``'s reduce actually lose bits on the wire?  The
        codec must be lossy for the bucket's dtype AND some slot along the
        reduce must have chosen a lossy codec (``ctx.ef_active_for``); a
        ctx without that query falls back to the codec-level verdict."""
        from repro_torch.core.codecs import get_codec
        if get_codec(codec).lossless_for(b.dtype):
            return False
        probe = getattr(ctx, "ef_active_for", None)
        if probe is None:
            return True
        return bool(probe(b.nbytes, b.dtype, expert=b.expert))

    def start(self, ctx, *, residuals=None, codec: str = ""
              ) -> "BucketSync":
        """One step's sync, fed leaf by leaf (:meth:`BucketSync.ready`)."""
        return BucketSync(self, ctx, residuals=residuals, codec=codec)

    def sync(self, grads, ctx, *, residuals=None, codec: str = ""):
        """Reduce every bucket through the ctx, each inside its own
        ``ctx.issue(tag)`` scope (one RoutePlan / one Stage-2
        sub-recorder per bucket).  Returns the synced tree; the caller
        still owns the ``ctx.await_all`` barrier before it reads it.

        With a lossy wire ``codec`` and a ``residuals`` tree (same
        structure as ``grads``), returns ``(synced, new_residuals)``
        (error feedback, module docstring)."""
        run = self.start(ctx, residuals=residuals, codec=codec)
        for i, g in enumerate(self.leaves(grads)):
            run.ready(i, g)
        return run.result()

    def describe(self) -> List[dict]:
        return [{"tag": b.tag, "nbytes": b.nbytes, "dtype": b.dtype,
                 "expert": b.expert, "pieces": len(b.pieces)}
                for b in self.buckets]


class BucketSync:
    """One step's bucketed sync in flight.

    Leaves arrive by :meth:`ready` in any order; bucket k is issued the
    moment its pieces are all ready and buckets 0..k-1 are issued.  The
    object holds every gradient it was handed until it is dropped, which
    the caller does after ``ctx.await_all``: on a card the side stream
    reads them, and the caching allocator must not hand their memory out
    before that.  Under error feedback the residual tree is updated in
    place, as the optimizer updates its moments.
    """

    def __init__(self, bucketer: GradBucketer, ctx, *, residuals=None,
                 codec: str = ""):
        self._b = bucketer
        self._ctx = ctx
        self._codec = codec
        self._ef = bool(codec) and residuals is not None
        self._res = bucketer.leaves(residuals) if self._ef else None
        n = bucketer.n_leaves
        self._grads: List[Optional[torch.Tensor]] = [None] * n
        self._out: List[Optional[torch.Tensor]] = [None] * n
        # per bucket: its leaves not ready yet; per leaf: its buckets
        self._missing = [len({p.leaf for p in b.pieces})
                         for b in bucketer.buckets]
        self._buckets_of: List[List[int]] = [[] for _ in range(n)]
        for k, b in enumerate(bucketer.buckets):
            for p in b.pieces:
                if k not in self._buckets_of[p.leaf]:
                    self._buckets_of[p.leaf].append(k)
        self.issued = 0                 # buckets issued so far, in order

    def ready(self, i: int, g: torch.Tensor) -> None:
        """Leaf ``i``'s complete gradient; issues every bucket it lets go."""
        if self._grads[i] is not None:
            raise RuntimeError(f"bucketed sync: leaf {i} got a second "
                               f"gradient in one step")
        self._grads[i] = g
        for k in self._buckets_of[i]:
            self._missing[k] -= 1
        buckets = self._b.buckets
        while self.issued < len(buckets) and not self._missing[self.issued]:
            self._issue(buckets[self.issued])
            self.issued += 1

    def _issue(self, b: GradBucket) -> None:
        ctx, codec = self._ctx, self._codec
        segs = [p.take(self._grads[p.leaf]) for p in b.pieces]
        rsegs = ([p.take(self._res[p.leaf]) for p in b.pieces]
                 if self._ef else None)
        ef_b = self._ef and self._b._ef_applies(ctx, b, codec)
        with ctx.issue(b.tag):
            flat = _flat(segs)
            if ef_b:
                # EF-SGD: send grad + carried error, keep the fresh local
                # quantization error for the next step
                flat = flat + _flat(rsegs)
                err = flat - kops.wire_roundtrip(flat, codec_name=codec)
                for r, e in zip(rsegs, _slabs(err, rsegs)):
                    r.copy_(e)
            elif self._ef:
                # the slot ships exact bytes: no wire error to compensate,
                # and the carried residual must not perturb the transfer
                for r in rsegs:
                    r.zero_()
            if b.expert:
                red = ctx.expert_grad_reduce(flat)
            else:
                red = ctx.grad_all_reduce(flat)
            for p, slab in zip(b.pieces, _slabs(red, segs)):
                if p.rows is None:
                    self._out[p.leaf] = slab
                    continue
                # a split leaf: its slabs land in one tensor, made by its
                # first bucket (inside the scope: on the side stream)
                if self._out[p.leaf] is None:
                    self._out[p.leaf] = torch.empty_like(
                        self._grads[p.leaf])
                p.take(self._out[p.leaf]).copy_(slab)

    def result(self):
        """The synced tree (and the residual tree, updated in place, under
        error feedback), in the structure the plan was built from.  Raises
        if a bucket was never issued: no bucket is left to a fallback."""
        waiting = len(self._b.buckets) - self.issued
        if waiting:
            missing = [i for i, g in enumerate(self._grads) if g is None]
            raise RuntimeError(f"bucketed sync: {waiting} buckets never "
                               f"issued (leaves without a gradient: "
                               f"{missing})")
        synced = self._b.unflatten(self._out)
        if not self._ef:
            return synced
        return synced, self._b.unflatten(self._res)


def _flat(segs) -> torch.Tensor:
    """One flat payload of the pieces (the piece itself when alone)."""
    if len(segs) == 1:
        return segs[0].reshape(-1)
    return torch.cat([s.reshape(-1) for s in segs])


def _slabs(flat: torch.Tensor, like):
    """``flat`` cut back into views shaped like each of ``like``."""
    off = 0
    for x in like:
        n = x.numel()
        yield flat[off:off + n].reshape(x.shape)
        off += n
