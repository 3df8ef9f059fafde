"""Path primitives + payload partitioning — FlexLink's data plane, on torch
process groups.

Port of ``src/repro/core/collectives.py``.  The reference's primitives run
inside ``shard_map`` and name a mesh axis; here every rank is a process
and each primitive takes the rank's :class:`~repro_torch.launch.mesh.Mesh`
and an axis name.  ``lax.psum`` / ``all_gather`` / ``psum_scatter`` /
``all_to_all`` become the mesh's collectives on the axis's primary process
group; ``lax.ppermute`` becomes :meth:`Mesh.permute` (one
``batch_isend_irecv`` per ring step) on its staged group.  Routing across
primitives lives in ``routing.py``, which also holds the ``flex_*``
entry points.

The three route classes (DESIGN.md §3):

  primary : the native collective on the axis's process group.
  staged  : the explicit chunk-pipelined point-to-point ring on a second
            process group over the same ranks, with an explicit per-step
            reduce (K1 ``chunk_accumulate``, injected by routing).
            ``substeps > 1`` splits the segment into sub-chunks whose
            per-step transfers are all posted before any reduce; the
            reduce of a step's sub-chunks is then one call (one K1
            launch on CUDA) into one buffer.
  ortho   : neighbour-row detour over an orthogonal mesh axis: permute the
            share one hop along it, run the primary collective on the
            neighbour row, permute back.

The ring schedules are the reference's, step for step (the reduce-scatter
starts at chunk idx-1 and step s reduces chunk idx-s-2) and the
accumulate rounds to the payload dtype after every step, so a staged-only
plan gives the reference's bits on floating payloads too.  The primary
path's sums run in gloo's or NCCL's order, not XLA's, so mixed plans agree
with the reference exactly only on payloads whose sums are exact (small
integers, DESIGN.md §9).

Wire codecs (``codec=``, DESIGN.md §12) compress the secondary routes'
hops: encode (K2 fp8, or K5 bf16 pack) -> permute the wire payload ->
decode, with the fp8 decode fused into the staged reduce (K3) and the
bf16 pack's decode being K1 itself.  The fp8 values cross the wire as
uint8 and their float32 scales ride the same point-to-point batch.  The
compressed all-gather encodes each row ONCE at its source and forwards
the payload unchanged; every rank decodes every row, its own included,
so the gathered rows are equal on every rank.  The primitives here are
forward only; ``routing.execute`` differentiates a whole plan instead,
its backward running the transpose collective over the same routes with
the codecs stripped.  That is the reference's straight-through VJPs
(collectives.py:198, 227, 272) taken at the plan level.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops

#: payload partition granularity (chunks); shares in grid units are mapped
#: onto this chunk grid.
CHUNK_GRID = 16

PATH_PRIMARY = "primary"
PATH_STAGED = "staged"
PATH_ORTHO = "ortho"
PATH_ORDER = (PATH_PRIMARY, PATH_STAGED, PATH_ORTHO)


# ---------------------------------------------------------------------------
# payload partitioning
# ---------------------------------------------------------------------------

def quantize_shares(shares: Mapping[str, int], order: Sequence[str],
                    grid: int = CHUNK_GRID) -> Dict[str, int]:
    """Map SHARE_GRID-unit shares onto the CHUNK_GRID, preserving the total.

    Largest-remainder rounding; paths with a nonzero share keep at least one
    chunk only if rounding leaves room (a <1/grid share legitimately rounds
    to zero — the tuner treats that as path deactivation).
    """
    total = sum(shares.get(p, 0) for p in order)
    if total <= 0:
        raise ValueError("shares must sum to a positive total")
    raw = {p: shares.get(p, 0) * grid / total for p in order}
    out = {p: int(raw[p]) for p in order}
    rem = grid - sum(out.values())
    by_frac = sorted(order, key=lambda p: raw[p] - out[p], reverse=True)
    for p in by_frac[:rem]:
        out[p] += 1
    return out


def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def _flatten_pad(x: torch.Tensor, grid: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % grid
    return _pad_last(flat, pad), pad


def partition_payload(x: torch.Tensor, chunk_units: Mapping[str, int],
                      order: Sequence[str], grid: int = CHUNK_GRID
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Split a tensor into per-path flat segments of `units/grid` each."""
    flat, pad = _flatten_pad(x, grid)
    unit = flat.shape[0] // grid
    segs: Dict[str, torch.Tensor] = {}
    off = 0
    for p in order:
        u = chunk_units.get(p, 0)
        if u > 0:
            segs[p] = flat[off * unit:(off + u) * unit]
        off += u
    return segs, pad


def merge_payload(segs: Mapping[str, torch.Tensor], order: Sequence[str],
                  pad: int, shape: Tuple[int, ...], dtype) -> torch.Tensor:
    """Inverse of partition_payload."""
    parts = [segs[p] for p in order if p in segs]
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    if pad:
        flat = flat[: flat.shape[0] - pad]
    return flat.reshape(shape).to(dtype)


def partition_columns(x2d: torch.Tensor, chunk_units: Mapping[str, int],
                      order: Sequence[str], grid: int = CHUNK_GRID
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Split a [lead, F] matrix into per-path column groups.

    Used by collectives whose per-rank structure lives on the leading axis
    (reduce_scatter, all_to_all): every path's segment keeps the full leading
    dim, so each sub-collective preserves the rank-chunk layout.
    Returns ({path: [lead, F_p]}, col_pad).
    """
    f = x2d.shape[1]
    pad = (-f) % grid
    x2d = _pad_last(x2d, pad)
    unit = (f + pad) // grid
    segs: Dict[str, torch.Tensor] = {}
    off = 0
    for p in order:
        u = chunk_units.get(p, 0)
        if u > 0:
            segs[p] = x2d[:, off * unit:(off + u) * unit]
        off += u
    return segs, pad


def merge_columns(segs: Mapping[str, torch.Tensor], order: Sequence[str],
                  pad: int) -> torch.Tensor:
    parts = [segs[p] for p in order if p in segs]
    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if pad:
        out = out[:, : out.shape[1] - pad]
    return out


# ---------------------------------------------------------------------------
# wire-codec composites (DESIGN.md §12)
# ---------------------------------------------------------------------------

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _permute_wire(mesh, payloads, axis: str, send_to: int, recv_from: int):
    """One permute step for wire payloads ``[(values, scales or None)]``:
    every tensor of every payload is posted in one point-to-point batch,
    fp8 values as uint8 (the wire has no fp8 type)."""
    tensors = []
    for vals, scales in payloads:
        tensors.append(vals.view(torch.uint8) if vals.dtype in _FP8
                       else vals)
        if scales is not None:
            tensors.append(scales)
    got = iter(mesh.permute(tensors, axis, send_to, recv_from))
    return [(next(got).view(vals.dtype),
             None if scales is None else next(got))
            for vals, scales in payloads]


def _codec_permute(x: torch.Tensor, mesh, axis: str, send_to: int,
                   recv_from: int, codec: str) -> torch.Tensor:
    """Permute ``x`` through the wire codec: the encoded values (and
    scales) cross the link; the receiver decodes to x's shape/dtype."""
    payload = kops.wire_encode(x, codec_name=codec)
    ((vals, scales),) = _permute_wire(mesh, [payload], axis, send_to,
                                      recv_from)
    return kops.wire_decode(vals, scales, codec_name=codec, shape=x.shape,
                            dtype=x.dtype)


def _codec_permute_accumulate(curs, mines, mesh, axis: str, send_to: int,
                              recv_from: int, codec: str):
    """One compressed ring-reduce step for every sub-chunk at once: each
    running partial crosses the link encoded, and the receiver decodes it
    and accumulates its local chunk in one fused kernel (float32
    accumulation, rounded to the local chunk's dtype).  The bf16 pack
    encodes, and decode-accumulates, all sub-chunks in one launch each."""
    payloads = kops.wire_encode_many(curs, codec_name=codec)
    moved = _permute_wire(mesh, payloads, axis, send_to, recv_from)
    return kops.wire_decode_accumulate_many(moved, mines, codec_name=codec)


# ---------------------------------------------------------------------------
# staged-path primitives: chunk-pipelined point-to-point rings
# ---------------------------------------------------------------------------

def _split_subchunks(flat: torch.Tensor, substeps: int
                     ) -> Tuple[List[torch.Tensor], int, int]:
    """Split a payload into `substeps` equal sub-chunks along its last dim
    (pad as needed): the pipeline's in-flight units."""
    m = flat.shape[-1]
    s = max(1, min(int(substeps), max(m, 1)))
    pad = (-m) % s
    flat = _pad_last(flat, pad)
    w = flat.shape[-1] // s
    return [flat[..., j * w:(j + 1) * w] for j in range(s)], pad, s


def _concat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 1-D results of a ring step laid end to end.  When they are the
    views a list form cut in order from one buffer, that buffer (no
    copy)."""
    base = parts[0]._base
    if base is not None and base.dim() == 1 and \
            base.numel() == sum(p.numel() for p in parts):
        off = base.storage_offset()
        for p in parts:
            if p._base is not base or p.storage_offset() != off:
                break
            off += p.numel()
        else:
            return base
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _by_rank(stacked: torch.Tensor, idx: int, n: int) -> torch.Tensor:
    """Entry k of ``stacked`` holds rank (idx - k) % n; reorder so entry j
    holds rank j."""
    return stacked[[(idx - j) % n for j in range(n)]]


def ring_all_gather(x: torch.Tensor, mesh, axis: str, *,
                    substeps: int = 1, codec: str = "") -> torch.Tensor:
    """All-gather via N-1 permute steps; result ordered by rank like
    ``lax.all_gather(x, axis, tiled=False)`` (leading axis = rank).
    ``substeps > 1`` forwards sub-chunks independently each step (pure data
    movement: bit-identical for any substeps).  ``codec`` encodes each
    sub-chunk once at its source and forwards the wire payload unchanged;
    every rank decodes every row, its own included."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    subs, pad, s = _split_subchunks(x.reshape(-1), substeps)
    if codec:
        curs = kops.wire_encode_many(subs, codec_name=codec)
        send = functools.partial(_permute_wire, mesh)
    else:
        curs = list(subs)
        send = mesh.permute
    collected = [[c] for c in curs]
    for _ in range(n - 1):
        # every sub-chunk's transfer of this ring step is posted at once
        curs = send(curs, axis, idx + 1, idx - 1)
        for j in range(s):
            collected[j].append(curs[j])
    if codec:
        collected = [[kops.wire_decode(v, sc, codec_name=codec,
                                       shape=sub.shape, dtype=sub.dtype)
                      for v, sc in col]
                     for col, sub in zip(collected, subs)]
    rows = torch.cat([torch.stack(c) for c in collected], dim=1)
    rows = _by_rank(rows, idx, n)
    if pad:
        rows = rows[:, :-pad]
    return rows.reshape((n,) + tuple(x.shape))


def ring_reduce_scatter(x: torch.Tensor, mesh, axis: str, accumulate=None,
                        *, substeps: int = 1, codec: str = "") -> torch.Tensor:
    """Reduce-scatter via the classic N-1 step ring, chunk-pipelined.

    `x` has leading dim divisible by N; returns this rank's reduced chunk.
    `accumulate(a, b)` is the per-step reduce — ``a + b`` when None; the
    routing layer injects K1 ``chunk_accumulate`` for sub-32-bit floats,
    whose ``many`` list form reduces all sub-chunks of a step in one call
    (a caller's own accumulate runs sub-chunk by sub-chunk).
    ``codec`` sends each running partial encoded and replaces the
    accumulate with the fused decode-accumulate: the local chunks still
    enter at full precision, only the partials in flight are quantized.
    """
    if accumulate is None:
        accumulate = lambda a, b: a + b  # noqa: E731
    step_reduce = getattr(accumulate, "many", None) or (
        lambda rs, ms: [accumulate(r, m) for r, m in zip(rs, ms)])
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    chunk_shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    subs, pad, s = _split_subchunks(x.reshape(n, -1), substeps)
    # step s: rank r sends the partial for chunk (r - s - 1) and
    # receives+reduces the partial for chunk (r - s - 2); after N-1 steps
    # rank r owns fully reduced chunk r — psum_scatter's layout.
    curs = [sub[(idx - 1) % n] for sub in subs]
    for step in range(n - 1):
        # double buffer: all sub-chunk sends of this ring step are posted
        # before any reduce
        mines = [sub[(idx - step - 2) % n] for sub in subs]
        if codec:
            curs = _codec_permute_accumulate(curs, mines, mesh, axis,
                                             idx + 1, idx - 1, codec)
            continue
        recvd = mesh.permute(curs, axis, idx + 1, idx - 1)
        curs = step_reduce(recvd, mines)
    # with n == 1 no step ran: curs are views of x itself
    out = _concat(curs) if n > 1 else torch.cat(curs)
    if pad:
        out = out[:-pad]
    return out.reshape(chunk_shape)


def ring_all_reduce(x: torch.Tensor, mesh, axis: str, accumulate=None, *,
                    substeps: int = 1, codec: str = "") -> torch.Tensor:
    """All-reduce = ring reduce-scatter + ring all-gather (2(N-1) steps)."""
    n = mesh.axis_size(axis)
    flat, pad = _flatten_pad(x, n)
    mine = ring_reduce_scatter(flat.reshape(n, -1), mesh, axis, accumulate,
                               substeps=substeps, codec=codec)
    gathered = ring_all_gather(mine, mesh, axis, substeps=substeps,
                               codec=codec)           # [n, chunk] by rank
    flat_out = gathered.reshape(-1)
    if pad:
        flat_out = flat_out[:-pad]
    return flat_out.reshape(x.shape)


def ring_all_to_all(x: torch.Tensor, mesh, axis: str, *,
                    codec: str = "") -> torch.Tensor:
    """all-to-all via N-1 rotations (tiled semantics, axis 0).  ``codec``
    compresses each rotation's transfer; the resident block stays exact."""
    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    chunk = x.shape[0] // n
    blocks = x.reshape((n, chunk) + tuple(x.shape[1:]))
    # rotation s sends block (idx+s) to rank idx+s and receives the block
    # rank idx-s holds for us
    received = [blocks[idx]]
    for s in range(1, n):
        send = blocks[(idx + s) % n]
        if codec:
            received.append(_codec_permute(send, mesh, axis, idx + s,
                                           idx - s, codec))
        else:
            received += mesh.permute([send], axis, idx + s, idx - s)
    out = _by_rank(torch.stack(received), idx, n)
    return out.reshape((n * chunk,) + tuple(x.shape[1:]))


def tree_all_reduce(x: torch.Tensor, mesh, axis: str, *,
                    codec: str = "") -> torch.Tensor:
    """All-reduce via recursive doubling: log2(N) butterfly steps.
    Requires power-of-two N.  ``codec`` compresses each butterfly
    exchange (the local operand stays exact)."""
    n = mesh.axis_size(axis)
    if n & (n - 1):
        raise ValueError("recursive doubling needs power-of-two ranks")
    idx = mesh.axis_index(axis)
    k = 0
    while (1 << k) < n:
        partner = idx ^ (1 << k)
        if codec:
            (x,) = _codec_permute_accumulate([x], [x], mesh, axis, partner,
                                             partner, codec)
        else:
            x = x + mesh.permute([x], axis, partner, partner)[0]
        k += 1
    return x


# ---------------------------------------------------------------------------
# ortho-route primitives
# ---------------------------------------------------------------------------

def _detour(x: torch.Tensor, mesh, ortho: str, native,
            codec: str) -> torch.Tensor:
    """Permute one hop along ``ortho``, run ``native`` on the neighbour
    row, permute back (both hops through ``codec`` when one is given).
    The operands never mix between ortho rows, so the result is exact for
    any sharding across the ortho axis."""
    j = mesh.axis_index(ortho)

    def hop(y, send_to, recv_from):
        if codec:
            return _codec_permute(y, mesh, ortho, send_to, recv_from, codec)
        return mesh.permute([y], ortho, send_to, recv_from)[0]

    return hop(native(hop(x, j + 1, j - 1)), j - 1, j + 1)


def ortho_all_gather(x: torch.Tensor, mesh, axis: str, ortho: str, *,
                     codec: str = "") -> torch.Tensor:
    """Gather over `axis` routing the payload via `ortho` links."""
    if mesh.axis_size(ortho) <= 1:
        return mesh.all_gather(x, axis)
    return _detour(x, mesh, ortho, lambda g: mesh.all_gather(g, axis), codec)


def ortho_all_reduce(x: torch.Tensor, mesh, axis: str, ortho: str, *,
                     codec: str = "") -> torch.Tensor:
    """All-reduce over `axis` via the neighbour-row detour (the two hops
    carry encoded payloads under ``codec``; the reduce itself is native)."""
    if mesh.axis_size(ortho) <= 1:
        return mesh.all_reduce(x, axis)
    return _detour(x, mesh, ortho, lambda g: mesh.all_reduce(g, axis), codec)
