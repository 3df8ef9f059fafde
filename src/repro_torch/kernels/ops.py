"""Public entry points of the port's kernels.

Port of ``src/repro/kernels/ops.py``.  Each entry point dispatches on the
device of its input: a CPU tensor goes to the plain PyTorch version in
``kernels/ref.py``; a ``meta`` tensor (a step lowered by the dry-run)
goes there too, which then computes shapes and dtypes only; a CUDA
tensor goes to the hand-written kernel, which launches or raises — there
is no fallback.

The reference pads every payload to [rows % 8, 128]-lane tiles
(``_pad_2d``) for the TPU's BlockSpecs; the port's kernels walk flat
arrays of any length, so no padding copy exists here.

The list forms (``accumulate_many``, ``wire_encode_many``,
``wire_decode_accumulate_many``) take every sub-chunk of one ring step:
K1 and K5 run them in ONE launch into one contiguous buffer, of which
they return per-sub-chunk views; the fp8 codecs still launch once a
sub-chunk.  On the CPU they run the plain versions pair by pair.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from repro_torch.kernels import chunk_accumulate as _ca
from repro_torch.kernels import codec as _codec
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import payload_partition as _pp
from repro_torch.kernels import ref

#: the most sub-chunks one list-form call takes (a ring step's, at most
#: routing.MAX_STAGED_SUBSTEPS): the size of the kernels' segment tables
MAX_SEGMENTS = _ca.MAX_SEGMENTS


def _plain(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain version: on the CPU, which computes
    it, or ``meta``, which gets its shapes and dtypes."""
    return x.device.type in ("cpu", "meta")


def _cuda_only(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")


def _accumulate_impl(a: torch.Tensor, b: torch.Tensor,
                     acc_dtype) -> torch.Tensor:
    if _plain(a):
        return ref.chunk_accumulate_ref(a, b, acc_dtype=acc_dtype)
    _cuda_only(a, "accumulate")
    if acc_dtype != torch.float32:
        raise ValueError(f"accumulate: the kernel accumulates in float32, "
                         f"not {acc_dtype}")
    return _ca.chunk_accumulate(a.contiguous(), b.contiguous())


class _Accumulate(torch.autograd.Function):
    """``a + b`` through the ring-step kernel.  d(a + b)/da = d(a + b)/db
    = identity: the cotangent passes to both operands unchanged (the
    reference's ``_accumulate`` custom_vjp), in each operand's dtype."""

    @staticmethod
    def forward(ctx, a, b, acc_dtype):
        ctx.b_dtype = b.dtype
        return _accumulate_impl(a, b, acc_dtype)

    @staticmethod
    def backward(ctx, g):
        return g, g.to(ctx.b_dtype), None


def _check_operands(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or (a.dtype != b.dtype
                              and (a.dtype, b.dtype) != _ca.MIXED):
        raise ValueError(f"{what}: operands differ: {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(b.shape)} {b.dtype}")


def accumulate(a: torch.Tensor, b: torch.Tensor, *,
               acc_dtype=torch.float32) -> torch.Tensor:
    """Ring-step accumulate for chunks of any shape: a + b in
    ``acc_dtype``, rounded to a's dtype.  The operands share a dtype, or
    are a float32 ``a`` and a bfloat16 ``b``."""
    _check_operands(a, b, "accumulate")
    return _Accumulate.apply(a, b, acc_dtype)


def _check_list(what: str, *lists: Sequence[torch.Tensor]) -> None:
    n = len(lists[0])
    if not 1 <= n <= MAX_SEGMENTS or any(len(x) != n for x in lists):
        raise ValueError(f"{what}: {[len(x) for x in lists]} operands, not "
                         f"1 to {MAX_SEGMENTS} of each")
    tensors = [t for x in lists for t in x]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: operands on two devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{what}: the list forms carry no gradient (the "
                         f"ring runs them under no_grad)")


def _one_buffer(results: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain versions' results laid end to end in one buffer, as the
    kernels write them: per-result views of it."""
    flat = torch.cat([r.reshape(-1) for r in results])
    return ref.split_flat(flat, [r.shape for r in results])


def accumulate_many(as_: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                    *, acc_dtype=torch.float32) -> List[torch.Tensor]:
    """``accumulate(as_[j], bs[j])`` for every sub-chunk j of one ring step
    (1 to :data:`MAX_SEGMENTS`): ONE K1 launch on CUDA.  The results are
    views of one contiguous buffer, laid end to end in order."""
    as_, bs = list(as_), list(bs)
    _check_list("accumulate_many", as_, bs)
    for a, b in zip(as_, bs):
        _check_operands(a, b, "accumulate_many")
    if _plain(as_[0]):
        return _one_buffer([ref.chunk_accumulate_ref(a, b, acc_dtype=acc_dtype)
                            for a, b in zip(as_, bs)])
    _cuda_only(as_[0], "accumulate_many")
    if acc_dtype != torch.float32:
        raise ValueError(f"accumulate_many: the kernel accumulates in "
                         f"float32, not {acc_dtype}")
    return _ca.chunk_accumulate_segments([a.contiguous() for a in as_],
                                         [b.contiguous() for b in bs])


def ring_accumulate_fn(acc_dtype=torch.float32):
    """An ``accumulate(a, b)`` closure for collectives.ring_reduce_scatter /
    ring_all_reduce — this is how the kernel plugs into the staged path.
    Its ``many`` attribute is the list form the ring calls once a step."""
    def acc(a, b):
        return accumulate(a, b, acc_dtype=acc_dtype)
    acc.many = functools.partial(accumulate_many, acc_dtype=acc_dtype)
    return acc


# -- payload split / merge (K7) ------------------------------------------------
#
# The reference's entry points, signatures and block-alignment asserts.
# No path calls them: routing.execute partitions with views and
# ``torch.cat``, as the reference's does with ``lax.dynamic_slice``.

def extract_segment(x: torch.Tensor, start_block: int, n_blocks: int,
                    block: int = ref.BLOCK) -> torch.Tensor:
    """Aligned segment copy (payload split): ``x[start_block * block :
    (start_block + n_blocks) * block]`` of a flat, block-aligned payload."""
    assert x.ndim == 1 and x.shape[0] % block == 0
    assert (start_block + n_blocks) * block <= x.shape[0]
    if _plain(x):
        return ref.extract_segment_ref(x, start_block, n_blocks, block=block)
    _cuda_only(x, "extract_segment")
    return _pp.extract(x.contiguous(), start_block * block, n_blocks * block)


def merge_segments(segments, block: int = ref.BLOCK) -> torch.Tensor:
    """Per-route result reassembly (payload merge): block-aligned flat
    segments concatenated."""
    segs = list(segments)
    assert all(s.ndim == 1 and s.shape[0] % block == 0 for s in segs)
    if all(_plain(s) for s in segs):
        return ref.merge_segments_ref(segs)
    for s in segs:
        _cuda_only(s, "merge_segments")
    return _pp.merge([s.contiguous() for s in segs])


# -- wire codecs (DESIGN.md §12) ----------------------------------------------
#
# The flat-payload face of kernels/codec.py: a chunk of any shape is
# encoded to its wire form (fp8 values [n] plus one float32 scale per 128
# elements, or a bf16 half-width pack [n]) and decoded, plain or fused
# into the ring-step accumulate.  No gradient flows through these: the
# data-parallel step reduces gradients that are already computed.

def wire_encode(x: torch.Tensor, *, codec_name: str):
    """Encode a chunk for the wire -> (values [n], scales or None)."""
    flat = x.reshape(-1)
    if _plain(x):
        if codec_name == "bf16_pack":
            return ref.bf16_pack_ref(flat), None
        return ref.fp8_encode_ref(flat, fmt=codec_name)
    _cuda_only(x, "wire_encode")
    flat = flat.contiguous()
    if codec_name == "bf16_pack":
        return _codec.bf16_pack(flat), None
    return _codec.fp8_encode(flat, codec_name)


def wire_encode_many(xs: Sequence[torch.Tensor], *, codec_name: str):
    """:func:`wire_encode` of every sub-chunk of one ring step (1 to
    :data:`MAX_SEGMENTS`).  The bf16 pack is ONE K5 launch on CUDA, its
    values views of one contiguous buffer; fp8 encodes each sub-chunk."""
    xs = list(xs)
    _check_list("wire_encode_many", xs)
    if codec_name != "bf16_pack":
        return [wire_encode(x, codec_name=codec_name) for x in xs]
    flats = [x.reshape(-1) for x in xs]
    if _plain(flats[0]):
        vals = _one_buffer([ref.bf16_pack_ref(f) for f in flats])
    else:
        _cuda_only(flats[0], "wire_encode_many")
        vals = _codec.bf16_pack_segments([f.contiguous() for f in flats])
    return [(v, None) for v in vals]


def wire_decode(vals: torch.Tensor, scales, *, codec_name: str, shape,
                dtype) -> torch.Tensor:
    """Decode a wire payload back to ``shape``/``dtype``.  The bf16 pack
    decodes by a plain cast, as the reference's does."""
    if codec_name == "bf16_pack":
        out = vals.to(dtype)
    elif _plain(vals):
        out = ref.fp8_decode_ref(vals, scales, out_dtype=dtype)
    else:
        _cuda_only(vals, "wire_decode")
        out = _codec.fp8_decode(vals, scales, codec_name, dtype)
    return out.reshape(shape)


def wire_decode_accumulate(vals: torch.Tensor, scales, mine: torch.Tensor,
                           *, codec_name: str) -> torch.Tensor:
    """Fused ring-step decompress: ``dequant(vals[, scales]) + mine`` in
    float32, rounded to mine's dtype.  The bf16 pack feeds K1 directly
    (mixed float32 + bfloat16 when ``mine`` is float32); fp8 runs K3."""
    if codec_name == "bf16_pack":
        return accumulate(mine, vals.reshape(mine.shape))
    if _plain(mine):
        return ref.fp8_decode_accumulate_ref(vals, scales, mine)
    _cuda_only(mine, "wire_decode_accumulate")
    return _codec.fp8_decode_accumulate(vals, scales, mine.contiguous(),
                                        codec_name).reshape(mine.shape)


def wire_decode_accumulate_many(payloads, mines: Sequence[torch.Tensor], *,
                                codec_name: str) -> List[torch.Tensor]:
    """:func:`wire_decode_accumulate` of every sub-chunk of one ring step:
    ``payloads[j] = (values, scales or None)`` onto ``mines[j]``.  The bf16
    pack is ONE K1 launch (:func:`accumulate_many`); fp8 runs K3 a
    sub-chunk."""
    payloads, mines = list(payloads), list(mines)
    if codec_name == "bf16_pack":
        return accumulate_many(mines, [v.reshape(m.shape) for (v, _), m
                                       in zip(payloads, mines)])
    _check_list("wire_decode_accumulate_many", [v for v, _ in payloads],
                mines)
    return [wire_decode_accumulate(v, s, m, codec_name=codec_name)
            for (v, s), m in zip(payloads, mines)]


def wire_roundtrip(x: torch.Tensor, *, codec_name: str) -> torch.Tensor:
    """encode -> decode, same shape and dtype: the quantization a chunk
    suffers on the wire."""
    vals, scales = wire_encode(x, codec_name=codec_name)
    return wire_decode(vals, scales, codec_name=codec_name, shape=x.shape,
                       dtype=x.dtype)


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       kv_valid: torch.Tensor, *, window=None) -> torch.Tensor:
    """Flash-decoding over a paged KV pool (one layer): q [T, Hq, hd],
    pools [n_blocks, block_size, Hkv, hd], block_tables [T, maxb],
    kv_valid [T] -> [T, Hq, hd]."""
    if _plain(q):
        return ref.paged_flash_decode_ref(q, k_pool, v_pool, block_tables,
                                          kv_valid, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for {q.device}")
    return _fd.paged_flash_decode_pool(
        q, k_pool, v_pool, block_tables.to(torch.int32).contiguous(),
        kv_valid.to(torch.int32).contiguous(), window=window)
