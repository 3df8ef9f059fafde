"""Public entry points of the port's kernels.

Port of ``src/repro/kernels/ops.py``.  Each entry point dispatches on the
device of its input: a CPU tensor goes to the plain PyTorch version in
``kernels/ref.py``; a CUDA tensor goes to the hand-written kernel, which
launches or raises — there is no fallback.

The reference pads every payload to [rows % 8, 128]-lane tiles
(``_pad_2d``) for the TPU's BlockSpecs; the port's kernels walk flat
arrays of any length, so no padding copy exists here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import chunk_accumulate as _ca
from repro_torch.kernels import codec as _codec
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import payload_partition as _pp
from repro_torch.kernels import ref


def _cuda_only(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")


def _accumulate_impl(a: torch.Tensor, b: torch.Tensor,
                     acc_dtype) -> torch.Tensor:
    if a.device.type == "cpu":
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


def accumulate(a: torch.Tensor, b: torch.Tensor, *,
               acc_dtype=torch.float32) -> torch.Tensor:
    """Ring-step accumulate for chunks of any shape: a + b in
    ``acc_dtype``, rounded to a's dtype.  The operands share a dtype, or
    are a float32 ``a`` and a bfloat16 ``b``."""
    if a.shape != b.shape or (a.dtype != b.dtype
                              and (a.dtype, b.dtype) != _ca.MIXED):
        raise ValueError(f"accumulate: operands differ: {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(b.shape)} {b.dtype}")
    return _Accumulate.apply(a, b, acc_dtype)


def ring_accumulate_fn(acc_dtype=torch.float32):
    """An ``accumulate(a, b)`` closure for collectives.ring_reduce_scatter /
    ring_all_reduce — this is how the kernel plugs into the staged path."""
    return lambda a, b: accumulate(a, b, acc_dtype=acc_dtype)


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
    if x.device.type == "cpu":
        return ref.extract_segment_ref(x, start_block, n_blocks, block=block)
    _cuda_only(x, "extract_segment")
    return _pp.extract(x.contiguous(), start_block * block, n_blocks * block)


def merge_segments(segments, block: int = ref.BLOCK) -> torch.Tensor:
    """Per-route result reassembly (payload merge): block-aligned flat
    segments concatenated."""
    segs = list(segments)
    assert all(s.ndim == 1 and s.shape[0] % block == 0 for s in segs)
    if all(s.device.type == "cpu" for s in segs):
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
    if x.device.type == "cpu":
        if codec_name == "bf16_pack":
            return ref.bf16_pack_ref(flat), None
        return ref.fp8_encode_ref(flat, fmt=codec_name)
    _cuda_only(x, "wire_encode")
    flat = flat.contiguous()
    if codec_name == "bf16_pack":
        return _codec.bf16_pack(flat), None
    return _codec.fp8_encode(flat, codec_name)


def wire_decode(vals: torch.Tensor, scales, *, codec_name: str, shape,
                dtype) -> torch.Tensor:
    """Decode a wire payload back to ``shape``/``dtype``.  The bf16 pack
    decodes by a plain cast, as the reference's does."""
    if codec_name == "bf16_pack":
        out = vals.to(dtype)
    elif vals.device.type == "cpu":
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
    if mine.device.type == "cpu":
        return ref.fp8_decode_accumulate_ref(vals, scales, mine)
    _cuda_only(mine, "wire_decode_accumulate")
    return _codec.fp8_decode_accumulate(vals, scales, mine.contiguous(),
                                        codec_name).reshape(mine.shape)


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
    if q.device.type == "cpu":
        return ref.paged_flash_decode_ref(q, k_pool, v_pool, block_tables,
                                          kv_valid, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for {q.device}")
    return _fd.paged_flash_decode_pool(
        q, k_pool, v_pool, block_tables.to(torch.int32).contiguous(),
        kv_valid.to(torch.int32).contiguous(), window=window)
