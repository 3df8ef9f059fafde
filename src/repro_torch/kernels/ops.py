"""Public entry points of the port's kernels.

Port of ``src/repro/kernels/ops.py`` (the entry points the ported slices
run).  Each dispatches on the device of its input: a CPU tensor goes to
the plain PyTorch version in ``kernels/ref.py``; a CUDA tensor goes to the
hand-written kernel, which launches or raises — there is no fallback.

The reference pads every payload to [rows % 8, 128]-lane tiles
(``_pad_2d``) for the TPU's BlockSpecs; the port's kernels walk flat
arrays of any length, so no padding copy exists here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import chunk_accumulate as _ca
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref


def _accumulate_impl(a: torch.Tensor, b: torch.Tensor,
                     acc_dtype) -> torch.Tensor:
    if a.device.type == "cpu":
        return ref.chunk_accumulate_ref(a, b, acc_dtype=acc_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"accumulate: no kernel for {a.device}")
    if acc_dtype != torch.float32:
        raise ValueError(f"accumulate: the kernel accumulates in float32, "
                         f"not {acc_dtype}")
    return _ca.chunk_accumulate(a.contiguous(), b.contiguous())


class _Accumulate(torch.autograd.Function):
    """``a + b`` through the ring-step kernel.  d(a + b)/da = d(a + b)/db
    = identity: the cotangent passes to both operands unchanged (the
    reference's ``_accumulate`` custom_vjp)."""

    @staticmethod
    def forward(ctx, a, b, acc_dtype):
        return _accumulate_impl(a, b, acc_dtype)

    @staticmethod
    def backward(ctx, g):
        return g, g, None


def accumulate(a: torch.Tensor, b: torch.Tensor, *,
               acc_dtype=torch.float32) -> torch.Tensor:
    """Ring-step accumulate for chunks of any shape: a + b in
    ``acc_dtype``, rounded to a's dtype."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"accumulate: operands differ: {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(b.shape)} {b.dtype}")
    return _Accumulate.apply(a, b, acc_dtype)


def ring_accumulate_fn(acc_dtype=torch.float32):
    """An ``accumulate(a, b)`` closure for collectives.ring_reduce_scatter /
    ring_all_reduce — this is how the kernel plugs into the staged path."""
    return lambda a, b: accumulate(a, b, acc_dtype=acc_dtype)


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
