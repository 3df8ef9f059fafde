"""Public entry points of the port's kernels.

Port of ``src/repro/kernels/ops.py`` (the entry points this slice ports).
Each dispatches on the device of its input: a CPU tensor goes to the plain
PyTorch version in ``kernels/ref.py``; a CUDA tensor goes to the
hand-written kernel, which launches or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref


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
