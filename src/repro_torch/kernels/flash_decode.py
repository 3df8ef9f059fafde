"""Hopper kernel K6: flash-decoding attention over a PAGED KV cache.

Port of ``src/repro/kernels/flash_decode.py`` (``paged_flash_decode_pool``,
body ``_fd_kernel``).  The kernel is CUDA C++ in ``csrc/flash_decode.cu``:
a split-KV grid (T, Hkv, n_split) whose CTAs walk their share of a row's
logical blocks with cp.async-pipelined loads, bf16 products on the tensor
cores (``mma.sync``) and a log-sum-exp merge of the splits; its header
says what bounds it on the card (the K/V bytes it reads) and what its
design does about that.  This module picks the split from the shapes
alone (:func:`split_plan`), builds the kernel on first use
(``kernels/_nvcc.py``), loads it with ``ctypes`` and launches it on
PyTorch's current stream.  The plain PyTorch version is
``kernels/ref.py::paged_flash_decode_ref``; the dispatcher
``kernels/ops.py`` picks it for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
SUPPORTED_HEAD_DIMS = (64, 112, 128)
#: query heads of one KV head the kernel takes: one m16 tile of mma.sync
MAX_GROUP = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: positions a split covers at least: four 16-position tiles for each of
#: the kernel's four warps, so that every warp's pipeline fills
MIN_SPLIT_POSITIONS = 256
#: CTAs the split grid aims for on each SM (three are resident at a time at
#: hd 128 in bf16; at uneven kv_valid many splits of a long table are empty)
CTAS_PER_SM = 4

#: calls since the last reset; the wrapper adds one per call, where it
#: launches the kernel (one or two CUDA launches: the split kernel, then
#: the merge when n_split > 1), and nowhere else.  chip_smoke.py reads it
#: to prove the serving path ran through the kernel: a serve makes
#: n_layers calls a packed step.
launch_count = 0

_lib: Optional[ctypes.CDLL] = None


def split_plan(t_rows: int, hkv: int, max_blocks: int, block_size: int,
               n_sm: int) -> Tuple[int, int]:
    """(n_split, blocks per split) for a call, from its shapes alone.

    Enough splits that T * Hkv * n_split CTAs come to about
    ``CTAS_PER_SM`` on each of the ``n_sm`` SMs, but none except the
    last shorter than ``MIN_SPLIT_POSITIONS`` positions; split s takes
    logical blocks ``[s * bps, min((s + 1) * bps, max_blocks))``, never an
    empty range.
    kv_valid is not an argument: reading it on the host would cost a
    device-to-host sync per layer."""
    min_blocks = -(-MIN_SPLIT_POSITIONS // block_size)
    want = -(-CTAS_PER_SM * n_sm // max(1, t_rows * hkv))
    n_split = max(1, min(want, max_blocks // min_blocks))
    bps = -(-max_blocks // n_split)
    return -(-max_blocks // bps), bps


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/flash_decode.cu`` unless its library is built
    (kernels/_nvcc.py).  Returns (library path, the compiler's output)."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fd_paged_flash_decode.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                              i, i, i, i, i, i,
                                              ctypes.c_float, i, p]
        lib.fd_paged_flash_decode.restype = i
        lib.fd_smem_bytes.argtypes = [i, i]
        lib.fd_smem_bytes.restype = i
        lib.fd_error_string.argtypes = [i]
        lib.fd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_flash_decode_pool: {msg}")


def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory of the split kernel, in bytes (builds it)."""
    return _library().fd_smem_bytes(_DTYPE_CODES[dtype], head_dim)


def paged_flash_decode_pool(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            kv_valid: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Attention for T packed single-token rows over a paged pool, on the
    card.

    q            : [T, Hq, hd]  float32 or bfloat16, hd in {64, 112, 128},
                   Hq / Hkv <= MAX_GROUP
    k/v_pool     : [n_blocks, block_size, Hkv, hd], q's dtype
    block_tables : [T, max_blocks] int32 — logical block j of row t lives
                   in pool block ``block_tables[t, j]``
    kv_valid     : [T] int32 — row t attends positions < kv_valid[t]
    returns        [T, Hq, hd] in q.dtype

    Every tensor must be a contiguous CUDA tensor on one device; anything
    else raises.  One call adds one to ``launch_count``, whether it
    launches the split kernel alone (n_split == 1) or the split kernel
    and the merge.
    """
    global launch_count
    tensors = (q, k_pool, v_pool, block_tables, kv_valid)
    _check(all(x.is_cuda for x in tensors), "every input must be on CUDA")
    _check(len({x.device for x in tensors}) == 1, "inputs on two devices")
    _check(all(x.is_contiguous() for x in tensors), "non-contiguous input")
    _check(q.dtype in _DTYPE_CODES, f"dtype {q.dtype} not float32/bfloat16")
    _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           "pools must have q's dtype")
    _check(block_tables.dtype == torch.int32 and kv_valid.dtype == torch.int32,
           "block_tables and kv_valid must be int32")
    _check(q.ndim == 3 and k_pool.ndim == 4, "q [T,Hq,hd], pools 4-D")
    t_rows, hq, hd = q.shape
    nb, bs, hkv, hd_k = k_pool.shape
    _check(hd in SUPPORTED_HEAD_DIMS, f"head_dim {hd} not in "
           f"{SUPPORTED_HEAD_DIMS}")
    _check(hd_k == hd and v_pool.shape == k_pool.shape, "pool shapes")
    _check(hq % hkv == 0, f"Hq {hq} not a multiple of Hkv {hkv}")
    _check(hq // hkv <= MAX_GROUP, f"group Hq/Hkv = {hq // hkv} above "
           f"{MAX_GROUP}")
    _check(nb * bs * hkv < 2 ** 31, "pool has 2^31 head rows or more")
    _check(block_tables.ndim == 2 and block_tables.shape[0] == t_rows
           and block_tables.shape[1] > 0,
           "block_tables must be [T, max_blocks], max_blocks > 0")
    _check(kv_valid.shape == (t_rows,), "kv_valid must be [T]")
    _check(all(x.data_ptr() % 16 == 0 for x in (q, k_pool, v_pool)),
           "q and pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if t_rows == 0:
        return out
    maxb = block_tables.shape[1]
    n_split, bps = split_plan(t_rows, hkv, maxb, bs, _sm_count(q.device.index
                                                               or 0))
    # every split writes its partial, so the workspace needs no zeroing
    ws = torch.empty(t_rows * hq * n_split * (hd + 2) if n_split > 1 else 0,
                     dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fd_paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
            ws.data_ptr(), t_rows, hkv, hq // hkv, hd, bs, maxb, n_split,
            bps, -1 if window is None else int(window),
            1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("paged_flash_decode launch failed: "
                           f"{lib.fd_error_string(err).decode()} "
                           f"(T={t_rows}, Hq={hq}, Hkv={hkv}, hd={hd}, "
                           f"block_size={bs}, max_blocks={maxb}, "
                           f"n_split={n_split})")
    launch_count += 1
    return out
