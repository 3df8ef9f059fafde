"""Hopper kernel K1: the staged ring's per-step chunk accumulate.

Port of ``src/repro/kernels/chunk_accumulate.py`` (``chunk_accumulate_2d``,
body ``_accum_kernel``): ``out = cast_to_a_dtype(fp32(a) + fp32(b))``, the
mixed-precision ring-reduce step that keeps a bf16 all-reduce from losing
low bits across N-1 sequential steps.  The kernel is CUDA C++ in
``csrc/chunk_accumulate.cu`` (its header says what bounds it and what its
design does about that); this module builds it on first use
(``kernels/_nvcc.py``), loads it with ``ctypes`` and launches it on
PyTorch's current stream.  The same pass takes a float32 ``a`` with a
bfloat16 ``b``: the decode of the ``bf16_pack`` wire codec (reference
``kernels/ops.py:139``).  The plain
PyTorch version is ``kernels/ref.py::chunk_accumulate_ref``; the
dispatcher ``kernels/ops.py::accumulate`` picks it for CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "chunk_accumulate.cu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the one pair of operand dtypes that differ: a float32 local chunk plus
#: a received bf16_pack chunk (the reference's ops.py:139), out float32
MIXED = (torch.float32, torch.bfloat16)

#: kernel launches since the last reset, by (a dtype, b dtype); the
#: wrapper adds one per launch and nowhere else (chip_smoke.py reads it
#: to prove the staged ring ran through the kernel)
launch_count: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/chunk_accumulate.cu`` unless its library is built
    (kernels/_nvcc.py).  Returns (library path, the compiler's output)."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p = ctypes.c_void_p
        lib.ca_chunk_accumulate.argtypes = [p, p, p, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_int, p]
        lib.ca_chunk_accumulate.restype = ctypes.c_int
        lib.ca_error_string.argtypes = [ctypes.c_int]
        lib.ca_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"chunk_accumulate: {msg}")


def chunk_accumulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a.float() + b.float()).to(a.dtype)`` on the card, any shape.

    a, b : contiguous CUDA tensors of one shape on one device, of one
           dtype (float32, bfloat16 or float16) or a float32 ``a`` with a
           bfloat16 ``b``
    returns a new tensor of a's shape and dtype

    Anything else raises."""
    _check(a.is_cuda and b.is_cuda, "both inputs must be on CUDA")
    _check(a.device == b.device, "inputs on two devices")
    _check(a.dtype in _DTYPE_CODES, f"dtype {a.dtype} not float32/bfloat16/"
           f"float16")
    _check(b.dtype == a.dtype or (a.dtype, b.dtype) == MIXED,
           f"dtypes differ: {a.dtype} and {b.dtype}")
    _check(a.shape == b.shape, f"shapes differ: {tuple(a.shape)} and "
           f"{tuple(b.shape)}")
    _check(a.is_contiguous() and b.is_contiguous(), "non-contiguous input")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    if a.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ca_chunk_accumulate(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), a.numel(),
                                      _DTYPE_CODES[a.dtype],
                                      _DTYPE_CODES[b.dtype], stream)
    if err != 0:
        raise RuntimeError("chunk_accumulate launch failed: "
                           f"{lib.ca_error_string(err).decode()} "
                           f"(n={a.numel()}, dtypes {a.dtype}, {b.dtype})")
    launch_count[a.dtype, b.dtype] += 1
    return out
