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
``kernels/ops.py:139``).  :func:`chunk_accumulate_segments` runs
every sub-chunk of a ring step (up to :data:`MAX_SEGMENTS`) in one
launch, into one contiguous output.  The plain PyTorch version is
``kernels/ref.py::chunk_accumulate_ref``; the dispatchers
``kernels/ops.py::accumulate`` / ``accumulate_many`` pick it for CPU
tensors.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import pathlib
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.ref import split_flat

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "chunk_accumulate.cu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the one pair of operand dtypes that differ: a float32 local chunk plus
#: a received bf16_pack chunk (the reference's ops.py:139), out float32
MIXED = (torch.float32, torch.bfloat16)

#: segments one launch takes (csrc/segments.cuh kMaxSegments): a ring
#: step's sub-chunks, at most routing.MAX_STAGED_SUBSTEPS
MAX_SEGMENTS = 8

#: kernel launches since the last reset, by (a dtype, b dtype); the
#: wrappers add one per launch and nowhere else (chip_smoke.py reads it
#: to prove the staged ring ran through the kernel)
launch_count: collections.Counter = collections.Counter()

#: segments of :func:`chunk_accumulate_segments` launches since the last
#: reset, by the path the kernel took for them: "vector" (every pointer
#: 16-byte aligned) or "scalar"
segment_paths: collections.Counter = collections.Counter()

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
        lib.ca_chunk_accumulate_segments.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, p, ctypes.POINTER(ctypes.c_int)]
        lib.ca_chunk_accumulate_segments.restype = ctypes.c_int
        lib.ca_error_string.argtypes = [ctypes.c_int]
        lib.ca_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"chunk_accumulate: {msg}")


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    _check(a.is_cuda and b.is_cuda, "both inputs must be on CUDA")
    _check(a.device == b.device, "inputs on two devices")
    _check(a.dtype in _DTYPE_CODES, f"dtype {a.dtype} not float32/bfloat16/"
           f"float16")
    _check(b.dtype == a.dtype or (a.dtype, b.dtype) == MIXED,
           f"dtypes differ: {a.dtype} and {b.dtype}")
    _check(a.shape == b.shape, f"shapes differ: {tuple(a.shape)} and "
           f"{tuple(b.shape)}")
    _check(a.is_contiguous() and b.is_contiguous(), "non-contiguous input")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"chunk_accumulate launch failed: "
                           f"{_library().ca_error_string(err).decode()} "
                           f"({what})")


def chunk_accumulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a.float() + b.float()).to(a.dtype)`` on the card, any shape.

    a, b : contiguous CUDA tensors of one shape on one device, of one
           dtype (float32, bfloat16 or float16) or a float32 ``a`` with a
           bfloat16 ``b``
    returns a new tensor of a's shape and dtype

    Anything else raises."""
    _check_pair(a, b)
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
    _raise_on(err, f"n={a.numel()}, dtypes {a.dtype}, {b.dtype}")
    launch_count[a.dtype, b.dtype] += 1
    return out


def chunk_accumulate_segments(as_: Sequence[torch.Tensor],
                              bs: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """:func:`chunk_accumulate` of every pair ``(as_[j], bs[j])`` in ONE
    launch: 1 to :data:`MAX_SEGMENTS` pairs, each as :func:`chunk_accumulate`
    takes it, all of one dtype pair on one device.  Returns one result a
    pair, of a's shape: views of one contiguous buffer, laid end to end in
    order.  Anything else raises."""
    as_, bs = list(as_), list(bs)
    _check(1 <= len(as_) <= MAX_SEGMENTS, f"{len(as_)} segments, not 1 to "
           f"{MAX_SEGMENTS}")
    _check(len(bs) == len(as_), f"{len(as_)} a operands, {len(bs)} b")
    for a, b in zip(as_, bs):
        _check_pair(a, b)
    a0, b0 = as_[0], bs[0]
    _check(all(a.device == a0.device and a.dtype == a0.dtype
               and b.dtype == b0.dtype for a, b in zip(as_, bs)),
           "segments on two devices or of two dtype pairs")
    flat = torch.empty(sum(a.numel() for a in as_), dtype=a0.dtype,
                       device=a0.device)
    outs = split_flat(flat, [a.shape for a in as_])
    rows = [(a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel())
            for a, b, o in zip(as_, bs, outs) if a.numel()]
    if not rows:
        return outs
    lib = _library()
    table = (ctypes.c_int64 * (4 * len(rows)))(*itertools.chain(*rows))
    n_vector = ctypes.c_int(0)
    with torch.cuda.device(a0.device):
        stream = torch.cuda.current_stream(a0.device).cuda_stream
        err = lib.ca_chunk_accumulate_segments(
            table, len(rows), _DTYPE_CODES[a0.dtype], _DTYPE_CODES[b0.dtype],
            stream, ctypes.byref(n_vector))
    _raise_on(err, f"lengths {[r[3] for r in rows]}, dtypes {a0.dtype}, "
                   f"{b0.dtype}")
    launch_count[a0.dtype, b0.dtype] += 1
    segment_paths["vector"] += n_vector.value
    segment_paths["scalar"] += len(rows) - n_vector.value
    return outs
