"""Hopper kernels K7a/K7b: the multi-path payload split and merge.

Port of ``src/repro/kernels/payload_partition.py`` (``extract_segment``,
``merge_segments``, body ``_copy_kernel``).  The kernels are CUDA C++ in
``csrc/payload_partition.cu`` on ``csrc/segments.cuh``'s tables (its
header says what bounds them and what their design does about it); this
module builds it on first use (``kernels/_nvcc.py``), loads it with
``ctypes`` and launches on PyTorch's current stream.  The kernels copy
elements of 1, 2, 4 or 8 bytes, so they take any dtype and any length;
the reference's block alignment is asserted by the entry points in
``kernels/ops.py``, not needed here.  The plain PyTorch versions are
``kernels/ref.py::extract_segment_ref`` and ``merge_segments_ref``.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import pathlib
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "payload_partition.cu")

#: segments one launch takes (csrc/segments.cuh kMaxSegments)
MAX_SEGMENTS = 8

#: kernel launches since the last reset, one count per kernel; each
#: wrapper adds one to its own count per launch and nowhere else
launch_count = {"extract": 0, "merge": 0}

_lib: Optional[ctypes.CDLL] = None


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/payload_partition.cu`` unless its library is built
    (kernels/_nvcc.py).  Returns (library path, the compiler's output)."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.pp_copy.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
        lib.pp_copy.restype = ctypes.c_int
        lib.pp_error_string.argtypes = [ctypes.c_int]
        lib.pp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_groups(lengths: Sequence[int]
                  ) -> List[List[Tuple[int, int, int]]]:
    """The launches of a merge of segments of ``lengths`` elements: for
    each segment of nonzero length, (its index, its output offset, its
    length), in order, at most :data:`MAX_SEGMENTS` a launch."""
    rows, off = [], 0
    for j, n in enumerate(lengths):
        if n:
            rows.append((j, off, n))
        off += n
    return [rows[i:i + MAX_SEGMENTS]
            for i in range(0, len(rows), MAX_SEGMENTS)]


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _copy(what: str, rows, element_size: int, device) -> None:
    """One launch over ``rows`` (source pointer, destination pointer,
    elements) of elements of ``element_size`` bytes, each moved as
    elements of 1, 2, 4 or 8 bytes."""
    word = math.gcd(element_size, 8)
    scale = element_size // word
    flat = list(itertools.chain(*((s, d, n * scale) for s, d, n in rows)))
    table = (ctypes.c_int64 * len(flat))(*flat)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pp_copy(table, len(rows), word, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.pp_error_string(err).decode()}")
    launch_count[what] += 1


def extract(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """K7a on the card: a new tensor holding ``x[start:start + length]`` of
    a flat, contiguous CUDA tensor of any dtype, in one launch of a table
    of one row."""
    what = "extract"
    _check(x.is_cuda, what, "the input must be on CUDA")
    _check(x.ndim == 1 and x.is_contiguous(), what,
           "the input must be flat and contiguous")
    _check(0 <= start and 0 <= length and start + length <= x.numel(), what,
           f"[{start}, {start + length}) outside {x.numel()} elements")
    out = torch.empty(length, dtype=x.dtype, device=x.device)
    if length:
        es = x.element_size()
        _copy(what, [(x.data_ptr() + start * es, out.data_ptr(), length)],
              es, x.device)
    return out


def merge(segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """K7b on the card: the flat, contiguous CUDA segments (one dtype, one
    device) concatenated into one new tensor, in one launch a group of
    :func:`launch_groups` (up to :data:`MAX_SEGMENTS` nonzero segments,
    their rows passed by value: no table is copied to the card), each
    launch writing its own slice of the output."""
    what = "merge"
    segs = list(segments)
    _check(bool(segs), what, "no segments")
    _check(all(s.is_cuda for s in segs), what, "every segment must be on "
           "CUDA")
    _check(len({s.device for s in segs}) == 1, what, "segments on two "
           "devices")
    _check(len({s.dtype for s in segs}) == 1, what, "segments of two dtypes")
    _check(all(s.ndim == 1 and s.is_contiguous() for s in segs), what,
           "segments must be flat and contiguous")
    dev, es = segs[0].device, segs[0].element_size()
    out = torch.empty(sum(s.numel() for s in segs), dtype=segs[0].dtype,
                      device=dev)
    base = out.data_ptr()
    for group in launch_groups([s.numel() for s in segs]):
        _copy(what, [(segs[j].data_ptr(), base + off * es, n)
                     for j, off, n in group], es, dev)
    return out
