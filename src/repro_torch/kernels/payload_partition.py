"""Hopper kernels K7a/K7b: the multi-path payload split and merge.

Port of ``src/repro/kernels/payload_partition.py`` (``extract_segment``,
``merge_segments``, body ``_copy_kernel``).  The kernels are CUDA C++ in
``csrc/payload_partition.cu`` (its header says what bounds them and what
their design does about it); this module builds it on first use
(``kernels/_nvcc.py``), loads it with ``ctypes`` and launches on
PyTorch's current stream.  The kernels copy bytes, so they take any
dtype and any length; the reference's block alignment is asserted by the
entry points in ``kernels/ops.py``, not needed here.  The plain PyTorch
versions are ``kernels/ref.py::extract_segment_ref`` and
``merge_segments_ref``.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "payload_partition.cu")

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
        p, n = ctypes.c_void_p, ctypes.c_int64
        lib.pp_extract.argtypes = [p, p, n, p]
        lib.pp_merge.argtypes = [p, p, ctypes.c_int, p, p]
        lib.pp_extract.restype = lib.pp_merge.restype = ctypes.c_int
        lib.pp_error_string.argtypes = [ctypes.c_int]
        lib.pp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _launch(what: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().pp_error_string(err).decode()}")
    launch_count[what] += 1


def extract(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """K7a on the card: a new tensor holding ``x[start:start + length]`` of
    a flat, contiguous CUDA tensor of any dtype."""
    what = "extract"
    _check(x.is_cuda, what, "the input must be on CUDA")
    _check(x.ndim == 1 and x.is_contiguous(), what,
           "the input must be flat and contiguous")
    _check(0 <= start and 0 <= length and start + length <= x.numel(), what,
           f"[{start}, {start + length}) outside {x.numel()} elements")
    out = torch.empty(length, dtype=x.dtype, device=x.device)
    if length:
        es = x.element_size()
        _launch(what, _library().pp_extract, x.data_ptr() + start * es,
                out.data_ptr(), length * es, device=x.device)
    return out


def merge(segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """K7b on the card: the flat, contiguous CUDA segments (one dtype, one
    device) concatenated, in ONE launch over a table of (source, output
    offset, bytes, first block) rows: the kernel's host side fills the
    first blocks and copies the table to the card on the current
    stream."""
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
    rows, off = [], 0
    for s in segs:
        if s.numel():
            rows.append((s.data_ptr(), off * es, s.numel() * es, 0))
        off += s.numel()
    if rows:
        host = torch.tensor(rows, dtype=torch.int64)
        table = torch.empty_like(host, device=dev)
        _launch(what, _library().pp_merge, host.data_ptr(),
                table.data_ptr(), len(rows), out.data_ptr(), device=dev)
    return out
