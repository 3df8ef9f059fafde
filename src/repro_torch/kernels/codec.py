"""Hopper kernels K2-K5: the wire codecs of the compressed secondary routes.

Port of ``src/repro/kernels/codec.py`` (``fp8_encode_2d``,
``fp8_decode_accumulate_2d``, ``fp8_decode_2d``, ``bf16_pack_2d``).  The
kernels are CUDA C++ in ``csrc/codec.cu`` (its header fixes each
kernel's arithmetic against the reference's and says what bounds them);
this module builds it on first use (``kernels/_nvcc.py``), loads it with
``ctypes`` and launches on PyTorch's current stream.  The plain PyTorch
versions are the ``*_ref`` functions of ``kernels/ref.py``; the
dispatchers ``kernels/ops.py::wire_*`` pick them for CPU tensors.

The wire form is flat: values [n] (fp8, or bfloat16 for the pack) and one
float32 scale per 128 consecutive elements, ``ceil(n / 128)`` of them.
:func:`bf16_pack_segments` packs every sub-chunk of a ring step in one
launch (``csrc/segments.cuh``).
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import pathlib
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.chunk_accumulate import MAX_SEGMENTS
from repro_torch.kernels.ref import WIRE_DTYPE, n_scales, split_flat

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "codec.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FMT_CODES = {"fp8_e4m3": 0, "fp8_e5m2": 1}

#: kernel launches since the last reset, one count per kernel; each
#: wrapper adds one to its own count per launch and nowhere else
#: (chip_smoke.py reads them to prove the compressed rings ran through the
#: kernels)
launch_count = {"fp8_encode": 0, "fp8_decode_accumulate": 0,
                "fp8_decode": 0, "bf16_pack": 0}

#: segments of :func:`bf16_pack_segments` launches since the last reset,
#: by the path the kernel took for them: "vector" or "scalar"
segment_paths: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/codec.cu`` unless its library is built
    (kernels/_nvcc.py).  Returns (library path, the compiler's output)."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.codec_fp8_encode.argtypes = [p, p, p, n, i, i, p]
        lib.codec_fp8_decode.argtypes = [p, p, p, n, i, i, p]
        lib.codec_fp8_decode_accumulate.argtypes = [p, p, p, p, n, i, i, p]
        lib.codec_bf16_pack.argtypes = [p, p, n, i, p]
        lib.codec_bf16_pack_segments.argtypes = [
            ctypes.POINTER(n), i, i, p, ctypes.POINTER(i)]
        for fn in (lib.codec_fp8_encode, lib.codec_fp8_decode,
                   lib.codec_fp8_decode_accumulate, lib.codec_bf16_pack,
                   lib.codec_bf16_pack_segments):
            fn.restype = i
        lib.codec_error_string.argtypes = [i]
        lib.codec_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_inputs(what: str, *xs: torch.Tensor) -> None:
    _check(all(x.is_cuda for x in xs), what, "every input must be on CUDA")
    _check(len({x.device for x in xs}) == 1, what, "inputs on two devices")
    _check(all(x.is_contiguous() for x in xs), what, "non-contiguous input")


def _launch(what: str, fn, *args, device, tail=()) -> None:
    """``fn(*args, stream, *tail)`` on the device's current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream, *tail)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().codec_error_string(err).decode()}")
    launch_count[what] += 1


def _check_wire(what: str, vals: torch.Tensor, scales: torch.Tensor,
                fmt: str) -> int:
    _check(fmt in _FMT_CODES, what, f"format {fmt!r} not in "
           f"{sorted(_FMT_CODES)}")
    _check(vals.dtype == WIRE_DTYPE[fmt], what, f"values are {vals.dtype}, "
           f"not {WIRE_DTYPE[fmt]}")
    _check(scales.dtype == torch.float32, what, "scales must be float32")
    n = vals.numel()
    _check(scales.numel() == n_scales(n), what, f"{scales.numel()} scales "
           f"for {n} values")
    return n


def fp8_encode(x: torch.Tensor, fmt: str = "fp8_e4m3"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the card: x (float32 or bfloat16, any shape, contiguous) ->
    (values [n] in ``fmt``'s wire dtype, scales [ceil(n/128)] float32)."""
    what = "fp8_encode"
    _check_inputs(what, x)
    _check(x.dtype in _DTYPE_CODES, what, f"dtype {x.dtype} not float32/"
           f"bfloat16")
    _check(fmt in _FMT_CODES, what, f"format {fmt!r} not in "
           f"{sorted(_FMT_CODES)}")
    n = x.numel()
    vals = torch.empty(n, dtype=WIRE_DTYPE[fmt], device=x.device)
    scales = torch.empty(n_scales(n), dtype=torch.float32, device=x.device)
    if n:
        _launch(what, _library().codec_fp8_encode, x.data_ptr(),
                vals.data_ptr(), scales.data_ptr(), n, _DTYPE_CODES[x.dtype],
                _FMT_CODES[fmt], device=x.device)
    return vals, scales


def fp8_decode(vals: torch.Tensor, scales: torch.Tensor, fmt: str,
               out_dtype=torch.float32) -> torch.Tensor:
    """K4 on the card: ``cast_out(fp32(v) * scale)`` -> [n] ``out_dtype``
    (float32 or bfloat16)."""
    what = "fp8_decode"
    _check_inputs(what, vals, scales)
    n = _check_wire(what, vals, scales, fmt)
    _check(out_dtype in _DTYPE_CODES, what, f"out dtype {out_dtype} not "
           f"float32/bfloat16")
    out = torch.empty(n, dtype=out_dtype, device=vals.device)
    if n:
        _launch(what, _library().codec_fp8_decode, vals.data_ptr(),
                scales.data_ptr(), out.data_ptr(), n,
                _DTYPE_CODES[out_dtype], _FMT_CODES[fmt], device=vals.device)
    return out


def fp8_decode_accumulate(vals: torch.Tensor, scales: torch.Tensor,
                          b: torch.Tensor, fmt: str) -> torch.Tensor:
    """K3 on the card: ``cast_b(fma(fp32(v), scale, fp32(b)))`` -> a new
    tensor of b's shape and dtype (float32 or bfloat16)."""
    what = "fp8_decode_accumulate"
    _check_inputs(what, vals, scales, b)
    n = _check_wire(what, vals, scales, fmt)
    _check(b.dtype in _DTYPE_CODES, what, f"dtype {b.dtype} not float32/"
           f"bfloat16")
    _check(b.numel() == n, what, f"{n} values for {b.numel()} elements")
    out = torch.empty_like(b)
    if n:
        _launch(what, _library().codec_fp8_decode_accumulate,
                vals.data_ptr(), scales.data_ptr(), b.data_ptr(),
                out.data_ptr(), n, _DTYPE_CODES[b.dtype], _FMT_CODES[fmt],
                device=b.device)
    return out


def bf16_pack(x: torch.Tensor) -> torch.Tensor:
    """K5 on the card: x (float32 or bfloat16, contiguous) -> [n]
    bfloat16 (a bit copy for bfloat16 input)."""
    what = "bf16_pack"
    _check_inputs(what, x)
    _check(x.dtype in _DTYPE_CODES, what, f"dtype {x.dtype} not float32/"
           f"bfloat16")
    n = x.numel()
    out = torch.empty(n, dtype=torch.bfloat16, device=x.device)
    if n:
        _launch(what, _library().codec_bf16_pack, x.data_ptr(),
                out.data_ptr(), n, _DTYPE_CODES[x.dtype], device=x.device)
    return out


def bf16_pack_segments(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`bf16_pack` of every ``xs[j]`` in ONE launch: 1 to
    ``MAX_SEGMENTS`` contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device.  Returns one [n_j] bfloat16 result each:
    views of one contiguous buffer, laid end to end in order."""
    what = "bf16_pack"
    xs = list(xs)
    _check(1 <= len(xs) <= MAX_SEGMENTS, what, f"{len(xs)} segments, not "
           f"1 to {MAX_SEGMENTS}")
    _check_inputs(what, *xs)
    _check(len({x.dtype for x in xs}) == 1 and xs[0].dtype in _DTYPE_CODES,
           what, f"dtypes {sorted({str(x.dtype) for x in xs})}: not one of "
           f"float32/bfloat16")
    flat = torch.empty(sum(x.numel() for x in xs), dtype=torch.bfloat16,
                       device=xs[0].device)
    outs = split_flat(flat, [(x.numel(),) for x in xs])
    rows = [(x.data_ptr(), o.data_ptr(), x.numel())
            for x, o in zip(xs, outs) if x.numel()]
    if rows:
        table = (ctypes.c_int64 * (3 * len(rows)))(*itertools.chain(*rows))
        n_vector = ctypes.c_int(0)
        _launch(what, _library().codec_bf16_pack_segments, table, len(rows),
                _DTYPE_CODES[xs[0].dtype], device=xs[0].device,
                tail=(ctypes.byref(n_vector),))
        segment_paths["vector"] += n_vector.value
        segment_paths["scalar"] += len(rows) - n_vector.value
    return outs
