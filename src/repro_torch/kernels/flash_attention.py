"""Hopper kernel K9: self-attention over one sequence on the tensor cores,
forward and backward, for the train step and a prefill without a KV
cache.

It replaces no TPU kernel (XLA fused the reference's ``models/layers.py::
chunked_attention`` scan on the TPU by itself).  The kernel is CUDA C++
in ``csrc/flash_attention.cu``; its header says what bounds it, the
precision contract and the design.  :func:`forward` is one forward
launch, :func:`backward` one dQ launch and one dK/dV launch, and
:func:`attention` the differentiable op.  bfloat16 operands take the
bf16 route; float32 operands take the float32 route, whose operands are
first split into three bf16 planes (one ``k9_split`` launch an operand),
so that a float32 model still gets float32 products.  This module builds
the source on first use of a width pair and route, one library each
(``kernels/_nvcc.py``, with ``-D`` defines), loads it with ``ctypes``
and launches on PyTorch's current stream.  The plain PyTorch version is
``kernels/ref.py::chunked_attention``; the dispatch
``kernels/ops.py::attention`` picks it for CPU and ``meta`` tensors.
"""

from __future__ import annotations

import collections
import ctypes
import math
import pathlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"

#: (d_qk, d_v) head widths the kernel takes: every width of the port's
#: configurations (MLA's 192 / 128 among them) and examples (32); each a
#: whole number of the MMA's 16-deep steps
WIDTHS = ((32, 32), (64, 64), (112, 112), (128, 128), (192, 128))
#: operand types, one route each
DTYPES = (torch.bfloat16, torch.float32)
#: the longest sequence: query tiles of 64 rows on the grid's y axis
MAX_LEN = 65535 * 64

#: kernel launches since the last reset, by kernel: "forward", "dq",
#: "dkdv", and "split" (the float32 route's planes); the wrappers add one
#: per launch and nowhere else
launch_count: collections.Counter = collections.Counter()

_LOG2E = 1.4426950408889634
_N_ARGS = 36

#: the loaded libraries by (d_qk, d_v, float32 route)
_libs: Dict[Tuple[int, int, bool], ctypes.CDLL] = {}


def variants():
    """The builds of ``csrc/flash_attention.cu``, one a width pair and
    route: (source, its ``-D`` defines) for ``_nvcc.build_all``."""
    return [(SOURCE, _defines(d_qk, d_v, f32)) for d_qk, d_v in WIDTHS
            for f32 in (False, True)]


def _defines(d_qk: int, d_v: int, f32: bool) -> Tuple[str, ...]:
    return (f"-DK9_DQK={d_qk}", f"-DK9_DV={d_v}", f"-DK9_F32={int(f32)}")


def build(d_qk: int, d_v: int, f32: bool) -> Tuple[pathlib.Path, str]:
    """Compile the library of one width pair and route unless it is built
    (kernels/_nvcc.py).  Returns (library path, the compiler's output)."""
    return _nvcc.build(SOURCE, _defines(d_qk, d_v, f32))


def _library(q: torch.Tensor, v: torch.Tensor) -> ctypes.CDLL:
    key = (q.shape[3], v.shape[3], q.dtype == torch.float32)
    if key not in _libs:
        lib = ctypes.CDLL(str(build(*key)[0]))
        p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.k9_launch.argtypes = [c_int, ctypes.POINTER(i64), ctypes.c_float,
                                  ctypes.c_float, p]
        lib.k9_launch.restype = c_int
        lib.k9_split.argtypes = [p, i64, i64, i64, i64, i64, i64, i64, p, p]
        lib.k9_split.restype = c_int
        lib.k9_error_string.argtypes = [c_int]
        lib.k9_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def _fail(msg: str) -> None:
    raise ValueError(f"flash_attention: {msg}")


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.k9_error_string(err).decode()} ({what})")


def _aligned(x: torch.Tensor) -> bool:
    """Rows of 16-byte multiples at a 16-byte address: what the bf16
    route's 16-byte copies read."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in x.stride()[:3])


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          window: Optional[int] = None) -> None:
    """Raise unless K9 takes these operands: CUDA tensors of one device
    and one type of :data:`DTYPES`, q [B, S, Hq, d_qk], k [B, S, Hkv,
    d_qk], v [B, S, Hkv, d_v], Hq a multiple of Hkv, (d_qk, d_v) in
    :data:`WIDTHS`, S at most :data:`MAX_LEN`, the head dim contiguous
    (and, for bfloat16, rows 16-byte aligned), a window of at least 1."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        _fail(f"q, k, v of {q.dim()}, {k.dim()}, {v.dim()} dims, not 4")
    b, s, hq, d_qk = q.shape
    if tuple(k.shape[:2]) != (b, s) or tuple(v.shape[:3]) != tuple(
            k.shape[:3]) or k.shape[3] != d_qk:
        _fail(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
              f"{tuple(v.shape)}: self-attention over one sequence, k "
              f"of q's width")
    hkv, d_v = k.shape[2], v.shape[3]
    if b < 1 or s < 1 or hkv < 1 or hq % hkv or s > MAX_LEN:
        _fail(f"{hq} query heads over {hkv} KV heads, batch {b}, "
              f"length {s} (at most {MAX_LEN})")
    if (d_qk, d_v) not in WIDTHS:
        _fail(f"head widths {d_qk} (q, k) and {d_v} (v): the kernel takes "
              f"{WIDTHS}")
    if q.dtype not in DTYPES or not k.dtype == v.dtype == q.dtype:
        _fail(f"q, k, v of dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
              f"kernel takes bfloat16 or float32, all three alike")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            _fail(f"{name}'s head dim has stride {x.stride(3)}, not 1")
        if x.dtype == torch.bfloat16 and not _aligned(x):
            _fail(f"{name}'s rows (strides {x.stride()[:3]}) are not "
                  f"16-byte aligned")
    if window is not None and int(window) < 1:
        _fail(f"window {window}: at least 1")
    if q.device.type != "cuda":
        _fail(f"operands on {q.device}, not CUDA")
    if not k.device == v.device == q.device:
        _fail(f"operands on {q.device}, {k.device} and {v.device}")


def _split(lib: ctypes.CDLL, x: torch.Tensor, stream: int) -> torch.Tensor:
    """The float32 route's operand: three bf16 planes [3, B, S, H, D]
    whose sum is ``x``."""
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    _raise_on(lib, lib.k9_split(x.data_ptr(), *x.shape, *x.stride()[:3],
                                out.data_ptr(), stream),
              f"split {tuple(x.shape)}")
    launch_count["split"] += 1
    return out


def _operands(lib: ctypes.CDLL, xs, stream: int):
    """(pointer, batch, position and head strides, plane stride) of each
    operand, flat: the tensor itself (bf16), or its planes (float32);
    and the planes, which must outlive the launch that reads them."""
    flat, keep = [], []
    for x in xs:
        if x.dtype == torch.bfloat16:
            flat += [x.data_ptr(), *x.stride()[:3], 0]
            continue
        planes = _split(lib, x, stream)
        keep.append(planes)
        flat += [planes.data_ptr(), *planes.stride()[1:4], planes.stride(0)]
    return flat, keep


def _launch(lib: ctypes.CDLL, kind: int, what: str, ops, outs, q, k, v,
            causal: bool, window: Optional[int], scale: float,
            stream: int) -> None:
    b, s, hq, d_qk = q.shape
    w = (ctypes.c_int64 * _N_ARGS)(
        *ops, *outs, b, s, hq, k.shape[2], d_qk, v.shape[3], int(causal),
        int(window or 0), int(q.dtype == torch.float32))
    _raise_on(lib, lib.k9_launch(kind, w, scale, scale * _LOG2E, stream),
              f"{what} at q {tuple(q.shape)}, v {tuple(v.shape)}")
    launch_count[what] += 1


def _forward(q, k, v, causal: bool, window: Optional[int], scale: float):
    b, s, hq, _ = q.shape
    d_v = v.shape[3]
    o32 = torch.empty((b, s, hq, d_v), dtype=torch.float32, device=q.device)
    o = (o32 if q.dtype == torch.float32 else
         torch.empty((b, s, hq, d_v), dtype=q.dtype, device=q.device))
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = _library(q, v)
        ops, planes = _operands(lib, (q, k, v), stream)
        outs = (0 if o is o32 else o.data_ptr(), o32.data_ptr(),
                lse.data_ptr(), 0, 0, 0, 0)
        _launch(lib, 0, "forward", (*ops, 0, 0, 0, 0, 0), outs, q, k, v,
                causal, window, scale, stream)
        del planes
    return o, o32, lse


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int], scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward launch: (out [B, S, Hq, d_v] in the operands' type,
    the same in float32 before its rounding (the same tensor for float32
    operands), the base-2 log-sum-exp of each row's scaled scores in
    float32 [B, Hq, S]).  The operands are checked (:func:`check`)
    first."""
    check(q, k, v, window=window)
    return _forward(q, k, v, causal, window, float(scale))


def backward(q, k, v, o32, lse, do, *, causal: bool, window: Optional[int],
             scale: float):
    """(dq, dk, dv) in the operands' type from the forward's float32
    output and log-sum-exp: one dQ launch (which also writes D =
    rowsum(dO * O)) and one dK/dV launch.  The operands are the
    forward's, so they are not checked again."""
    if do.dtype != q.dtype or do.shape != o32.shape:
        _fail(f"output gradient {tuple(do.shape)} {do.dtype}, not "
              f"{tuple(o32.shape)} {q.dtype}")
    if do.stride(3) != 1 or (do.dtype == torch.bfloat16
                             and not _aligned(do)):
        do = do.contiguous()
    dq, dk, dv = (torch.empty(x.shape, dtype=q.dtype, device=q.device)
                  for x in (q, k, v))
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = _library(q, v)
        ops, planes = _operands(lib, (q, k, v, do), stream)
        outs = (0, o32.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        for kind, what in ((1, "dq"), (2, "dkdv")):
            _launch(lib, kind, what, ops, outs, q, k, v, causal, window,
                    float(scale), stream)
        del planes
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K9 forward and backward as one differentiable op."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, o32, lse = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, o32, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """``chunked_attention(q, k, v, causal=causal, window=window,
    scale=scale)`` through K9, differentiable in q, k and v; the scale is
    1/sqrt(d_qk) unless given.  Operands K9 does not take raise before
    any launch (:func:`check`)."""
    check(q, k, v, window=window)
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 None if window is None else int(window),
                                 scale)
