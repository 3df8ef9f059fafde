"""Hopper kernel K8: the optimizer's AdamW step in two fused passes.

It replaces no TPU kernel (XLA fused the reference's
``optim/adamw.py::apply_updates`` on the TPU by itself).  The kernel is
CUDA C++ in ``csrc/adamw.cu``; its header says what bounds it and what
its design does about that.  :func:`global_norm` runs pass 1 over every
gradient (a sum of squares, one partial a block, then one finalize launch
that writes the norm and the clip factor as device scalars, with no host
sync); :func:`update` runs pass 2, the update of every element in place
on the params and their float32 moments.  Leaves of one (param, grad)
dtype pair go up to :data:`MAX_LEAVES` at a time in one launch.  This
module builds the source on first use (``kernels/_nvcc.py``), loads it
with ``ctypes`` and launches on PyTorch's current stream.  The plain
PyTorch versions are ``kernels/ref.py::adamw_global_norm_ref`` and
``adamw_update_ref``; the dispatchers ``kernels/ops.py::adamw_global_norm``
and ``adamw_update`` pick them for CPU and ``meta`` tensors.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "adamw.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: leaves one launch takes (csrc/adamw.cu kMaxLeaves)
MAX_LEAVES = 16

#: kernel launches since the last reset, by pass: "norm", "norm_finalize",
#: "update"; the wrappers add one per launch and nowhere else
launch_count: collections.Counter = collections.Counter()

#: leaves of :func:`update` launches since the last reset, by the path the
#: kernel took for them: "vector" (all four pointers 16-byte aligned) or
#: "scalar"
leaf_paths: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None


def build() -> Tuple[pathlib.Path, str]:
    """Compile ``csrc/adamw.cu`` unless its library is built
    (kernels/_nvcc.py).  Returns (library path, the compiler's output)."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.k8_norm_tile.argtypes = [c_int]
        lib.k8_norm_tile.restype = i64
        lib.k8_norm.argtypes = [ctypes.POINTER(i64), c_int, c_int, p, i64, p]
        lib.k8_norm.restype = c_int
        lib.k8_norm_finalize.argtypes = [p, i64, ctypes.c_float, p, p]
        lib.k8_norm_finalize.restype = c_int
        lib.k8_update.argtypes = [
            ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_float), c_int,
            c_int, c_int, p, ctypes.POINTER(ctypes.c_float), p,
            ctypes.POINTER(c_int)]
        lib.k8_update.restype = c_int
        lib.k8_error_string.argtypes = [c_int]
        lib.k8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"adamw: {msg}")


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def _check_leaf(x: torch.Tensor, what: str, device, dtypes) -> None:
    _check(_on_cuda(x), f"{what} on {x.device}, not CUDA")
    _check(x.device == device, f"{what} on {x.device}, the first on "
           f"{device}")
    _check(x.dtype in dtypes, f"{what} of dtype {x.dtype}: the kernel "
           f"takes {' and '.join(map(str, dtypes))}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"adamw launch failed: "
                           f"{_library().k8_error_string(err).decode()} "
                           f"({what})")


def _tables(keys: Sequence) -> List[List[int]]:
    """Leaf indices grouped by key (in order of first appearance, each
    group in leaf order), cut into tables of at most MAX_LEAVES."""
    groups: Dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return [idx[j:j + MAX_LEAVES] for idx in groups.values()
            for j in range(0, len(idx), MAX_LEAVES)]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def global_norm(grads: Sequence[torch.Tensor], grad_clip: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sqrt of the sum of squares of every element of ``grads`` and the
    clip factor ``min(1, grad_clip / (gnorm + 1e-9))``, as float32 scalars
    on the card, with no host sync: one norm launch a table of leaves and
    one finalize.

    grads : CUDA tensors of one device, float32 or bfloat16, any shape

    Anything else raises."""
    grads = list(grads)
    _check(len(grads) > 0, "no gradient")
    device = grads[0].device
    for g in grads:
        _check_leaf(g, "gradient", device, tuple(_DTYPE_CODES))
    grads = [g.contiguous() for g in grads if g.numel()]
    lib = _library()
    tile = {c: lib.k8_norm_tile(c) for c in _DTYPE_CODES.values()}
    codes = [_DTYPE_CODES[g.dtype] for g in grads]
    tables = _tables(codes)
    sizes = [sum(-(-grads[i].numel() // tile[codes[i]]) for i in idx)
             for idx in tables]
    partials = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = _stream(device)
        base = 0
        for idx, size in zip(tables, sizes):
            rows = (ctypes.c_int64 * (2 * len(idx)))(*itertools.chain(
                *((grads[i].data_ptr(), grads[i].numel()) for i in idx)))
            err = lib.k8_norm(rows, len(idx), codes[idx[0]],
                              partials.data_ptr() + 4 * base, size, stream)
            _raise_on(err, f"norm over {[grads[i].numel() for i in idx]}")
            launch_count["norm"] += 1
            base += size
        err = lib.k8_norm_finalize(partials.data_ptr(), base,
                                   float(grad_clip), out.data_ptr(), stream)
        _raise_on(err, f"finalize over {base} partials")
        launch_count["norm_finalize"] += 1
    return out[0], out[1]


def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
           wds: Sequence[float], scale: torch.Tensor, *, lr: float,
           b1: float, b2: float, eps: float, bc1: float, bc2: float
           ) -> None:
    """One AdamW step of every leaf, in place on ``params`` and the
    moments: ``kernels/ref.py::adamw_update_ref``'s function, leaf j with
    weight decay ``wds[j]``, one launch a table of leaves.

    params     : contiguous CUDA tensors, float32 or bfloat16
    grads      : float32 or bfloat16, each with its param's element count
    mus, nus   : contiguous float32, each with its param's element count
    scale      : a float32 CUDA scalar (the clip factor)

    all on one device.  Anything else raises."""
    params, grads, mus, nus = (list(x) for x in (params, grads, mus, nus))
    wds = [float(w) for w in wds]
    _check(len({len(params), len(grads), len(mus), len(nus), len(wds)}) == 1,
           f"{len(params)} params, {len(grads)} grads, {len(mus)} and "
           f"{len(nus)} moments, {len(wds)} decays")
    _check(len(params) > 0, "no leaf")
    device = params[0].device
    dtypes = tuple(_DTYPE_CODES)
    _check_leaf(scale, "scale", device, (torch.float32,))
    _check(scale.numel() == 1, f"scale of {scale.numel()} elements")
    for j, (p, g, m, v) in enumerate(zip(params, grads, mus, nus)):
        _check_leaf(p, f"param {j}", device, dtypes)
        _check_leaf(g, f"grad {j}", device, dtypes)
        for x, name in ((m, "first moment"), (v, "second moment")):
            _check_leaf(x, f"{name} {j}", device, (torch.float32,))
        _check(g.numel() == m.numel() == v.numel() == p.numel(),
               f"leaf {j}: {p.numel()} params, {g.numel()} grads, "
               f"{m.numel()} and {v.numel()} moments")
        _check(p.is_contiguous() and m.is_contiguous() and v.is_contiguous(),
               f"leaf {j}: a non-contiguous param or moment (updated in "
               f"place)")
    live = [j for j, p in enumerate(params) if p.numel()]
    grads = [g.contiguous() for g in grads]
    f32 = np.float32
    # each host float as PyTorch hands a Python scalar to a float32 kernel
    hyper = (ctypes.c_float * 8)(*(float(f32(x)) for x in (
        lr, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps)))
    lib = _library()
    keys = [(_DTYPE_CODES[params[j].dtype], _DTYPE_CODES[grads[j].dtype])
            for j in live]
    with torch.cuda.device(device):
        stream = _stream(device)
        for idx in _tables(keys):
            leaves = [live[i] for i in idx]
            rows = (ctypes.c_int64 * (5 * len(leaves)))(*itertools.chain(*(
                (params[j].data_ptr(), grads[j].data_ptr(),
                 mus[j].data_ptr(), nus[j].data_ptr(), params[j].numel())
                for j in leaves)))
            decay = (ctypes.c_float * len(leaves))(*(wds[j] for j in leaves))
            n_vector = ctypes.c_int(0)
            p_code, g_code = keys[idx[0]]
            err = lib.k8_update(rows, decay, len(leaves), p_code, g_code,
                                scale.data_ptr(), hyper, stream,
                                ctypes.byref(n_vector))
            _raise_on(err, f"update over "
                           f"{[params[j].numel() for j in leaves]}")
            launch_count["update"] += 1
            leaf_paths["vector"] += n_vector.value
            leaf_paths["scalar"] += len(leaves) - n_vector.value
