"""Plain PyTorch versions of the port's kernels: the CPU path of
``kernels/ops.py`` and the check every kernel is held against on the card.

Port of ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.codecs import SCALE_CHUNK


def split_flat(flat: torch.Tensor, shapes) -> list:
    """Views of the flat ``flat``, one of each shape, laid end to end: the
    per-segment results of a list-form kernel call."""
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def chunk_accumulate_ref(a: torch.Tensor, b: torch.Tensor, *,
                         acc_dtype=torch.float32) -> torch.Tensor:
    """The staged ring's step reduce: ``a + b`` in ``acc_dtype``, rounded
    once to a's dtype."""
    return (a.to(acc_dtype) + b.to(acc_dtype)).to(a.dtype)


def paged_flash_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           kv_valid: torch.Tensor, *,
                           window=None) -> torch.Tensor:
    """Dense-gather version of kernels/flash_decode.py: materialize every
    row's [S, Hkv, hd] K/V via its block table, one fp32 softmax over the
    ``kv_valid`` prefix.  Masked scores are -inf, masked probabilities
    exact zeros, all-masked rows (kv_valid == 0, bucket padding) return
    exact zeros."""
    t_rows, hq, hd = q.shape
    nb, bs, hkv, _ = k_pool.shape
    maxb = block_tables.shape[1]
    s_len = maxb * bs
    flat = (block_tables[:, :, None].long() * bs +
            torch.arange(bs, device=q.device)[None, None, :]
            ).reshape(t_rows, s_len)
    k = k_pool.reshape(nb * bs, hkv, hd)[flat].float()
    v = v_pool.reshape(nb * bs, hkv, hd)[flat].float()
    group = hq // hkv
    qg = (q.float() / math.sqrt(hd)).reshape(t_rows, hkv, group, hd)
    s = torch.einsum("tkgd,tskd->tkgs", qg, k)
    k_pos = torch.arange(s_len, device=q.device)[None, :]
    kvv = kv_valid[:, None]
    keep = k_pos < kvv
    if window is not None:
        keep = keep & ((kvv - 1 - k_pos) < window)
    s = torch.where(keep[:, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    out = torch.einsum("tkgs,tskd->tkgd", p, v) / \
        torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(t_rows, hq, hd).to(q.dtype)


# -- wire codecs (kernels/codec.py: K2-K5) ------------------------------------
#
# The wire form is flat: values [n] plus one float32 scale per SCALE_CHUNK
# consecutive elements, ceil(n / SCALE_CHUNK) of them, the last covering
# the tail.  The reference pads to [rows, 128] tiles first; its padding is
# zeros, which change no group's abs-max, so the two forms carry the same
# values and scales.

#: saturation range of each fp8 wire format
FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
WIRE_DTYPE = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
#: floor for the per-chunk scale so all-zero chunks stay finite
_SCALE_TINY = 1e-30
#: the byte every NaN quantizes to: the reference's (ml_dtypes') positive
#: NaN of each format.  The sign of a NaN out of an arithmetic op differs
#: between CPUs and cards, so both the kernel and this version write one
#: canonical byte.
FP8_NAN_BYTE = {"fp8_e4m3": 0x7F, "fp8_e5m2": 0x7E}


def n_scales(n: int) -> int:
    return -(-n // SCALE_CHUNK)


def bf16_pack_ref(x: torch.Tensor) -> torch.Tensor:
    """K5: the half-width pack, a cast to bfloat16 (exact for bf16)."""
    return x.reshape(-1).to(torch.bfloat16)


def fp8_encode_ref(x: torch.Tensor, *, fmt: str = "fp8_e4m3"):
    """K2: per group of 128 flat elements, ``amax = max |x|`` (NaN
    propagates), ``scale = max(amax, 1e-30) * fp32(1/FP8_MAX)`` and
    ``vals = fp8(x / scale)``.  The scale multiplies by the float32
    reciprocal, as XLA compiles the reference's division by a constant;
    ``x / scale`` is a true division.  Returns (vals [n] in the wire
    dtype, scales [ceil(n/128)] float32)."""
    xf = x.reshape(-1).float()
    n = xf.numel()
    pad = (-n) % SCALE_CHUNK
    groups = torch.cat([xf, xf.new_zeros(pad)]).view(-1, SCALE_CHUNK)
    amax = groups.abs().amax(dim=1)
    inv = torch.tensor(1.0 / FP8_MAX[fmt], dtype=torch.float32,
                       device=x.device)
    scale = torch.maximum(amax, torch.tensor(_SCALE_TINY, device=x.device)
                          ) * inv
    q = (groups / scale[:, None]).reshape(-1)[:n]
    vals = q.to(WIRE_DTYPE[fmt])
    nan = torch.tensor(FP8_NAN_BYTE[fmt], dtype=torch.uint8, device=x.device)
    vals = torch.where(torch.isnan(q), nan, vals.view(torch.uint8))
    return vals.view(WIRE_DTYPE[fmt]), scale


def _per_element(scales: torch.Tensor, n: int) -> torch.Tensor:
    return scales.repeat_interleave(SCALE_CHUNK)[:n]


def fp8_decode_ref(vals: torch.Tensor, scales: torch.Tensor, *,
                   out_dtype=torch.float32) -> torch.Tensor:
    """K4: ``fp32(v * scale)``, then cast to ``out_dtype``."""
    v = vals.reshape(-1).float()
    return (v * _per_element(scales, v.numel())).to(out_dtype)


def _round_to_odd_f32(p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``p + b`` for float64 ``p`` and ``b``, rounded ONCE to float32.

    The double sum is rounded to odd (inexact results keep a set last
    bit, from the exact TwoSum error), and a 53-bit round-to-odd value
    rounds to 24 bits exactly as the exact sum would: no double rounding.
    """
    d = p + b
    bb = d - p
    err = (p - (d - bb)) + (b - bb)           # TwoSum: p + b == d + err
    bits = d.view(torch.int64)
    mag = bits & 0x7FFFFFFFFFFFFFFF
    # the truncation of the exact sum toward zero: d itself when the
    # error points away from zero, else one ulp below |d|
    inexact = (err != 0) & torch.isfinite(d)
    toward_zero = inexact & ((err < 0) != (d < 0))
    mag = torch.where(toward_zero, mag - 1, mag)
    mag = torch.where(inexact, mag | 1, mag)
    odd = (mag | (bits & ~0x7FFFFFFFFFFFFFFF)).view(torch.float64)
    return odd.to(torch.float32)


def fp8_decode_accumulate_ref(vals: torch.Tensor, scales: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """K3: ``cast_b(fma(fp32 v, scale, fp32 b))`` — one fused multiply-add
    with a single rounding, as XLA compiles the reference's
    ``v * scale + b``.  The product of an fp8 value and a float32 scale is
    exact in float64, and the sum is rounded once to float32."""
    v = vals.reshape(-1).double()
    bf = b.reshape(-1)
    prod = v * _per_element(scales, v.numel()).double()
    out = _round_to_odd_f32(prod, bf.double())
    return out.to(b.dtype).reshape(b.shape)


# -- payload split / merge (kernels/payload_partition.py: K7) ----------------

#: elements per block of the reference's payload partition (1024 rows of
#: 128 lanes: 512 KiB of float32)
BLOCK = 1024 * 128


def extract_segment_ref(x: torch.Tensor, start_block: int, n_blocks: int, *,
                        block: int = BLOCK) -> torch.Tensor:
    """K7a: a copy of ``x[start_block * block : (start_block + n_blocks) *
    block]`` of a flat payload."""
    return x[start_block * block:(start_block + n_blocks) * block].clone()


def merge_segments_ref(segments) -> torch.Tensor:
    """K7b: the flat segments concatenated in order."""
    return torch.cat(list(segments))
