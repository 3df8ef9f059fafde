"""Plain PyTorch versions of the port's kernels: the CPU path of
``kernels/ops.py`` and the check every kernel is held against on the card.

Port of ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.codecs import SCALE_CHUNK

ATTN_CHUNK = 512  # KV-axis chunk for the streaming softmax


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


# -- AdamW (kernels/adamw.py: K8) ---------------------------------------------
#
# The optimizer's two passes in plain PyTorch: leaf by leaf, in place, in
# slices of at most UPDATE_SLICE elements, so that the float32 temporaries
# stay a few hundred MiB even for a 151552 x 4096 embedding.
# The per-element formula and its order are the reference's
# (src/repro/optim/adamw.py apply_updates).

#: elements per in-place update slice (64 MiB of float32 a temporary)
UPDATE_SLICE = 1 << 24


def adamw_global_norm_ref(leaves, grad_clip: float):
    """sqrt of the sum of squares of every element of ``leaves``, in
    float32, and the clip factor ``min(1, grad_clip / (gnorm + 1e-9))``:
    (gnorm, scale), float32 scalars on the leaves' device."""
    total = None
    for leaf in leaves:
        for part in leaf.reshape(-1).split(UPDATE_SLICE):
            sq = torch.sum(torch.square(part.float()))
            total = sq if total is None else total + sq
    gnorm = torch.sqrt(total)
    return gnorm, torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)


def adamw_update_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scale: torch.Tensor, *, lr: float,
                     b1: float, b2: float, eps: float, bc1: float,
                     bc2: float, wd: float) -> None:
    """One AdamW step of one leaf, in place on the contiguous ``p`` and its
    float32 moments ``m`` and ``v``: with ``gf = g * scale``,
    ``m = b1 m + (1 - b1) gf``, ``v = b2 v + (1 - b2) gf^2``,
    ``u = (m / bc1) / (sqrt(v / bc2) + eps) + wd p`` and ``p -= lr u``,
    in float32, rounded once to p's dtype."""
    for ps, gs, ms, vs in zip(p.view(-1).split(UPDATE_SLICE),
                              g.reshape(-1).split(UPDATE_SLICE),
                              m.view(-1).split(UPDATE_SLICE),
                              v.view(-1).split(UPDATE_SLICE)):
        gf = gs.float() * scale
        ms.mul_(b1).add_(gf, alpha=1 - b1)       # b1 m + (1 - b1) g
        vs.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        u = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
        if wd:
            u.add_(ps.float(), alpha=wd)
        ps.copy_(ps.float() - lr * u)


# -- self-attention: K9's plain version and the decode paths' attention -----

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int], kv_valid) -> torch.Tensor:
    """Boolean keep-mask [..., Sq, Skv]; q_pos may be [Sq] or [B, Sq] and
    kv_valid a scalar or [B] (per-slot serving positions)."""
    qp = q_pos[..., :, None]                      # [(B,) Sq, 1]
    kp = k_pos[None, :]                           # [1, Skv]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=kp.device)
    if causal:
        m = m & (qp >= kp)
    if window is not None:
        m = m & ((qp - kp) < window)
    if kv_valid is not None:
        kv = torch.as_tensor(kv_valid, device=kp.device)
        if kv.ndim:                               # per-batch [B]
            m = m & (kp < kv[:, None, None])
        else:
            m = m & (kp < kv)
    return m


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int] = None,
                      q_offset=0, k_offset: int = 0, kv_valid=None,
                      chunk: int = ATTN_CHUNK, with_stats: bool = False,
                      scale: Optional[float] = None):
    """Streaming-softmax attention.

    q, k: [B, Sq|Skv, Hq|Hkv, hd] with Hq % Hkv == 0; v: [B, Skv, Hkv,
    hv] (MLA's value width differs from its key width).  The scores are
    scaled by ``scale``, 1/sqrt(hd) unless given.
    Query positions are q_offset+i (q_offset a scalar or [B]), key
    positions k_offset+j (k_offset a host int: the first position of a
    sequence-sharded cache's slice); kv_valid (scalar or [B]) bounds the
    keys attended.  With ``with_stats`` the result is the un-normalised
    (acc [B,Hkv,g,Sq,hv], running max [B,Hkv,g,Sq], denominator
    [B,Hkv,g,Sq]) in float32, for a log-sum-exp merge across shards.
    """
    b, sq, hq, hd = q.shape
    skv, hkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    group = hq // hkv
    dev = q.device
    qf = q.float() * (1.0 / math.sqrt(hd) if scale is None else scale)
    q_off = torch.as_tensor(q_offset, device=dev)
    ar = torch.arange(sq, device=dev)
    q_pos = (q_off[..., None] + ar) if q_off.ndim else (q_off + ar)

    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    local_len = None
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        # padded slots are masked by LOCAL index: a kv_valid bound alone
        # would admit them when no bound is given, or, with a nonzero
        # k_offset, where they alias global positions below it
        local_len = skv
    kc = k.reshape(b, n_chunks, chunk, hkv, hd)
    vc = v.reshape(b, n_chunks, chunk, hkv, hv)
    qg = qf.reshape(b, sq, hkv, group, hd)               # [B,Sq,Hkv,g,hd]

    m_run = torch.full((b, hkv, group, sq), -math.inf, device=dev)
    l_run = torch.zeros((b, hkv, group, sq), device=dev)
    acc = torch.zeros((b, hkv, group, sq, hv), device=dev)
    for ci in range(n_chunks):                   # lax.scan in the reference
        k_local = ci * chunk + torch.arange(chunk, device=dev)
        kf = kc[:, ci].float()
        vf = vc[:, ci].float()
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kf)    # [B,Hkv,g,Sq,chunk]
        keep = _mask(q_pos, k_offset + k_local, causal, window, kv_valid)
        if local_len is not None:
            keep = keep & (k_local < local_len)
        if keep.ndim == 2:                       # [Sq, chunk]
            keep = keep[None, None, None]
        else:                                    # [B, Sq, chunk]
            keep = keep[:, None, None]
        s = torch.where(keep, s, -math.inf)
        m_new = torch.maximum(m_run, s.amax(dim=-1))     # [B,Hkv,g,Sq]
        # guard all-masked rows (m == -inf): exp(-inf - -inf) -> use where
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        finite = torch.isfinite(s)
        p = torch.exp(torch.where(finite, s - m_safe[..., None], -math.inf))
        p = torch.where(finite, p, 0.0)
        alpha = torch.where(torch.isfinite(m_run),
                            torch.exp(m_run - m_safe), 0.0)  # rescale old
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqc,bchd->bhgqd", p, vf)
        m_run = m_new

    if with_stats:
        return acc, m_run, l_run
    denom = torch.clamp(l_run, min=1e-30)
    out = acc / denom[..., None]                          # [B,Hkv,g,Sq,hv]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hv)
    return out.to(q.dtype)
