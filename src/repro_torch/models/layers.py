"""Shared model layers: RMSNorm, RoPE, chunked (flash-style) attention with
GQA/SWA, SwiGLU MLP.

Port of ``src/repro/models/layers.py``.  Plain functions on tensors, with
the reference's conventions:

  * activations are [B, S, D]; attention heads live in [B, S, H, hd];
  * attention is computed in chunks of ``ATTN_CHUNK`` over the KV axis with
    running max/denominator, the same -inf/isfinite guards and the same
    padding, so masked lanes contribute exact zeros;
  * ``init_*`` build GLOBAL-shaped dict trees (K/V projections stored
    full) from an explicit ``torch.Generator`` and device and a leading
    ``lead`` shape, so ``init_params`` draws stacked [L, ...] layers in one
    call;
  * tensor parallelism shards Q heads over the model axis: column-parallel
    Q / gate / up projections, row-parallel out / down projections
    combined by ``ctx.tp_all_reduce``; each shard slices the KV heads its
    Q heads attend to out of the replicated K/V projections
    (``_kv_slice``).  ``attention_specs`` / ``mlp_specs`` name the sharded
    dim of each leaf (convert.py cuts a rank's shard by them).

Training and prefill run at any tp.  The decode paths (dense cache and
paged pool) run at tp = 1 and raise above it: the sequence-sharded decode
(the reference's ``seq_shard``) and serving across devices come with
ROADMAP queue 1 item 11; cross-attention with item 9.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx

ATTN_CHUNK = 512  # KV-axis chunk for the streaming softmax


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] or [B, S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # [hd/2]
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, :, None, :]                      # [1, S, 1, hd/2]
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, :, None, :]                         # [B, S, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------

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
                      q_offset=0, kv_valid=None,
                      chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Streaming-softmax attention.

    q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd] with Hq % Hkv == 0.
    Query positions are q_offset+i (q_offset a scalar or [B]), key
    positions j; kv_valid (scalar or [B]) bounds the keys attended.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qf = q.float() * (1.0 / math.sqrt(hd))
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
        # would admit them when no bound is given
        local_len = skv
    kc = k.reshape(b, n_chunks, chunk, hkv, hd)
    vc = v.reshape(b, n_chunks, chunk, hkv, hd)
    qg = qf.reshape(b, sq, hkv, group, hd)               # [B,Sq,Hkv,g,hd]

    m_run = torch.full((b, hkv, group, sq), -math.inf, device=dev)
    l_run = torch.zeros((b, hkv, group, sq), device=dev)
    acc = torch.zeros((b, hkv, group, sq, hd), device=dev)
    for ci in range(n_chunks):                   # lax.scan in the reference
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        kf = kc[:, ci].float()
        vf = vc[:, ci].float()
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kf)    # [B,Hkv,g,Sq,chunk]
        keep = _mask(q_pos, k_pos, causal, window, kv_valid)
        if local_len is not None:
            keep = keep & (k_pos < local_len)
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

    denom = torch.clamp(l_run, min=1e-30)
    out = acc / denom[..., None]                          # [B,Hkv,g,Sq,hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def head_layout(cfg: ArchConfig, ctx: ParallelCtx):
    """(hq_local, kv_width, group_local): local Q heads, KV heads a shard
    needs, and Q-heads-per-KV-head locally."""
    tp = max(ctx.tp_size, 1)
    hq = cfg.n_heads
    hkv = cfg.n_kv_heads
    assert hq % tp == 0 or tp == 1, (hq, tp)
    hq_l = hq // tp if tp > 1 else hq
    group = hq // hkv
    if hq_l >= group:
        assert hq_l % group == 0, (hq_l, group)
        kv_w = hq_l // group
    else:
        assert group % hq_l == 0, (hq_l, group)
        kv_w = 1
    return hq_l, kv_w, hq_l // kv_w


def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 0.02^2) draws in ``dtype`` — the reference's init std."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device) * 0.02


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, device,
                   lead: Tuple[int, ...] = ()):
    """GLOBAL param shapes, with ``lead`` prepended (the [L] stack)."""
    d, hd = cfg.d_model, cfg.head_dim_
    p = {
        "wq": _normal(gen, lead + (d, cfg.n_heads * hd), dtype, device),
        "wk": _normal(gen, lead + (d, cfg.n_kv_heads * hd), dtype, device),
        "wv": _normal(gen, lead + (d, cfg.n_kv_heads * hd), dtype, device),
        "wo": _normal(gen, lead + (cfg.n_heads * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(lead + (width * hd,), dtype=dtype,
                                  device=device)
    return p


def attention_specs(cfg: ArchConfig, model_axis: str = "model"):
    """Per leaf of init_attention, the mesh axis of each dim (None:
    replicated), as the reference's PartitionSpecs: Q/O sharded over the
    heads, K/V replicated."""
    p = {"wq": (None, model_axis), "wk": (None, None), "wv": (None, None),
         "wo": (model_axis, None)}
    if cfg.qkv_bias:
        p.update(bq=(model_axis,), bk=(None,), bv=(None,))
    return p


def _kv_slice(p, cfg: ArchConfig, ctx: ParallelCtx, which: str):
    """The KV-projection weight and bias columns of this shard's KV heads:
    ``kv_w`` heads from ``first_kv = idx * hq_l * n_kv // n_heads``."""
    hd = cfg.head_dim_
    hq_l, kv_w, _ = head_layout(cfg, ctx)
    w, bias = p["w" + which], p.get("b" + which)
    if ctx.tp_size <= 1 or kv_w == cfg.n_kv_heads:
        return w, bias
    first = ctx.tp_index() * hq_l * cfg.n_kv_heads // cfg.n_heads * hd
    w = w[..., first:first + kv_w * hd]
    if bias is not None:
        bias = bias[..., first:first + kv_w * hd]
    return w, bias


def _one_shard(ctx: ParallelCtx, what: str) -> None:
    if ctx.tp_size > 1:
        raise NotImplementedError(
            f"{what} at tp = {ctx.tp_size}: serving across devices is not "
            f"ported yet (ROADMAP queue 1 item 11)")


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx):
    """Q [B,S,Hq_l,hd], K and V [B,S,kv_w,hd] before RoPE."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    hq_l, kv_w, _ = head_layout(cfg, ctx)
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    wk, bk = _kv_slice(p, cfg, ctx, "k")
    wv, bv = _kv_slice(p, cfg, ctx, "v")
    k = x @ wk
    v = x @ wv
    if bk is not None:
        k, v = k + bk, v + bv
    return (q.reshape(b, s, hq_l, hd), k.reshape(b, s, kv_w, hd),
            v.reshape(b, s, kv_w, hd))


def attention_block(p, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx,
                    *, causal: bool = True, positions=None,
                    kv_cache=None, cache_pos=None, window_override="cfg"):
    """One attention sublayer (pre-norm handled by the caller).

    kv_cache: (k, v) of [B, S_cache, kv_w, hd] — decode mode; x holds the
      new token(s), cache_pos the write position (scalar, or [B] for
      single-token steps with per-slot positions).
    window_override: "cfg" uses cfg.sliding_window; None/int overrides.
    Returns (out [B,S,D], new_cache); the cache argument is not modified.
    """
    b, s, d = x.shape
    hq_l = head_layout(cfg, ctx)[0]
    window = cfg.sliding_window if window_override == "cfg" \
        else window_override
    if positions is None:
        positions = torch.arange(s, device=x.device)

    q, k, v = _project_qkv(p, x, cfg, ctx)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is None:
        out = chunked_attention(q, k, v, causal=causal, window=window)
    else:
        _one_shard(ctx, "the dense decode path")
        ck, cv = kv_cache
        pos_arr = torch.as_tensor(cache_pos, device=x.device)
        if pos_arr.ndim:                     # per-slot positions [B]
            assert s == 1, "vector cache_pos requires single-token steps"
            sl = torch.arange(ck.shape[1], device=x.device)
            hit = (sl[None] == pos_arr[:, None])[:, :, None, None]
            ck = torch.where(hit, k.to(ck.dtype), ck)
            cv = torch.where(hit, v.to(cv.dtype), cv)
        else:
            # dynamic_update_slice semantics: the start clamps so the
            # update fits
            start = min(max(int(cache_pos), 0), ck.shape[1] - s)
            ck, cv = ck.clone(), cv.clone()
            ck[:, start:start + s] = k.to(ck.dtype)
            cv[:, start:start + s] = v.to(cv.dtype)
        new_cache = (ck, cv)
        # causal=True keeps multi-token decode steps correct; for s == 1
        # it is equivalent to the kv_valid bound alone
        out = chunked_attention(q, ck, cv, causal=True, window=window,
                                q_offset=pos_arr, kv_valid=pos_arr + s)

    o = out.reshape(b, s, hq_l * cfg.head_dim_) @ p["wo"]
    o = ctx.tp_all_reduce(o)       # row-parallel combine
    return o, new_cache


# ---------------------------------------------------------------------------
# paged attention (continuous-batching serving, DESIGN.md §13)
# ---------------------------------------------------------------------------

def paged_attention_block(p, x: torch.Tensor, cfg: ArchConfig,
                          ctx: ParallelCtx, *, positions: torch.Tensor,
                          kv_valid: torch.Tensor, pools, block_tables,
                          window_override="cfg",
                          impl: str = "reference"):
    """One attention sublayer over a PAGED KV pool (packed serving layout).

    x            : [T, 1, D] — T packed single-token rows
    positions    : [T] int per-row positions (0 for padding rows)
    kv_valid     : [T] int — row t attends cache positions < kv_valid[t];
                   0 marks a bucket-padding row (zero attention mass, no
                   pool write)
    pools        : (k_pool, v_pool) [n_blocks, block_size, kv_w, hd] — ONE
                   layer's physical block pool, contiguous; UPDATED IN
                   PLACE (the reference returns new pools)
    block_tables : [T, max_blocks] int — per-ROW tables
    impl         : "reference" (dense block-gather + chunked_attention,
                   the oracle that matches the wave engine's dense-cache
                   path) or "kernel" (kernels/ops.paged_flash_decode)

    The new K/V are scattered into the pool BEFORE attention, so later rows
    of the same request in the same step see earlier rows' K/V.  Padding
    rows write nothing and read an all-masked accumulator (exact zeros).

    Returns (out [T, 1, D], (k_pool, v_pool)).
    """
    _one_shard(ctx, "paged attention")
    b, s, d = x.shape
    assert s == 1, "paged attention packs single-token rows"
    hd = cfg.head_dim_
    hq_l, kv_w, _ = head_layout(cfg, ctx)
    window = cfg.sliding_window if window_override == "cfg" \
        else window_override

    q, k, v = _project_qkv(p, x, cfg, ctx)
    if cfg.rope_theta:
        pos2 = positions[:, None]                 # [T, 1] per-row
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)

    kp, vp = pools
    nb, bs_blk = kp.shape[0], kp.shape[1]
    blk = (positions // bs_blk).long()
    phys = torch.gather(block_tables, 1, blk[:, None])[:, 0].long()
    dest = phys * bs_blk + (positions % bs_blk).long()
    # padding rows write nowhere (the reference drops an OOB destination)
    rows = torch.nonzero(kv_valid > 0).squeeze(1)
    kp_flat = kp.view(nb * bs_blk, kv_w, hd)
    vp_flat = vp.view(nb * bs_blk, kv_w, hd)
    kp_flat.index_copy_(0, dest[rows], k[rows, 0].to(kp.dtype))
    vp_flat.index_copy_(0, dest[rows], v[rows, 0].to(vp.dtype))

    if impl == "kernel":
        out = K.paged_flash_decode(q[:, 0], kp, vp, block_tables, kv_valid,
                                   window=window)[:, None]
    elif impl == "reference":
        # dense block-gather: index i of the gathered view IS position i,
        # so this matches the wave engine's dense-cache chunked_attention
        maxb = block_tables.shape[1]
        src = (block_tables[:, :, None].long() * bs_blk +
               torch.arange(bs_blk, device=x.device)[None, None, :]
               ).reshape(b, maxb * bs_blk)
        out = chunked_attention(q, kp_flat[src], vp_flat[src], causal=True,
                                window=window, q_offset=positions,
                                kv_valid=kv_valid)
    else:
        raise ValueError(f"attn impl {impl!r}: 'reference' or 'kernel'")

    o = out.reshape(b, s, hq_l * hd) @ p["wo"]
    o = ctx.tp_all_reduce(o)       # row-parallel combine
    return o, (kp, vp)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             lead: Tuple[int, ...] = (), d_ff=None):
    """GLOBAL shapes, with ``lead`` prepended (the [L] stack)."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": _normal(gen, lead + (d, f), dtype, device),
        "w_up": _normal(gen, lead + (d, f), dtype, device),
        "w_down": _normal(gen, lead + (f, d), dtype, device),
    }


def mlp_specs(model_axis: str = "model"):
    """Per leaf of init_mlp, the mesh axis of each dim: gate/up column-,
    down row-parallel."""
    return {"w_gate": (None, model_axis), "w_up": (None, model_axis),
            "w_down": (model_axis, None)}


def mlp_block(p, x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return ctx.tp_all_reduce(h @ p["w_down"])  # row-parallel combine
