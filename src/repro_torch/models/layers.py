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

Every path runs at any tp: training and prefill, cross-attention
(``xattn_kv``, the encdec family's decoder), the decode over a local cache
and over a paged pool (this shard's ``kv_w`` heads), and the
sequence-sharded decode (``seq_shard``, ``_seq_sharded_decode``): the
cache's sequence dim is split over the model axis (and the data axis too
for batch 1), every shard attends all heads over its slice, and the
partials merge by a distributed log-sum-exp.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.models.config import ArchConfig, MLAConfig, mla_of
from repro_torch.models.tp import ParallelCtx
from repro_torch.runtime import spans

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


def yarn_freqs(mla: MLAConfig, theta: float, device=None) -> torch.Tensor:
    """The RoPE frequencies of MLA's ``qk_rope_head_dim`` dims under YaRN
    (DeepSeek-V3's form): pair i keeps theta^(-2i/dim) below the ramp's
    ``low``, is divided by the factor from its ``high`` on, and is mixed
    linearly between."""
    dim = mla.qk_rope_head_dim
    extra = rope_freqs(dim, theta, device)
    low, high = mla.yarn_ramp(theta)
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ramp = torch.clamp((i - low) / max(high - low, 1e-3), 0, 1)
    inter = extra / mla.rope_scaling["factor"]
    return inter * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, freqs: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] or [B, S].  ``freqs`` [hd/2]
    replaces theta's (``yarn_freqs``)."""
    hd = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(hd, theta, x.device)          # [hd/2]
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


def lse_merge(parts):
    """Merge per-shard ``(acc [B,Hkv,g,Sq,hd], m, l [B,Hkv,g,Sq])``
    attention partials (``chunked_attention(..., with_stats=True)``) into
    the normalised ``[B,Hkv,g,Sq,hd]`` accumulator: a shard whose ``m`` is
    -inf adds nothing, the normaliser is clamped at 1e-30 (the reference's
    ``lse_merge``, layers.py:174)."""
    m_glob = parts[0][1]
    for _, m, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, m)
    m_safe = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    l_tot = torch.zeros_like(parts[0][2])
    acc_tot = torch.zeros_like(parts[0][0])
    for acc, m, l in parts:
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l_tot = l_tot + l * alpha
        acc_tot = acc_tot + acc * alpha[..., None]
    return acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]


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
    if mla_of(cfg) is not None:
        return init_mla(gen, cfg, dtype, device, lead)
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
    heads, K/V replicated.  MLA's leaves are all replicated: it runs
    without a model axis."""
    if mla_of(cfg) is not None:
        return {k: (None,) * (1 if k.endswith("norm") else 2)
                for k in MLA_LEAVES}
    p = {"wq": (None, model_axis), "wk": (None, None), "wv": (None, None),
         "wo": (model_axis, None)}
    if cfg.qkv_bias:
        p.update(bq=(model_axis,), bk=(None,), bv=(None,))
    return p


#: MLA's leaves: the query path (``wq_a``, its norm, ``wq_b``), the
#: key/value path (``wkv_a`` to the latent and the shared RoPE key, its
#: norm, ``wkv_b``) and the output projection
MLA_LEAVES = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             lead: Tuple[int, ...] = ()):
    """MLA's GLOBAL param shapes (``MLA_LEAVES``), ``lead`` prepended;
    norms ones."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads

    def ones(n):
        return torch.ones(lead + (n,), dtype=dtype, device=device)
    return {
        "wq_a": _normal(gen, lead + (d, m.q_lora_rank), dtype, device),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": _normal(gen, lead + (m.q_lora_rank, h * m.qk_head_dim),
                        dtype, device),
        "wkv_a": _normal(gen, lead + (d, m.kv_lora_rank
                                      + m.qk_rope_head_dim), dtype, device),
        "kv_norm": ones(m.kv_lora_rank),
        "wkv_b": _normal(gen, lead + (m.kv_lora_rank, h * (
            m.qk_nope_head_dim + m.v_head_dim)), dtype, device),
        "wo": _normal(gen, lead + (h * m.v_head_dim, d), dtype, device),
    }


def mla_core(p, x: torch.Tensor, cfg: ArchConfig,
             positions: torch.Tensor) -> torch.Tensor:
    """MLA's expanded form, as trained (DeepSeek-V2 §2.1): [B,S,D] ->
    [B,S,H,v_head_dim], before ``wo``.

    Span ``mla.latent``: c_q = RMSNorm(x W_qa), q = c_q W_qb, each head
    [q_nope | q_rope]; [c_kv | k_rope] = x W_kva, kv = RMSNorm(c_kv)
    W_kvb, each head [k_nope | v]; q_rope and the one k_rope rotated
    (half-split pairs, the YaRN frequencies), k_rope shared by every
    head.  Span ``mla.core``: causal attention over the expanded heads,
    at the YaRN-scaled softmax scale."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    with spans.span("mla.latent") as sp:
        x = sp.inputs(x)
        cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
        q = (cq @ p["wq_b"]).reshape(b, s, h, m.qk_head_dim)
        ckv, k_rope = (x @ p["wkv_a"]).split([m.kv_lora_rank, rope], dim=-1)
        kv = (rms_norm(ckv, p["kv_norm"], cfg.norm_eps) @ p["wkv_b"]
              ).reshape(b, s, h, nope + m.v_head_dim)
        k_nope, v = kv.split([nope, m.v_head_dim], dim=-1)
        freqs = yarn_freqs(m, cfg.rope_theta, x.device)
        q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta, freqs)
        k_rope = apply_rope(k_rope[:, :, None], positions, cfg.rope_theta,
                            freqs)
        q = torch.cat([q[..., :nope], q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
        q, k, v = sp.outputs(q, k, v)
    with spans.span("mla.core") as sp:
        q, k, v = sp.inputs(q, k, v)
        return sp.outputs(chunked_attention(
            q, k, v, causal=True, window=cfg.sliding_window,
            scale=m.softmax_scale))


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


def _project_q(p, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx):
    """Q [B,S,Hq_l,hd] before RoPE."""
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(*x.shape[:2], head_layout(cfg, ctx)[0], cfg.head_dim_)


def _project_kv(p, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx,
                all_heads: bool = False):
    """K and V [B,S,kv_w,hd] of this shard's KV heads, before RoPE (also
    the cross-attention K/V of an encoder output); ``all_heads`` projects
    every KV head with the full ``wk``/``wv`` (a sequence-sharded shard
    attends all heads over its slice)."""
    b, s, _ = x.shape
    if all_heads:
        kv_w = cfg.n_kv_heads
        wk, bk = p["wk"], p.get("bk")
        wv, bv = p["wv"], p.get("bv")
    else:
        kv_w = head_layout(cfg, ctx)[1]
        wk, bk = _kv_slice(p, cfg, ctx, "k")
        wv, bv = _kv_slice(p, cfg, ctx, "v")
    k = x @ wk
    v = x @ wv
    if bk is not None:
        k, v = k + bk, v + bv
    return (k.reshape(b, s, kv_w, cfg.head_dim_),
            v.reshape(b, s, kv_w, cfg.head_dim_))


def attention_block(p, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx,
                    *, causal: bool = True, positions=None,
                    kv_cache=None, cache_pos=None, seq_shard=None,
                    window_override="cfg", xattn_kv=None):
    """One attention sublayer (pre-norm handled by the caller).

    kv_cache: (k, v) of [B, S_cache_local, kv_w, hd] — decode mode; x holds
      the new token(s), cache_pos the global write position (scalar, or
      [B] for single-token steps with per-slot positions).
    seq_shard: None (a local cache of this shard's kv_w heads), "model" or
      "model_data": the cache's sequence dim is split over the model axis
      (and the data axis too, for batch 1), each shard holding all
      n_kv_heads of its slice; cache_pos is then a host int
      (``_seq_sharded_decode``).
    xattn_kv: precomputed (k, v) [B, S_enc, kv_w, hd] for cross-attention:
      only Q is projected, and attended over them unmasked, without RoPE
      (the reference ropes neither side there) and without a cache write.
    window_override: "cfg" uses cfg.sliding_window; None/int overrides.
    Returns (out [B,S,D], new_cache); the cache argument is not modified.
    An MLA config (``mla_core``) runs causal self-attention only, on one
    model-axis rank.
    """
    b, s, d = x.shape
    mla = mla_of(cfg) is not None
    if mla and (ctx.tp_size > 1 or kv_cache is not None
                or xattn_kv is not None):
        raise ValueError("MLA runs causal self-attention in the train and "
                         "prefill forward on a mesh without a model axis; "
                         "a model axis, a KV cache and cross-attention are "
                         "not built for it")
    hq_l = head_layout(cfg, ctx)[0]
    window = cfg.sliding_window if window_override == "cfg" \
        else window_override
    if positions is None:
        positions = torch.arange(s, device=x.device)

    new_cache = None
    with spans.span("attn") as sp:
        x = sp.inputs(x)
        if mla:
            out = mla_core(p, x, cfg, positions)
        elif xattn_kv is not None:
            out = chunked_attention(_project_q(p, x, cfg, ctx), *xattn_kv,
                                    causal=False, window=None)
        else:
            out, new_cache = _self_attention(p, x, cfg, ctx, causal,
                                             positions, kv_cache, cache_pos,
                                             seq_shard, window)
        o = out.reshape(b, s, hq_l * cfg.head_dim_) @ p["wo"]
        o = sp.outputs(ctx.tp_all_reduce(o))       # row-parallel combine
    return o, new_cache


def _self_attention(p, x, cfg: ArchConfig, ctx: ParallelCtx, causal,
                    positions, kv_cache, cache_pos, seq_shard, window):
    """Self-attention of ``attention_block``: (out [B,S,Hq_l,hd],
    new_cache), the cache written when one is given."""
    s = x.shape[1]
    seq = kv_cache is not None and seq_shard is not None
    q = _project_q(p, x, cfg, ctx)
    k, v = _project_kv(p, x, cfg, ctx, all_heads=seq)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        return chunked_attention(q, k, v, causal=causal, window=window), None
    if seq:
        return _seq_sharded_decode(q, k, v, kv_cache, cache_pos, ctx,
                                   window, seq_shard)
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
    # causal=True keeps multi-token decode steps correct; for s == 1
    # it is equivalent to the kv_valid bound alone
    return chunked_attention(q, ck, cv, causal=True, window=window,
                             q_offset=pos_arr, kv_valid=pos_arr + s), \
        (ck, cv)


def _seq_sharded_decode(q, k_new, v_new, kv_cache, cache_pos: int,
                        ctx: ParallelCtx, window, seq_shard="model"):
    """Decode attention over a cache whose SEQUENCE dim is sharded over
    the model axis (and the data axis too for batch 1, ``"model_data"``).

    Q heads are sharded over the model axis, and so is the sequence, so
    the standard flash-decode distribution: (1) all-gather the (tiny) Q
    over the model axis so every shard holds ALL heads, issued as its own
    in-flight plan on the ctx's side stream; (2) write the new token's
    full-head K/V into the owning shard's slice (a host branch on the host
    int ``cache_pos``), the overlap window, after which the current stream
    waits for the gather; (3) local partial attention over the slice at
    its global positions; (4) the log-sum-exp merge over the sharding
    axes; (5) this shard's own Q heads, for the row-parallel ``wo``.
    """
    b, s, hq_l, hd = q.shape
    ck, cv = kv_cache
    s_local = ck.shape[1]
    cache_pos = int(cache_pos)
    tp = max(ctx.tp_size, 1)
    shard_idx = ctx.tp_index()
    seq_idx = shard_idx
    if seq_shard == "model_data":
        seq_idx = ctx.dp_index() * tp + shard_idx
    offset = seq_idx * s_local

    # (1) full-head Q on every shard (B x Hq x hd bytes); the gather
    # overlaps the cache write below, which needs no Q.  Layers >= 1 run
    # under unrecorded() and repeat the first layer's scope
    if tp > 1:
        with ctx.issue("q_ag", repeats=True):
            qg = ctx.tp_all_gather(q.permute(2, 0, 1, 3).contiguous(),
                                   tiled=True)

    # (2) the new token's K/V into the owning shard (the reference's
    # clip(local_pos, 0, s_local - s) under its `owns` select)
    local_pos = cache_pos - offset
    if 0 <= local_pos < s_local:
        start = min(local_pos, s_local - s)
        ck, cv = ck.clone(), cv.clone()
        ck[:, start:start + s] = k_new.to(ck.dtype)
        cv[:, start:start + s] = v_new.to(cv.dtype)
    q_full = ctx.join_issued(qg).permute(1, 2, 0, 3) if tp > 1 else q
    hq = q_full.shape[2]

    # (3) local partial attention at global positions
    acc, m, l = chunked_attention(
        q_full, ck, cv, causal=True, window=window, q_offset=cache_pos,
        k_offset=offset, kv_valid=cache_pos + s, with_stats=True)
    # (4) the distributed log-sum-exp merge
    m_glob = ctx.tp_pmax_small(m)
    if seq_shard == "model_data":
        m_glob = ctx.dp_pmax_small(m_glob)
    m_safe = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_glob = ctx.tp_psum_small(l * alpha)
    acc_glob = ctx.tp_psum_small(acc * alpha[..., None])
    if seq_shard == "model_data":
        l_glob = ctx.dp_psum_small(l_glob)
        acc_glob = ctx.dp_psum_small(acc_glob)
    out = acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    # [B, Hkv, group, s, hd] over ALL heads -> [B, s, Hq, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)
    # (5) this shard's own Q heads for the row-parallel out-projection
    out = out[:, :, shard_idx * hq_l:(shard_idx + 1) * hq_l]
    return out.to(q.dtype), (ck, cv)


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
    b, s, d = x.shape
    assert s == 1, "paged attention packs single-token rows"
    hd = cfg.head_dim_
    hq_l, kv_w, _ = head_layout(cfg, ctx)
    window = cfg.sliding_window if window_override == "cfg" \
        else window_override

    q = _project_q(p, x, cfg, ctx)
    k, v = _project_kv(p, x, cfg, ctx)
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
