"""Analytic op-inventory cost model for the roofline terms.

Port of ``src/repro/roofline/analytic.py``, copied: pure Python over the
config and the input shape, so ``cost_model`` and ``step_time_bounds``
give the reference's numbers float for float.  The port lowers a step on
``meta`` tensors (``StepProgram.lower``) and has no compiler cost
analysis at all; the reason below is the reference's, and the model is
what the port's dry-run reads too.

WHY THIS EXISTS (EXPERIMENTS.md §Dry-run caveat): XLA's CPU
``compiled.cost_analysis()`` counts every while-loop (lax.scan) body ONCE,
regardless of trip count — verified empirically (a scanned matmul reports
identical FLOPs for 2 and 8 layers).  Our models scan over layers and over
attention/SSD chunks, so raw cost_analysis under-reports FLOPs by ~L and
collective text under-reports scanned collectives the same way.  Since we
control every operation the model executes, we derive the roofline terms
from an exact op inventory instead, and use the compiled artifact for what
it is reliable for: sharding validation, memory analysis, and the
*structure* (kinds + axes) of the collectives.

Conventions:
  * all quantities are EXECUTED totals across the whole mesh per step
    (replicated compute counts once per executing chip);
  * collective bytes = sum over collective ops of their per-chip operand
    bytes x participating chips (matching the HLO-parse semantics);
  * backward = 2x forward matmul FLOPs; remat re-runs the forward of every
    scanned block (factor 1 extra) — so train total = 4x forward matmuls;
  * HBM bytes: weight reads per pass + activation read/write per layer +
    optimizer state traffic (train) + KV-cache traffic (decode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.launch.shapes import InputShape, needs_swa_override
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class CollOp:
    op: str          # all_reduce | all_gather | reduce_scatter | all_to_all
    axis: str        # model | data | pod
    bytes_total: float
    count: float = 1.0


@dataclasses.dataclass
class CostBreakdown:
    flops_fwd: float
    flops_total: float
    hbm_bytes: float
    colls: List[CollOp]
    params: float
    active_params: float

    @property
    def collective_bytes(self) -> float:
        return sum(c.bytes_total * c.count for c in self.colls)

    def coll_by_axis(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for c in self.colls:
            out[c.axis] = out.get(c.axis, 0.0) + c.bytes_total * c.count
        return out

    def coll_by_op(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for c in self.colls:
            out[c.op] = out.get(c.op, 0.0) + c.bytes_total * c.count
        return out


def step_time_bounds(t_compute: float, t_memory: float,
                     t_collective: float, *,
                     n_buckets: int = 1,
                     wire_scale: float = 1.0) -> Dict[str, float]:
    """Serial and overlap-aware analytic step-time bounds.

    The historical roofline summed comm + compute serially — correct for
    the monolithic sync (one reduce AFTER the whole backward pass), but a
    pure upper bound once gradients go out in buckets (DESIGN.md §11).
    With ``n_buckets`` in flight, all but the LAST bucket's transfer can
    hide under compute; one bucket's worth of comm is structurally
    exposed (the final bucket only exists when the backward is done):

        serial    = max(t_compute, t_memory) + t_collective
        overlap   = max(compute_side, t_collective * (n-1)/n)
                    + t_collective / n

    ``n_buckets = 1`` collapses overlap to serial exactly, so the two
    bounds bracket every bucketing choice; the overlap bench
    (benchmarks/overlap_step.py) targets the gap between them.

    ``wire_scale`` (DESIGN.md §12) is the aggregate wire/logical byte
    ratio of the tuned slots when secondary-path codecs are on — it
    shrinks the collective term before the bounds are formed.  The
    default 1.0 takes the exact historical arithmetic (no float op
    touches t_collective), so uncompressed rooflines stay bit-identical.
    """
    n = max(int(n_buckets), 1)
    if wire_scale != 1.0:
        t_collective = t_collective * wire_scale
    compute_side = max(t_compute, t_memory)
    exposed = t_collective / n
    serial = compute_side + t_collective
    overlap = max(compute_side, t_collective - exposed) + exposed
    out = {"t_step_serial": serial, "t_step_overlap": overlap,
           "exposed_comm_s": exposed, "n_buckets": float(n)}
    if wire_scale != 1.0:
        out["wire_scale"] = float(wire_scale)
    return out


def _attn_flops(cfg: ArchConfig, T: float, s_kv_avg: float, tp: int,
                b: float, sq: float) -> float:
    """One attention layer forward (executed totals)."""
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    kv_w = max(hq // tp, 1) // max((hq // tp) // max(hq // hkv, 1), 1) \
        if tp > 1 else hkv
    # simpler: per-shard kv width
    if tp > 1:
        hq_l = hq // tp
        group = hq // hkv
        kv_w = max(hq_l // group, 1)
    else:
        kv_w = hkv
    f = 0.0
    f += 2 * T * d * hq * hd                      # q proj (sharded)
    f += 2 * 2 * T * d * kv_w * hd * tp           # k,v proj (replicated slice)
    f += 2 * 2 * b * hq * sq * s_kv_avg * hd      # scores + AV
    f += 2 * T * hq * hd * d                      # out proj
    return f


def _mlp_flops(cfg: ArchConfig, T: float, d_ff: int) -> float:
    return 3 * 2 * T * cfg.d_model * d_ff


def _s_kv_avg(cfg: ArchConfig, shape: InputShape, window) -> float:
    s = shape.seq_len
    if shape.kind == "decode":
        if window not in ("cfg", None) and window:
            return min(window, s)
        if window == "cfg" and cfg.sliding_window:
            return min(cfg.sliding_window, s)
        return s
    w = cfg.sliding_window
    if w and w < s:
        return w - w * w / (2.0 * s) + 1          # SWA causal average
    return s / 2.0                                 # causal average


def _dtype_bytes(cfg: ArchConfig) -> int:
    return 2 if cfg.param_dtype == "bfloat16" else 4


def param_count(cfg: ArchConfig, active_only: bool = False) -> float:
    from repro_torch.roofline.analysis import count_params
    return count_params(cfg, active_only=active_only)


def cost_model(cfg: ArchConfig, shape: InputShape, *, tp: int, dp: int,
               pods: int = 1, backend: str = "flexlink",
               remat=True, ep_over_pods: bool = False) -> CostBreakdown:
    """``ep_over_pods=True`` models the 3-tier cluster mesh (DESIGN.md
    §15): experts shard over the full (pod, node, data) ep span, so the
    pod-tier gradient AllReduce carries only the NON-expert params (the
    expert grads are pre-accumulated by the backward all_to_all).  The
    default False keeps the legacy (pod, data, model) production-mesh
    arithmetic — and every existing record — byte-identical."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    dt = _dtype_bytes(cfg)
    chips = tp * dp * pods
    b = float(shape.global_batch)
    sq = 1.0 if shape.kind == "decode" else float(shape.seq_len)
    T = b * sq                                     # tokens this step
    window = "cfg"
    if needs_swa_override(cfg, shape):
        window = 4096
    skv = _s_kv_avg(cfg, shape, window)

    colls: List[CollOp] = []

    def ar_model(nbytes_global: float, count: float = 1.0):
        """all_reduce over model axis of a T-sharded activation: per chip
        operand = global/ (dp*pods); executed on all chips."""
        colls.append(CollOp("all_reduce", "model",
                            nbytes_global / (dp * pods) * chips, count))

    act = T * d * dt                               # one activation tensor

    flops = 0.0
    hbm = 0.0
    fam = cfg.family

    # ---- embedding + head -------------------------------------------------
    if tp > 1:
        ar_model(act)                              # vocab-parallel embed AR
    if shape.kind != "decode":
        flops += 2 * T * d * V                     # lm_head
        flops += 5 * T * V                         # softmax/xent
    else:
        flops += 2 * T * d * V
        # decode logits all-gather over model (serving returns local shard
        # in the dry-run step, so no gather op is emitted)

    # ---- per-layer inventory ----------------------------------------------
    def dense_layer(T_, b_, sq_, skv_):
        f = _attn_flops(cfg, T_, skv_, tp, b_, sq_) + \
            _mlp_flops(cfg, T_, cfg.d_ff)
        if tp > 1:
            ar_model(T_ * d * dt, 2)               # attn-out AR + mlp AR
        return f

    def moe_layer(T_, b_, sq_, skv_):
        moe = cfg.moe
        f = _attn_flops(cfg, T_, skv_, tp, b_, sq_)
        f += 2 * T_ * d * moe.n_experts            # router
        routed = T_ * moe.top_k * moe.capacity_factor
        f += 3 * 2 * routed * d * cfg.d_ff         # expert FFN (sharded)
        if tp > 1:
            ar_model(T_ * d * dt)                  # attn-out AR
            ar_model(routed * d * dt)              # expert row-parallel AR
        if moe.impl == "ep_a2a" and dp > 1:
            # dispatch + return a2a over data (buffers replicated over tp)
            buf = routed * d * dt
            colls.append(CollOp("all_to_all", "data",
                                buf / (dp * pods) * chips, 2))
        return f

    def ssm_layer(T_):
        ssm = cfg.ssm
        d_in = ssm.d_inner(d)
        H = ssm.n_heads(d)
        hd, ds = ssm.head_dim, ssm.d_state
        Q = float(min(ssm.chunk, max(sq, 1)))
        f = 0.0
        f += 2 * 2 * T_ * d * d_in                 # z, x proj (sharded)
        f += 2 * 2 * T_ * d * ds * tp              # B, C proj (replicated)
        f += 2 * T_ * d * H                        # dt proj
        f += 2 * T_ * d_in * ssm.conv_kernel       # causal conv
        # SSD: intra-chunk quadratic + state terms
        f += 2 * T_ * Q * ds                       # C Bt within chunk
        f += 2 * T_ * Q * H * hd                   # (L*CB) x
        f += 2 * 2 * T_ * H * hd * ds              # state update + y_inter
        f += 2 * T_ * d_in * d                     # out proj
        if tp > 1:
            ar_model(T_ * d * dt)                  # out AR
        return f

    if fam in ("dense", "vlm"):
        T_eff = T + (b * cfg.vlm.n_vis_tokens if fam == "vlm"
                     and shape.kind != "decode" else 0)
        flops += L * dense_layer(T_eff, b, sq, skv)
    elif fam == "moe":
        npre = cfg.moe.n_dense_prefix
        flops += npre * dense_layer(T, b, sq, skv)
        flops += (L - npre) * moe_layer(T, b, sq, skv)
    elif fam == "ssm":
        flops += L * ssm_layer(T)
    elif fam == "hybrid":
        g = L // cfg.hybrid.attn_every
        flops += L * ssm_layer(T)
        flops += g * dense_layer(T, b, sq, skv)    # shared attn applications
    elif fam == "encdec":
        if shape.kind != "decode":
            Te = b * cfg.encdec.n_frames
            flops += cfg.encdec.n_enc_layers * dense_layer(
                Te, b, cfg.encdec.n_frames, cfg.encdec.n_frames / 2)
        # decoder: self-attn + cross-attn + mlp
        flops += L * dense_layer(T, b, sq, skv)
        flops += L * _attn_flops(cfg, T, cfg.encdec.n_frames, tp, b, sq)
        if tp > 1:
            ar_model(act, L)                       # cross-attn out AR
    else:
        raise ValueError(fam)

    fwd = flops

    # ---- totals per step kind ----------------------------------------------
    params = param_count(cfg)
    active = param_count(cfg, active_only=True)
    w_bytes = params * dt

    if shape.kind == "train":
        # fwd + bwd(2x) + remat recompute: full remat re-runs the whole
        # forward (+1); "dots" saves matmul outputs and recomputes only the
        # elementwise chain (~+0.1); none stores everything (+0).
        remat_factor = {True: 1.0, "dots": 0.1, False: 0.0}[remat]
        total = (3.0 + remat_factor) * fwd
        # gradient all-reduce over data (+pod) of non-expert params; expert
        # grads are accumulated by the backward a2a (ep) or local (tp moe)
        expert_frac = 0.0
        if cfg.moe is not None:
            e_params = (L - cfg.moe.n_dense_prefix) * 3 * d * cfg.d_ff \
                * cfg.moe.n_experts
            expert_frac = e_params / params
        sync_params = params * (1 - expert_frac)
        if dp > 1:
            colls.append(CollOp(
                "all_reduce", "data",
                (sync_params / tp) * 4 * chips / (dp * pods)))
        if pods > 1:
            pod_sync = sync_params if ep_over_pods else params
            colls.append(CollOp(
                "all_reduce", "pod", (pod_sync / tp) * 4 * chips / pods))
        # HBM: weights fwd+bwd+remat reads + grad write/read + adamw state
        hbm += (2 + remat_factor) * w_bytes + 2 * params * 4
        hbm += 3 * params * 4 * 2                  # mu, nu, p fp32 update rw
        act_mult = {True: 14, "dots": 22, False: 26}[remat]
        hbm += L * act_mult * T * d * dt           # activations r/w
    elif shape.kind == "prefill":
        total = fwd
        hbm += w_bytes + L * 8 * T * d * dt
        # prefill writes the KV cache once
        hbm += L * 2 * b * sq * cfg.n_kv_heads * cfg.head_dim_ * dt \
            if cfg.n_heads else 0
    else:
        total = fwd
        hbm += w_bytes / max(dp * pods, 1) * (dp * pods)   # weight read
        if cfg.n_heads:
            # seq-sharded cache: every shard holds ALL kv heads over its
            # sequence slice -> total reads = full-head cache once
            hbm += L * 2 * b * skv * cfg.n_kv_heads * cfg.head_dim_ * dt
        if cfg.ssm is not None:
            ssm = cfg.ssm
            hbm += L * b * ssm.n_heads(d) * ssm.d_state * ssm.head_dim * 4 * 2
        hbm += 2 * w_bytes * 0                     # (decode activations tiny)

    return CostBreakdown(flops_fwd=fwd, flops_total=total, hbm_bytes=hbm,
                         colls=colls, params=params, active_params=active)
