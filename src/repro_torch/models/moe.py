"""Mixture-of-Experts blocks.

Port of ``src/repro/models/moe.py``.  Two sharding schemes, selected per
arch (``MoEConfig.impl``):

  ep_a2a : experts sharded over the expert-parallel span (the data axis,
           plus the node and pod axes on a cluster mesh: ``ctx.ep_axes``,
           DESIGN.md §15) with all_to_all dispatch and return, plus
           tensor parallelism inside each expert over the model axis
           (col/row split of the expert FFN, combined by a FlexLink
           all-reduce).  Kimi-K2.  The all_to_all is a flex all_to_all
           (``ctx.ep_all_to_all``), differentiable through
           ``routing.execute``: MoE dispatch is exactly the traffic the
           paper targets.  On a single-node mesh it is the data axis's;
           on a cluster mesh the RAIL-LOCAL decomposition (intra shuffle,
           rail-aligned NIC leg, spine leg), bit for bit the flat
           all_to_all over the span.
  tp     : experts replicated, every expert's FFN hidden dim sharded over
           the model axis; tokens never leave their rank and the
           row-parallel combine is a FlexLink all-reduce.  Mixtral.

Dispatch is capacity-based and one-hot-free, as the reference's: tokens
are ranked within their expert by a stable argsort and per-expert counts
(``index_add_``, which meta tensors take; ``bincount`` has no meta
kernel), then scattered into [n_experts * capacity, d] buffers; tokens
beyond capacity fall back to the residual path.  Ties keep the
reference's order: ``lax.top_k`` puts the lower index first, so the
top-k is a stable descending sort cut to k (``torch.topk`` promises no
order), and the argsorts are stable.  Every dropped token adds an exact
zero to slot ``E * cap - 1``, so the scatter-add is exact in any order.
The expert FFN is three batched products (``torch.matmul``), as the
reference's einsums outside any kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.layers import _normal, silu
from repro_torch.models.tp import ParallelCtx
from repro_torch.runtime import spans


# ---------------------------------------------------------------------------
# routing + capacity dispatch (shared by both impls)
# ---------------------------------------------------------------------------

def route(x2d: torch.Tensor, w_router: torch.Tensor, moe: MoEConfig):
    """x2d: [T, D] -> (weights [T, k], experts [T, k], aux loss scalar)."""
    logits = x2d.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = top[:, :moe.top_k], idx[:, :moe.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize
    # Switch-style aux loss: E * sum_e f_e * p_e, f a repeated scatter-add
    # of one constant (it rounds as the reference's .at[].add)
    t = x2d.shape[0]
    flat = idx.reshape(-1)
    f = torch.zeros(moe.n_experts, dtype=torch.float32,
                    device=x2d.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (t * moe.top_k),
                            dtype=torch.float32, device=x2d.device))
    p = probs.mean(dim=0)
    aux = moe.n_experts * torch.sum(f * p)
    return w.to(x2d.dtype), idx, aux


def capacity_of(t_local: int, moe: MoEConfig) -> int:
    cap = int(math.ceil(t_local * moe.top_k / moe.n_experts
                        * moe.capacity_factor))
    return max(cap, 4)


def dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int):
    """experts: [T*k] -> (slot [T*k], keep [T*k]) without one-hot
    matmuls."""
    tk = experts.shape[0]
    order = torch.argsort(experts, stable=True)
    sorted_e = experts[order]
    counts = torch.zeros(n_experts, dtype=experts.dtype,
                         device=experts.device).index_add_(
        0, experts, torch.ones_like(experts))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(tk, device=experts.device) \
        - starts[sorted_e]
    keep_sorted = pos_in_expert < capacity
    slot_sorted = sorted_e * capacity + torch.clamp(pos_in_expert,
                                                    max=capacity - 1)
    inv = torch.argsort(order, stable=True)       # back to token order
    return slot_sorted[inv], keep_sorted[inv]


def gather_to_buffers(x2d: torch.Tensor, slots: torch.Tensor,
                      keep: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Scatter tokens into [n_experts * capacity, D] (dropped -> zeros)."""
    buf = torch.zeros((n_experts * capacity, x2d.shape[-1]),
                      dtype=x2d.dtype, device=x2d.device)
    contrib = torch.where(keep[:, None], x2d, 0)
    return buf.index_add(0, torch.where(keep, slots, n_experts * capacity - 1),
                         contrib)


def combine_from_buffers(buf: torch.Tensor, slots: torch.Tensor,
                         keep: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """buf: [E*cap, D]; slots/keep/weights: [T*k] -> [T*k, D]."""
    out = buf[slots]
    return torch.where(keep[:, None], out, 0) * weights[:, None]


# ---------------------------------------------------------------------------
# expert FFN (TP col/row inside each expert)
# ---------------------------------------------------------------------------

def init_experts(gen: torch.Generator, cfg: ArchConfig, dtype, device,
                 lead: Tuple[int, ...] = ()):
    """GLOBAL shapes [n_experts, d, d_ff] with ``lead`` prepended;
    ``moe_specs`` shards the expert dim over the ep span (ep_a2a) and the
    hidden dim over model."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "w_gate": _normal(gen, lead + (n, d, f), dtype, device),
        "w_up": _normal(gen, lead + (n, d, f), dtype, device),
        "w_down": _normal(gen, lead + (n, f, d), dtype, device),
    }


def expert_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """x: [n_local, cap*, D] -> same shape (no collective; the caller
    reduces)."""
    h = silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
    return torch.matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# the two MoE blocks
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             lead: Tuple[int, ...] = ()):
    return {
        "w_router": _normal(gen, lead + (cfg.d_model, cfg.moe.n_experts),
                            dtype, device),
        "experts": init_experts(gen, cfg, dtype, device, lead),
    }


def moe_specs(cfg: ArchConfig, data_axis, model_axis: str):
    """The mesh axis of each dim of every leaf of ``init_moe``:
    ``data_axis`` is the expert-dim entry of ep_a2a experts, a bare axis
    name or the outermost-major ep axis tuple of a cluster mesh
    (``ctx.ep_spec_axis()``)."""
    e_axis = data_axis if cfg.moe.impl == "ep_a2a" else None
    return {
        "w_router": (None, None),
        "experts": {
            "w_gate": (e_axis, None, model_axis),
            "w_up": (e_axis, None, model_axis),
            "w_down": (e_axis, model_axis, None),
        },
    }


def _experts(p, buf: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx,
             cap: int) -> torch.Tensor:
    """The capacity buffers [E*cap, D] through the experts (ep_a2a: over
    the ep span's all_to_alls), the row-parallel combine included."""
    moe = cfg.moe
    d = buf.shape[-1]
    if moe.impl == "ep_a2a" and ctx.ep_size > 1:
        ep = ctx.ep_size
        n_local = moe.n_experts // ep
        # [E*cap, D] -> a2a over the ep span: each rank keeps its expert
        # slice of every peer's buffer -> [ep * n_local * cap, D]; on a
        # cluster mesh the rail-local decomposition, bit for bit the flat
        # all_to_all over the span
        sent = ctx.ep_all_to_all(buf, split_axis=0, concat_axis=0)
        inb = sent.reshape(ep, n_local, cap, d)
        inb = inb.transpose(0, 1).reshape(n_local, ep * cap, d)
        out_loc = expert_ffn(p["experts"], inb)           # TP-sharded d_ff
        out_loc = ctx.tp_all_reduce(out_loc)              # row-parallel
        outb = out_loc.reshape(n_local, ep, cap, d).transpose(0, 1)
        outb = outb.reshape(ep * n_local * cap, d)
        return ctx.ep_all_to_all(outb, split_axis=0, concat_axis=0)
    out_loc = expert_ffn(p["experts"], buf.reshape(moe.n_experts, cap, d))
    out_loc = ctx.tp_all_reduce(out_loc)                  # row-parallel
    return out_loc.reshape(moe.n_experts * cap, d)


def moe_block(p, x: torch.Tensor, cfg: ArchConfig,
              ctx: ParallelCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss scalar).

    Spans: ``moe.dispatch`` holds the routing and the scatter into the
    capacity buffers, and again the combine; ``moe.experts`` the expert
    FFN with its combines and the ep all_to_alls.  Counters:
    ``moe.assigned`` (token, expert) pairs and ``moe.dropped``, those past
    capacity."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    cap = capacity_of(t, moe)
    x2d = x.reshape(t, d)
    with spans.span("moe.dispatch") as sp:
        x2d = sp.inputs(x2d)
        weights, experts, aux = route(x2d, p["w_router"], moe)
        xk = torch.repeat_interleave(x2d, moe.top_k, dim=0)     # [T*k, D]
        slots, keep = dispatch_indices(experts.reshape(-1), moe.n_experts,
                                       cap)
        buf = gather_to_buffers(xk, slots, keep, moe.n_experts, cap)
        if spans.counting() and not keep.is_meta:   # meta: a lowered step
            spans.count("moe.assigned", t * moe.top_k)
            spans.count("moe.dropped", (~keep).sum())
        weights, aux, buf = sp.outputs(weights, aux, buf)

    with spans.span("moe.experts") as sp:
        buf_out = sp.outputs(_experts(p, sp.inputs(buf), cfg, ctx, cap))

    with spans.span("moe.dispatch") as sp:
        buf_out, weights = sp.inputs(buf_out, weights)
        yk = combine_from_buffers(buf_out, slots, keep, weights.reshape(-1))
        y = sp.outputs(yk.reshape(t, moe.top_k, d).sum(dim=1))
    return y.reshape(b, s, d), aux.float()
