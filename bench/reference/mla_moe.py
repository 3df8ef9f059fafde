"""The ``mla_moe`` family: DeepSeek-V3's decoder (arXiv:2412.19437 §2.1),
as Kimi-K2-Instruct: multi-head latent attention with YaRN RoPE, leading
dense blocks (``prefix``), then blocks whose FFN is a sigmoid-routed
mixture of experts beside shared experts.  The contract a family module
keeps is in ``dense.py``; ``model.py`` gives the norms, the SwiGLU FFN,
the outer leaves and the head.

Per token, every norm an RMSNorm:

* MLA (DeepSeek-V2 §2.1, the expanded form as trained): c_q =
  RMSNorm(x W_qa), q = c_q W_qb, each head [q_nope | q_rope];
  [c_kv | k_rope] = x W_kva, kv = RMSNorm(c_kv) W_kvb, each head
  [k_nope | v]; q_rope and the one k_rope (shared by every head)
  rotated; o_h = softmax_causal(q_h k_h^T s) v_h; out = [o_1 .. o_H] W_o.
  YaRN (``rope_scaling``): frequency pair i keeps theta^(-2i/dim) below
  floor(corr(beta_fast)), is divided by the factor from
  ceil(corr(beta_slow)) on, linearly mixed between, with corr(r) =
  dim ln(L0 / (2 pi r)) / (2 ln theta); s = (qk dims)^-1/2 times
  mscale(factor, mscale_all_dim)^2, mscale(f, m) = 0.1 m ln f + 1.  The
  rotation pairs dims (i, i + dim/2), a fixed permutation of the
  published interleaved pairs' columns of W_qb and W_kva.
* The expert layer (``noaux_tc``, one group): s = sigmoid(x W_r) over
  all ``router_experts``; the top-k of s + b are chosen (b the correction
  bias, a leaf: it selects and never weighs, and joins the loss at
  weight 0); g_i = scale s_i / sum of the chosen s; y = sum over the
  chosen experts this chip holds of g_i FFN_i(x), plus the shared FFN.
  The chip holds ``n_routed_experts`` of them, block ``expert_share``;
  what the others would add is not computed.  An expert takes the first
  ``capacity`` of its (token, choice) pairs in token order, capacity =
  ceil(T k / router_experts * capacity_factor), at least 4; the rest add
  nothing.
* The balance loss, sequence-wise: per sequence sum_i f_i P_i, f_i = R /
  (k T) #{t : i chosen}, P_i = mean_t s_i,t / sum_j s_j,t; the mean over
  sequences, summed over the expert layers, times ``aux_loss_alpha``.

Attention runs in blocks of queries, each checkpointed, so the float32
step at full width fits beside its AdamW state.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import model

#: queries a block of attention scores holds
QUERY_BLOCK = 512

PROGRAM_KEYS: Dict[str, str] = {
    "q_lora_rank": "mla.q_lora_rank", "kv_lora_rank": "mla.kv_lora_rank",
    "qk_nope_head_dim": "mla.qk_nope_head_dim",
    "qk_rope_head_dim": "mla.qk_rope_head_dim",
    "v_head_dim": "mla.v_head_dim", "rope_scaling": "mla.rope_scaling",
    "n_routed_experts": "moe.n_experts",
    "router_experts": "moe.router_experts",
    "expert_share": "moe.expert_share",
    "moe_intermediate_size": "moe.d_expert",
    "n_shared_experts": "moe.n_shared_experts",
    "routed_scaling_factor": "moe.routed_scaling_factor",
    "scoring_func": "moe.scoring_func", "topk_method": "moe.topk_method",
    "n_group": "moe.n_group", "topk_group": "moe.topk_group",
    "norm_topk_prob": "moe.norm_topk_prob", "seq_aux": "moe.seq_aux",
    "first_k_dense_replace": "moe.n_dense_prefix",
    "aux_loss_alpha": "moe.aux_loss_weight"}


def _check(cfg: Dict) -> None:
    """The forms this reference computes; others are refused."""
    got = (cfg["scoring_func"], cfg["topk_method"], cfg["n_group"],
           cfg["topk_group"], cfg["norm_topk_prob"], cfg["seq_aux"],
           cfg["hidden_act"], cfg["moe_layer_freq"],
           cfg["num_nextn_predict_layers"], cfg["attention_bias"],
           cfg["tie_word_embeddings"],
           cfg["num_key_value_heads"] == cfg["num_attention_heads"])
    want = ("sigmoid", "noaux_tc", 1, 1, True, True, "silu", 1, 0, False,
            False, True)
    if got != want:
        raise ValueError(f"mla_moe computes {want}, the file gives {got}")


# -- the parameter tree ------------------------------------------------------

def mla_specs(stack: str, n: int, cfg: Dict) -> List[model.Spec]:
    """The two norms and the MLA of ``n`` stacked blocks."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    ql, kvl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    a = (stack, "attn")
    return [((stack, "ln1"), (n, d), "ones"), ((stack, "ln2"), (n, d), "ones"),
            (a + ("wq_a",), (n, d, ql), "normal"),
            (a + ("q_norm",), (n, ql), "ones"),
            (a + ("wq_b",), (n, ql, h * (nope + rope)), "normal"),
            (a + ("wkv_a",), (n, d, kvl + rope), "normal"),
            (a + ("kv_norm",), (n, kvl), "ones"),
            (a + ("wkv_b",), (n, kvl, h * (nope + vd)), "normal"),
            (a + ("wo",), (n, h * vd, d), "normal")]


def expert_specs(stack: str, n: int, cfg: Dict) -> List[model.Spec]:
    """The router over ``router_experts``, its bias, the held experts
    and the shared experts (one FFN of their summed width)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e, r = cfg["n_routed_experts"], cfg["router_experts"]
    m = (stack, "moe")
    shared = [(m + ("shared", p[-1]), s, k) for p, s, k in model.mlp_specs(
        stack, n, d, cfg["n_shared_experts"] * f)]
    return [(m + ("w_router",), (n, d, r), "normal"),
            (m + ("router_bias",), (n, r), "zeros"),
            (m + ("experts", "w_gate"), (n, e, d, f), "normal"),
            (m + ("experts", "w_up"), (n, e, d, f), "normal"),
            (m + ("experts", "w_down"), (n, e, f, d), "normal")] + shared


def leaf_specs(cfg: Dict) -> List[model.Spec]:
    _check(cfg)
    pre = cfg["first_k_dense_replace"]
    rest = cfg["num_hidden_layers"] - pre
    return sorted(model.outer_specs(cfg) + mla_specs("prefix", pre, cfg)
                  + model.mlp_specs("prefix", pre, cfg["hidden_size"],
                                    cfg["intermediate_size"])
                  + mla_specs("layers", rest, cfg)
                  + expert_specs("layers", rest, cfg))


# -- the forward -------------------------------------------------------------

def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(cfg: Dict):
    """(frequencies [dim/2] in float64, softmax scale) of the RoPE dims."""
    dim, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    base = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    scale = (cfg["qk_nope_head_dim"] + dim) ** -0.5
    rs = cfg["rope_scaling"]
    assert rs["type"] == "yarn" and rs["mscale"] == rs["mscale_all_dim"]
    orig, factor = rs["original_max_position_embeddings"], rs["factor"]

    def corr(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    m = _mscale(factor, rs["mscale_all_dim"])
    return base * (1 - ramp) + base / factor * ramp, scale * m * m


def _rotate(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, dim] at positions 0..S-1: the pair (i, i + dim/2)
    rotated by position * freqs[i]."""
    s, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(s, dtype=torch.float64)[:, None] * freqs[None, :]
    cos = torch.cos(ang).float().to(x.device)[None, :, None, :]
    sin = torch.sin(ang).float().to(x.device)[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
            scale: float) -> torch.Tensor:
    """Queries q0.. of q [B, Sq, H, *] over the keys up to the last of
    them, causally."""
    sq = q.shape[1]
    k, v = k[:, :q0 + sq], v[:, :q0 + sq]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    qpos = torch.arange(q0, q0 + sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    scores = scores.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def mla(h: torch.Tensor, p: Dict, cfg: Dict, mm: model.Matmul
        ) -> torch.Tensor:
    bsz, s, _ = h.shape
    eps, nh = cfg["rms_norm_eps"], cfg["num_attention_heads"]
    kvl = cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    freqs, scale = yarn(cfg)
    q = mm(model.rms_norm(mm(h, p["wq_a"]), p["q_norm"], eps), p["wq_b"])
    q = q.view(bsz, s, nh, nope + rope)
    kva = mm(h, p["wkv_a"])
    kv = mm(model.rms_norm(kva[..., :kvl], p["kv_norm"], eps), p["wkv_b"])
    kv = kv.view(bsz, s, nh, nope + vd)
    k_rope = _rotate(kva[..., None, kvl:], freqs).expand(bsz, s, nh, rope)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], freqs)], dim=-1)
    k = torch.cat([kv[..., :nope], k_rope], dim=-1)
    v = kv[..., nope:]
    out = torch.cat([checkpoint(_attend, q[:, i:i + QUERY_BLOCK], k, v, i,
                                scale, use_reentrant=False)
                     for i in range(0, s, QUERY_BLOCK)], dim=1)
    return mm(out.reshape(bsz, s, nh * vd), p["wo"])


def experts(h: torch.Tensor, p: Dict, cfg: Dict, mm: model.Matmul):
    """The held experts' part and the shared experts: (output, balance
    loss)."""
    bsz, s, d = h.shape
    x = h.reshape(bsz * s, d)
    t, k = x.shape[0], cfg["num_experts_per_tok"]
    r, held = cfg["router_experts"], cfg["n_routed_experts"]
    first = cfg["expert_share"] * held
    scores = torch.sigmoid(x @ p["w_router"])
    choice = (scores + p["router_bias"]).detach()
    top_e = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :k]
    g = scores.gather(1, top_e)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    chosen = torch.zeros_like(scores).scatter(1, top_e, 1.0)
    f = chosen.view(bsz, s, r).sum(1) * (r / (k * s))
    share = (scores / scores.sum(-1, keepdim=True)).view(bsz, s, r).mean(1)
    aux = (f * share).sum(-1).mean() + 0.0 * p["router_bias"].sum()
    cap = max(math.ceil(t * k / r * cfg["capacity_factor"]), 4)
    flat_e, flat_g = top_e.reshape(-1), g.reshape(-1)
    ex, sh = p["experts"], p["shared"]
    y = model.swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], mm)
    for j in range(held):
        # the first `cap` (token, choice) pairs routed to expert first + j
        picks = torch.nonzero(flat_e == first + j).squeeze(1)[:cap]
        rows = picks // k
        out = model.swiglu(x[rows], ex["w_gate"][j], ex["w_up"][j],
                           ex["w_down"][j], mm)
        y = y.index_add(0, rows, out * flat_g[picks, None])
    return y.view(bsz, s, d), aux


def block(x: torch.Tensor, p: Dict, cfg: Dict, mm: model.Matmul):
    """One decoder block: (x, balance loss or 0)."""
    eps = cfg["rms_norm_eps"]
    x = x + mla(model.rms_norm(x, p["ln1"], eps), p["attn"], cfg, mm)
    h = model.rms_norm(x, p["ln2"], eps)
    if "moe" in p:
        y, aux = experts(h, p["moe"], cfg, mm)
        return x + y, aux
    m = p["mlp"]
    return x + model.swiglu(h, m["w_gate"], m["w_up"], m["w_down"], mm), \
        torch.zeros((), device=x.device)


def _layer(tree: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, mm: model.Matmul = torch.matmul) -> torch.Tensor:
    """Mean next-token NLL over the rows, plus ``aux_loss_alpha`` times
    the balance loss summed over the expert layers."""
    _check(cfg)
    x = params["embed"][tokens.long()]
    aux = torch.zeros((), device=x.device)
    for stack in ("prefix", "layers"):
        tree = params[stack]
        for i in range(tree["ln1"].shape[0]):
            x, a = checkpoint(block, x, _layer(tree, i), cfg, mm,
                              use_reentrant=False)
            aux = aux + a
    x = model.rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    flat, lab = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    rows = model.HEAD_ROWS
    total = sum(checkpoint(model._nll_sum, flat[r:r + rows],
                           params["lm_head"], lab[r:r + rows], mm,
                           use_reentrant=False)
                for r in range(0, flat.shape[0], rows))
    return total / flat.shape[0] + cfg["aux_loss_alpha"] * aux


def small(cfg: Dict) -> Dict:
    """Every width cut, the forms kept: 1 dense + 2 expert blocks, 2 of 8
    experts held (the second share), top-3, and YaRN over 8 RoPE dims from
    64 positions, so both frequency bands and the scale's factor show."""
    cut = dict(model.SMALL, num_hidden_layers=3, num_key_value_heads=4,
               head_dim=8, v_head_dim=8, qk_nope_head_dim=8,
               qk_rope_head_dim=8, q_lora_rank=24, kv_lora_rank=16,
               intermediate_size=96, moe_intermediate_size=32,
               n_routed_experts=2, router_experts=8, expert_share=1,
               num_experts_per_tok=3,
               rope_scaling=dict(cfg["rope_scaling"], factor=4,
                                 original_max_position_embeddings=64))
    return dict(cfg, **cut)
