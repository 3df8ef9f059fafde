"""Model FLOPs of an ``mla_moe`` decoder's training step on the chip that
holds ``n_routed_experts`` of the router's ``router_experts``: MLA's
projections, its causal attention at (qk + v) dims a pair and head, the
dense prefix's FFN, the router over its full width, the shared experts,
and of each token's ``num_experts_per_tok`` routed experts the held
share (k n_routed_experts / router_experts a token, on average): the
rest are the other chips' work, which this chip does not do."""

from __future__ import annotations

from typing import Dict

from bench.flops.common import attended_pairs, head_params


def mla_params(cfg: Dict) -> int:
    """MLA's projection weights of one layer."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    ql, kvl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    return (d * ql + ql * h * (nope + rope) + d * (kvl + rope)
            + kvl * h * (nope + vd) + h * vd * d)


def matmul_params(cfg: Dict) -> float:
    """Weights a token multiplies through (the embedding is a lookup)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    pre = cfg["first_k_dense_replace"]
    rest = cfg["num_hidden_layers"] - pre
    routed = (cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
              / cfg["router_experts"])
    moe = (d * cfg["router_experts"]
           + (routed + cfg["n_shared_experts"]) * 3 * d * f)
    return (cfg["num_hidden_layers"] * mla_params(cfg)
            + pre * 3 * d * cfg["intermediate_size"] + rest * moe
            + head_params(cfg))


def attention_flops(cfg: Dict, seq: int, seqs: int) -> float:
    """QK^T (qk dims) and PV (v dims) of every layer and head, forward and
    backward (x3), 2 FLOPs a multiply-add."""
    per_pair = 2 * cfg["num_attention_heads"] * (
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        + cfg["v_head_dim"])
    return (3.0 * per_pair * attended_pairs(seq, cfg.get("sliding_window"))
            * cfg["num_hidden_layers"] * seqs)


def step_flops(cfg: Dict, seq: int, seqs: int) -> float:
    return 6.0 * matmul_params(cfg) * seq * seqs + attention_flops(
        cfg, seq, seqs)
