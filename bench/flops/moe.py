"""Model FLOPs of a mixture-of-experts decoder's training step: each
token counts its router and its ``num_experts_per_tok`` experts only."""

from __future__ import annotations

from typing import Dict

from bench.flops.common import attention_flops, attention_params, head_params


def matmul_params(cfg: Dict) -> int:
    d = cfg["hidden_size"]
    expert = 3 * d * cfg["intermediate_size"]
    layer = (attention_params(cfg) + d * cfg["num_local_experts"]
             + cfg["num_experts_per_tok"] * expert)
    return cfg["num_hidden_layers"] * layer + head_params(cfg)


def step_flops(cfg: Dict, seq: int, seqs: int) -> float:
    return 6.0 * matmul_params(cfg) * seq * seqs + attention_flops(
        cfg, seq, seqs)
