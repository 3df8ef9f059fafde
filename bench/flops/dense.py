"""Model FLOPs of a dense decoder's training step."""

from __future__ import annotations

from typing import Dict

from bench.flops.common import attention_flops, attention_params, head_params


def matmul_params(cfg: Dict) -> int:
    """Weights a token multiplies through (the embedding is a lookup)."""
    mlp = 3 * cfg["hidden_size"] * cfg["intermediate_size"]
    return (cfg["num_hidden_layers"] * (attention_params(cfg) + mlp)
            + head_params(cfg))


def step_flops(cfg: Dict, seq: int, seqs: int) -> float:
    return 6.0 * matmul_params(cfg) * seq * seqs + attention_flops(
        cfg, seq, seqs)
