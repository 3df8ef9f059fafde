"""What the families share: the attention's projections and its causal
products, and the LM head."""

from __future__ import annotations

from typing import Dict


def attention_params(cfg: Dict) -> int:
    """Q, K, V and O projection weights of one layer."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    return (2 * d * cfg["num_attention_heads"] * hd
            + 2 * d * cfg["num_key_value_heads"] * hd)


def attended_pairs(seq: int, window) -> int:
    """(query, key) pairs a causal (windowed) sequence attends."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_flops(cfg: Dict, seq: int, seqs: int) -> float:
    """QK^T and PV of every layer, forward and backward (x3), 2 FLOPs a
    multiply-add, over ``seqs`` sequences of ``seq`` tokens."""
    per_pair = 2 * 2 * cfg["head_dim"] * cfg["num_attention_heads"]
    return (3.0 * per_pair * attended_pairs(seq, cfg.get("sliding_window"))
            * cfg["num_hidden_layers"] * seqs)


def head_params(cfg: Dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]
