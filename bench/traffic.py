"""The general generator of training traffic: a pool of batches from the
seed, made on the device before the window.

A traffic file (``traffic/<name>.json``) gives ``loop`` ("closed": train
steps back to back), ``ranks``, ``batch_per_rank``, ``seq_len``,
``tokens`` ("uniform": ids drawn uniformly from the vocabulary) and
``pool``, the number of distinct global batches.  Step ``k`` trains on
batch ``k mod pool``: every seed gives the same sizes, only other ids.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench.weights import derive


def check(traffic: Dict, chips: int) -> None:
    if traffic["loop"] != "closed":
        raise ValueError(f"loop {traffic['loop']!r}: only closed loops")
    if traffic["tokens"] != "uniform":
        raise ValueError(f"tokens {traffic['tokens']!r}: only uniform ids")
    if traffic["ranks"] != chips:
        raise ValueError(f"traffic for {traffic['ranks']} ranks on {chips} "
                         f"chips")


def global_batch(traffic: Dict) -> int:
    return traffic["ranks"] * traffic["batch_per_rank"]


def token_pool(traffic: Dict, vocab: int, seed: int,
               device) -> torch.Tensor:
    """[pool, global batch, seq_len + 1] int32 token ids: step k's inputs
    are ``[:, :-1]`` of batch k, its labels ``[:, 1:]``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "tokens"))
    shape = (traffic["pool"], global_batch(traffic), traffic["seq_len"] + 1)
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)


def batch(pool: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Step ``k``'s global batch."""
    rows = pool[k % pool.shape[0]]
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
