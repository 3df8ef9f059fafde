"""The ``moe`` family: a decoder of blocks whose MLP is a top-k mixture
of SwiGLU experts (``model.py``), as Mixtral-8x7B.  The contract a family
module keeps is in ``dense.py``."""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference import model

PROGRAM_KEYS: Dict[str, str] = {}


def leaf_specs(cfg: Dict) -> List[model.Spec]:
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    return sorted(model.outer_specs(cfg) + model.attention_specs("layers", n,
                                                                 cfg)
                  + model.moe_specs("layers", n, d, cfg["intermediate_size"],
                                    cfg["num_local_experts"]))


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, mm: model.Matmul = torch.matmul) -> torch.Tensor:
    """Mean next-token NLL over the rows, plus the load-balance loss of
    every expert layer times its weight."""
    nll, aux = model.nll_and_aux(params, tokens, labels, cfg, mm)
    return nll + cfg["router_aux_loss_coef"] * aux


def small(cfg: Dict) -> Dict:
    return dict(cfg, **model.SMALL, num_local_experts=4)
