"""The ``dense`` family: a decoder of dense blocks (``model.py``'s
attention and SwiGLU MLP), as glm4-9b.  A family module gives:

* ``leaf_specs(cfg)``: (path, shape, init kind) of every leaf, in the
  order ``bench/weights.py`` draws them;
* ``loss(params, tokens, labels, cfg, mm)``: the float32 reference loss,
  every projection's product taken by ``mm``;
* ``PROGRAM_KEYS``: configuration key -> the program's ``ArchConfig``
  field it sets (dotted into a group, ``"moe.n_experts"``), over
  ``bench/cells.py``'s ``ARCH_KEYS`` and ``MOE_KEYS``;
* ``small(cfg)``: the configuration cut to a size the CPU tests run.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference import model

PROGRAM_KEYS: Dict[str, str] = {}


def leaf_specs(cfg: Dict) -> List[model.Spec]:
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    return sorted(model.outer_specs(cfg) + model.attention_specs("layers", n,
                                                                 cfg)
                  + model.mlp_specs("layers", n, d, cfg["intermediate_size"]))


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, mm: model.Matmul = torch.matmul) -> torch.Tensor:
    """Mean next-token NLL over the rows."""
    return model.nll_and_aux(params, tokens, labels, cfg, mm)[0]


def small(cfg: Dict) -> Dict:
    return dict(cfg, **model.SMALL)
