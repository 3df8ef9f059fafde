"""Roofline terms of a lowered step on the card (no real hardware run).

Port of ``src/repro/roofline/analysis.py``.  Three terms per (arch x
shape x mesh), in seconds:

  compute    = FLOPs / (chips x peak FLOP/s)
  memory     = HBM bytes / (chips x HBM bandwidth)
  collective = collective bytes / (chips x link bandwidth)

The reference parses the lowered StableHLO text for the collectives
(``parse_collectives``: operand bytes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute, each attributed to a
mesh axis by its replica-group stride).  The port has no HLO: a step
lowered on ``meta`` tensors logs each collective it issues on the mesh,
with its axis, dtype and operand bytes (``launch/mesh.py``'s trace log),
and :func:`collective_stats` summarises those entries in the reference's
``CollectiveStats`` form.

The hardware constants are one card's: the NVIDIA H100 SXM5 80GB HBM3 at
its 700 W power limit, from NVIDIA's datasheet, not measured here
(:data:`DEVICE`).  The reference's are a TPU's and are not carried over:
a roofline priced at another chip's peaks would say nothing about this
card.  Everything the parity tests compare (FLOPs, bytes, collective
bytes, params) is hardware-free; the ``t_*`` terms and the dominant term
are the port's own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

#: the card the constants below describe, and their source
DEVICE = "NVIDIA H100 SXM5 80GB HBM3, 700 W (datasheet peaks)"
#: dense bfloat16 tensor-core FLOP/s (without sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink 4 bytes/s in one direction (900 GB/s both ways)
LINK_BW = 450e9

COLLECTIVE_OPS = ("all_gather", "all_reduce", "reduce_scatter",
                  "all_to_all", "collective_permute")


@dataclasses.dataclass
class CollectiveStats:
    op: str
    operand_bytes: float
    axis: str               # "model" | "data" | "node" | "pod" | "a+b"
    count: int = 1


def collective_stats(calls: Iterable[Tuple[str, str, str, int]]
                     ) -> List[CollectiveStats]:
    """The reference's ``parse_collectives`` result for a lowered step:
    one entry per logged call ``(op, axis, dtype, bytes)`` (a mesh trace
    log's ``traced`` or ``executed`` list), in call order."""
    return [CollectiveStats(op, float(nbytes), axis)
            for op, axis, _, nbytes in calls]


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # total FLOPs (per program execution)
    hbm_bytes: float
    collective_bytes_total: float
    collective_by_axis: Dict[str, float]
    collective_by_op: Dict[str, float]
    model_flops: float           # 6*N*D analytic
    memory_per_chip: Optional[float] = None   # bytes (argument + output)

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # each card drives its NVLinks concurrently; one direction's rate
        return self.collective_bytes_total / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode D=new
    tokens only."""
    n_params = count_params(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params * tokens          # forward only
    tokens = shape.global_batch * 1             # decode: one token
    return 2.0 * n_params * tokens


def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count for the generic engine."""
    d, v = cfg.d_model, cfg.vocab
    n = 0.0
    n += v * d * 2                       # embed + lm_head
    hd = cfg.head_dim_
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2 \
        if cfg.n_heads else 0.0
    mlp = 3 * d * cfg.d_ff
    if cfg.family in ("dense", "vlm"):
        n += cfg.n_layers * (attn + mlp)
    elif cfg.family == "moe":
        e_active = cfg.moe.top_k if active_only else cfg.moe.n_experts
        npre = cfg.moe.n_dense_prefix
        n += npre * (attn + mlp)
        n += (cfg.n_layers - npre) * (attn + 3 * d * cfg.d_ff * e_active
                                      + d * cfg.moe.n_experts)
    elif cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm
        d_in = ssm.d_inner(d)
        per = 2 * d * d_in + 2 * d * ssm.d_state + d * ssm.n_heads(d) \
            + d_in * d + (ssm.conv_kernel + 1) * d_in
        n += cfg.n_layers * per
        if cfg.family == "hybrid":
            n += attn + mlp              # one shared block
    elif cfg.family == "encdec":
        n += cfg.encdec.n_enc_layers * (attn + mlp)
        n += cfg.n_layers * (2 * attn + mlp)
    return n

