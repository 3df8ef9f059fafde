"""Kimi K2 — trillion-param MoE, 384 experts top-8, first layer dense.
(paper-table config)  [arXiv:2501.kimi2]

Port of ``src/repro/configs/kimi_k2_1t_a32b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, rope_theta=5e4,
    # 384 experts shard over the 16-wide data axis (24/rank) with
    # all_to_all dispatch + TP inside each expert (models/moe.py ep_a2a).
    moe=MoEConfig(n_experts=384, top_k=8, n_dense_prefix=1, impl="ep_a2a"),
    source="[arXiv:2501.kimi2]",
)
