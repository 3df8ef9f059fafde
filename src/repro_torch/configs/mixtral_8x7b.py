"""Mixtral 8x7B — MoE 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088]

Port of ``src/repro/configs/mixtral_8x7b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    sliding_window=4096,            # Mistral-lineage SWA
    # 8 experts cannot shard over a 16-wide axis -> TP-MoE (hidden dim
    # sharded over model, tokens stay local; see models/moe.py).
    moe=MoEConfig(n_experts=8, top_k=2, impl="tp"),
    source="[arXiv:2401.04088]",
)
