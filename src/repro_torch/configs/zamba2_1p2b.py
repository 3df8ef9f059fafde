"""Zamba2-1.2B — Mamba2 backbone + shared attention block, ssm_state=64.
[arXiv:2411.15242]

Port of ``src/repro/configs/zamba2_1p2b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig, SSMConfig, HybridConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, rope_theta=1e4,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_kernel=4,
                  chunk=256),
    hybrid=HybridConfig(attn_every=6),
    source="[arXiv:2411.15242]",
)
