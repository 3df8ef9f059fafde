"""Qwen2-72B — dense, GQA kv=8, QKV bias.  [arXiv:2407.10671]

Port of ``src/repro/configs/qwen2_72b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, rope_theta=1e6,
    qkv_bias=True,
    source="[arXiv:2407.10671]",
)
