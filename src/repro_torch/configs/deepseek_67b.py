"""DeepSeek 67B — dense llama-arch, GQA kv=8.  [arXiv:2401.02954]

Port of ``src/repro/configs/deepseek_67b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, rope_theta=1e4,
    source="[arXiv:2401.02954]",
)
