"""GLM-4-9B — dense, RoPE, GQA kv=2.  [hf:THUDM/glm-4-9b]

Port of ``src/repro/configs/glm4_9b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, rope_theta=1e4,
    source="[hf:THUDM/glm-4-9b]",
)
