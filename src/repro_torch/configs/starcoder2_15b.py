"""StarCoder2-15B — dense, GQA kv=4, RoPE, 4k sliding window (the real
model trains with SWA 4096).  [arXiv:2402.19173]

Port of ``src/repro/configs/starcoder2_15b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, rope_theta=1e5,
    sliding_window=4096,
    source="[arXiv:2402.19173]",
)
