"""Mamba2-1.3B — attention-free SSD (state-space duality), ssm_state=128.
[arXiv:2405.21060]

Port of ``src/repro/configs/mamba2_1p3b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4,
                  chunk=256),
    source="[arXiv:2405.21060]",
)
