"""InternVL2-Llama3-76B language backbone — the ViT-6B vision encoder +
MLP projector are a STUB per the brief: input_specs() supplies patch
embeddings [B, n_vis_tokens, d_model].  [arXiv:2404.16821]

Port of ``src/repro/configs/internvl2_76b.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=5e5,
    vlm=VLMConfig(n_vis_tokens=256),
    source="[arXiv:2404.16821]",
)
