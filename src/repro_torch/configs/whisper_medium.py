"""Whisper-medium — encoder-decoder; mel-spectrogram + conv frontend is a
STUB per the brief: input_specs() supplies frame embeddings
[B, n_frames, d_model].  [arXiv:2212.04356]

Port of ``src/repro/configs/whisper_medium.py``: the same CONFIG data.
"""

from repro_torch.models.config import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, rope_theta=1e4,
    encdec=EncDecConfig(n_enc_layers=24, n_frames=1500),
    source="[arXiv:2212.04356]",
)
