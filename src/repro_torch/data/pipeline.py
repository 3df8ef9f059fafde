# Copied from src/repro/data/pipeline.py; only the imports are renamed.
"""Data pipeline: deterministic synthetic LM token streams, sharded per
data-parallel host, with the modality-frontend stubs for VLM/audio archs.

"Synthetic" here means a reproducible corpus generator (Zipfian unigram +
order-2 Markov mixing), not random noise — losses decrease when a model
trains on it, so integration tests can assert learning.  The pipeline is
batched, pre-fetchable and sharded exactly like a real corpus loader:
every data-parallel rank draws its own disjoint stream from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_shard: int
    seed: int = 0
    zipf_a: float = 1.3          # unigram skew
    markov_mix: float = 0.7      # how much order-2 structure


class SyntheticCorpus:
    """Deterministic, shardable token stream with learnable structure."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, shard, n_shards]))
        v = cfg.vocab
        # Zipf unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # order-2 structure: next ~ deterministic mix of (prev*13+7) mod v
        self._mult = 13 if v % 13 else 11

    def _next_tokens(self, prev: np.ndarray) -> np.ndarray:
        structured = (prev * self._mult + 7) % self.cfg.vocab
        rand = self.rng.choice(self.cfg.vocab, size=prev.shape,
                               p=self.unigram)
        take_struct = self.rng.random(prev.shape) < self.cfg.markov_mix
        return np.where(take_struct, structured, rand).astype(np.int32)

    def batch(self) -> Dict[str, np.ndarray]:
        b, s = self.cfg.batch_per_shard, self.cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self.rng.choice(self.cfg.vocab, size=b, p=self.unigram)
        for t in range(s):
            toks[:, t + 1] = self._next_tokens(toks[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()


def frontend_stub(cfg: ArchConfig, batch: int, rng: np.random.Generator,
                  dtype=np.float32) -> Optional[Dict[str, np.ndarray]]:
    """The one allowed stub: precomputed frontend embeddings.

    VLM: patch embeddings [B, n_vis_tokens, d_model] (ViT+projector output).
    Audio: frame embeddings [B, n_frames, d_model] (mel+conv output).
    """
    if cfg.family == "vlm":
        return {"vis_embed": rng.standard_normal(
            (batch, cfg.vlm.n_vis_tokens, cfg.d_model)).astype(dtype) * 0.02}
    if cfg.family == "encdec":
        return {"enc_embed": rng.standard_normal(
            (batch, cfg.encdec.n_frames, cfg.d_model)).astype(dtype) * 0.02}
    return None


def make_batches(cfg: ArchConfig, *, seq_len: int, batch_per_shard: int,
                 shard: int = 0, n_shards: int = 1,
                 seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    corpus = SyntheticCorpus(
        DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                   batch_per_shard=batch_per_shard, seed=seed),
        shard=shard, n_shards=n_shards)
    rng = np.random.default_rng(np.random.SeedSequence([seed + 1, shard]))
    for batch in corpus:
        extra = frontend_stub(cfg, batch_per_shard, rng)
        if extra:
            batch = dict(batch, **extra)
        yield batch
