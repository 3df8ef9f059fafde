"""Architecture configuration — one dataclass drives every assigned arch.

Port of ``src/repro/models/config.py``: the same dataclasses and
``reduced()``; ``ArchConfig.dtype`` maps ``param_dtype`` to a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    #: layers 0..n_dense_prefix-1 use a dense FFN (Kimi K2 keeps layer 0 dense)
    n_dense_prefix: int = 0
    #: router aux load-balance loss weight (Switch-style)
    aux_loss_weight: float = 0.01
    #: "ep_a2a" = experts sharded over the data axis with all_to_all dispatch
    #: (+ TP inside each expert); "tp" = experts replicated, FFN hidden
    #: sharded over the model axis (for n_experts < axis size, e.g. Mixtral).
    impl: str = "ep_a2a"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + a single shared attention block
    applied every `attn_every` backbone layers."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder.  The mel+conv frontend is a STUB —
    input_specs() provides precomputed frame embeddings (B, n_frames, d)."""
    n_enc_layers: int = 24
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """InternVL2-style.  The ViT+projector frontend is a STUB —
    input_specs() provides patch embeddings (B, n_vis_tokens, d)."""
    n_vis_tokens: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free (mamba2)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # mixtral/starcoder2 SWA
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    source: str = ""                  # citation, e.g. [arXiv:2401.04088]
    param_dtype: str = "bfloat16"
    #: embedding/lm_head vocab rows are padded to a multiple of this so the
    #: vocab-parallel sharding divides any tp size (Megatron's
    #: make-vocab-size-divisible-by); padded logits are masked to -inf.
    vocab_pad_to: int = 256

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m if m else self.vocab

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm"), self.family
        if self.family == "moe":
            assert self.moe is not None
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None
        if self.n_heads:
            assert self.n_heads % self.n_kv_heads == 0

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4, vocab: int = 512) -> "ArchConfig":
        """The smoke-test variant: same family/topology, tiny dims."""
        heads = 4 if self.n_heads else 0
        kv = min(self.n_kv_heads, 2) if self.n_heads else 0
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, n_experts),
                top_k=min(self.moe.top_k, 2),
                n_dense_prefix=min(self.moe.n_dense_prefix, 1))
        ssm = None
        if self.ssm:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                      chunk=32)
        hybrid = dataclasses.replace(self.hybrid, attn_every=1) \
            if self.hybrid else None
        encdec = dataclasses.replace(self.encdec, n_enc_layers=n_layers,
                                     n_frames=16) if self.encdec else None
        vlm = dataclasses.replace(self.vlm, n_vis_tokens=8) if self.vlm \
            else None
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=heads,
            n_kv_heads=kv, d_ff=2 * d_model, vocab=vocab, head_dim=0,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else None,
            moe=moe, ssm=ssm, hybrid=hybrid, encdec=encdec, vlm=vlm,
            param_dtype="float32")
