"""Architecture configuration — one dataclass drives every assigned arch.

Port of ``src/repro/models/config.py``: the same dataclasses and
``reduced()``; ``ArchConfig.dtype`` maps ``param_dtype`` to a torch dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

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

    @property
    def n_router(self) -> int:
        """The router's width: every expert of the layer (this config
        holds them all)."""
        return self.n_experts


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

    @property
    def d_expert(self) -> int:
        """The width of one routed expert's FFN: the MoE config's own
        (``SigmoidMoEConfig.d_expert``), else ``d_ff``."""
        return getattr(self.moe, "d_expert", 0) or self.d_ff

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


# ---------------------------------------------------------------------------
# DeepSeek-V3-style blocks (Kimi-K2-Instruct): configurations of their own,
# so the reference's ten configurations keep their fields
# ---------------------------------------------------------------------------

def _yarn_mscale(factor: float, m: float) -> float:
    """YaRN's attention scale for a context ``factor`` (DeepSeek-V3's
    ``yarn_get_mscale``)."""
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 §2.1, arXiv:2405.04434):
    low-rank query and key/value paths, each with its RMSNorm, a RoPE key
    of ``qk_rope_head_dim`` shared by every head, and YaRN frequencies
    (DeepSeek-V3's public form) from ``rope_scaling``, the published
    config's group as given (its keys ``type``, ``factor``,
    ``original_max_position_embeddings``, ``beta_fast``, ``beta_slow``,
    ``mscale``, ``mscale_all_dim``)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_scaling: Dict[str, Any] = dataclasses.field(hash=False)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def _yarn(self, key: str, default: float) -> float:
        return float(self.rope_scaling.get(key, default))

    @property
    def softmax_scale(self) -> float:
        """qk_head_dim^-1/2 times mscale(factor, mscale_all_dim)^2."""
        m = _yarn_mscale(self._yarn("factor", 1.0),
                         self._yarn("mscale_all_dim", 0.0))
        return self.qk_head_dim ** -0.5 * m * m

    def yarn_ramp(self, theta: float) -> Tuple[int, int]:
        """(low, high): the frequency pairs below ``low`` keep their
        frequency, those from ``high`` on are divided by the factor."""
        dim = self.qk_rope_head_dim
        orig = self._yarn("original_max_position_embeddings", 4096)

        def corr(rotations: float) -> float:
            return (dim * math.log(orig / (rotations * 2 * math.pi))
                    / (2 * math.log(theta)))
        low = math.floor(corr(self._yarn("beta_fast", 32.0)))
        high = math.ceil(corr(self._yarn("beta_slow", 1.0)))
        return max(low, 0), min(high, dim - 1)

    def validate(self) -> None:
        assert self.qk_rope_head_dim % 2 == 0, self.qk_rope_head_dim
        assert self.rope_scaling.get("type") == "yarn", self.rope_scaling
        # the rotation's own scale, mscale(f, mscale) / mscale(f,
        # mscale_all_dim), is 1 when the two agree, as published
        assert self._yarn("mscale", 1.0) == \
            self._yarn("mscale_all_dim", 0.0), self.rope_scaling


@dataclasses.dataclass(frozen=True)
class SigmoidMoEConfig(MoEConfig):
    """DeepSeek-V3's expert layer (arXiv:2412.19437 §2.1.2): sigmoid
    scores, top-k selection by score plus a correction bias (a leaf,
    ``router_bias``, that selects but never weighs), the chosen scores
    normalised and scaled by ``routed_scaling_factor``, the sequence-wise
    balance loss, and ``n_shared_experts`` experts every token takes.

    The layer holds ``n_experts`` of the router's ``router_experts``: the
    block ``expert_share`` of ``router_experts / n_experts`` chips that
    share it.  It routes over all of them and computes its own experts'
    part of the result; what the other chips' experts would add is not
    computed here."""
    router_experts: int = 0           # 0: the layer holds every expert
    expert_share: int = 0
    d_expert: int = 0                 # a routed expert's FFN width
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    seq_aux: bool = True

    @property
    def n_router(self) -> int:
        return self.router_experts or self.n_experts

    @property
    def first_held(self) -> int:
        return self.expert_share * self.n_experts

    def validate(self) -> None:
        # the forms the program computes; others are refused, not guessed
        assert (self.scoring_func, self.topk_method, self.n_group,
                self.topk_group, self.norm_topk_prob, self.seq_aux) == \
            ("sigmoid", "noaux_tc", 1, 1, True, True), self
        assert self.n_router % self.n_experts == 0, self
        assert 0 <= self.expert_share < self.n_router // self.n_experts
        assert self.top_k <= self.n_router


@dataclasses.dataclass(frozen=True)
class MLAArchConfig(ArchConfig):
    """An ArchConfig whose attention is MLA (``mla``); ``head_dim`` is the
    value width the output projection reads."""
    mla: Optional[MLAConfig] = None

    def validate(self) -> None:
        super().validate()
        assert self.mla is not None
        self.mla.validate()
        assert self.head_dim_ == self.mla.v_head_dim, \
            (self.head_dim_, self.mla.v_head_dim)
        if isinstance(self.moe, SigmoidMoEConfig):
            self.moe.validate()


def mla_of(cfg: ArchConfig) -> Optional[MLAConfig]:
    """The config's MLA settings; None for the other attentions."""
    return getattr(cfg, "mla", None)
