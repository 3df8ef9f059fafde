"""Kimi-K2-Instruct as published: 61 layers at hidden size 7168, layer 0
dense (FFN 18432), then 384 routed experts of 2048 (top-8, sigmoid scores
with a selection bias, weights normalised and scaled by 2.827) beside one
shared expert, and multi-head latent attention with YaRN RoPE.
[https://huggingface.co/moonshotai/Kimi-K2-Instruct config.json;
the layer equations are DeepSeek-V3's, arXiv:2412.19437 §2.1]

Not one of the reference's ten configurations (``ARCH_IDS``): resolved by
module name, ``get_config("kimi-k2-instruct")``.  It runs the train step
on one data-parallel line (MLA refuses a model axis, decode and paged
decode).  ``aux_loss_weight`` is DeepSeek-V3's α, which the published
config does not give.
"""

from repro_torch.models.config import (MLAArchConfig, MLAConfig,
                                       SigmoidMoEConfig)

CONFIG = MLAArchConfig(
    name="kimi-k2-instruct", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=64,
    d_ff=18432,                     # the dense layer's FFN
    vocab=163840, head_dim=128,     # the value width wo reads
    rope_theta=50000.0, norm_eps=1e-6,
    moe=SigmoidMoEConfig(
        n_experts=384, top_k=8, n_dense_prefix=1, aux_loss_weight=1e-4,
        impl="tp", d_expert=2048, n_shared_experts=1,
        routed_scaling_factor=2.827),
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128,
        rope_scaling={"beta_fast": 1, "beta_slow": 1, "factor": 32,
                      "mscale": 1, "mscale_all_dim": 1,
                      "original_max_position_embeddings": 4096,
                      "type": "yarn"}),
    source="[https://huggingface.co/moonshotai/Kimi-K2-Instruct]",
)
