"""The LM engine for the dense family: training forward and loss, and
serving.

Port of ``src/repro/models/transformer.py``: ``init_params``,
``param_specs``, the vocab-parallel ``embed_tokens`` (masked local
lookup + ``ctx.tp_all_reduce``), ``lm_logits_local``,
``vocab_parallel_xent`` (the distributed log-sum-exp), the train/prefill
``forward`` and ``lm_loss``, the dense decode cache and ``decode_step``,
and the paged pool and ``paged_decode_step`` (both at tp = 1, item 11).
Activation checkpointing (the reference's ``jax.checkpoint`` around each
scanned block, ``remat=True``) is ``torch.utils.checkpoint`` around each
layer; the reference's selective ``remat="dots"`` policy has no
counterpart yet and raises.  ``init_params`` builds the GLOBAL tree with
the reference's keys and shapes, layers stacked on a leading [L] dim, so
a reference tree carries over 1:1 (``convert.py``); a rank of a model
axis holds the local shards ``convert.shard_params`` cuts from it by
``param_specs``.  ``lax.scan`` over layers becomes a Python loop over the
[L] dim.  The reference records a collective once per trace, and scan
traces its body once: here layer 0 records its calls and the later
layers and the checkpoint recompute run under ``ctx.unrecorded()``.  The
caches are updated IN PLACE: ``decode_step`` writes each layer's new K/V
into the [L, ...] cache tensors it was given, and ``paged_decode_step``
scatters into the pool (models/layers.py).

Families other than dense raise until their slices land (ROADMAP queue 1:
items 9 and 14 for moe, ssm, hybrid, encdec and vlm).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.tp import ParallelCtx

PORTED_FAMILIES = ("dense",)


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP queue 1, item 9 (moe, ssm, hybrid, encdec, vlm) "
            f"and item 14 (rail-local moe)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """GLOBAL-shaped parameter tree (dense family): the reference's keys
    and shapes, weights N(0, 0.02^2) in ``cfg.dtype``, norms ones.
    ``generator`` must live on ``device``."""
    cfg.validate()
    _require_ported(cfg)
    dtype = cfg.dtype
    n, d = cfg.n_layers, cfg.d_model
    p: Dict[str, Any] = {
        "embed": L._normal(generator, (cfg.vocab_padded, d), dtype, device),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(generator, (d, cfg.vocab_padded), dtype,
                                 device)
    p["layers"] = {
        "ln1": torch.ones((n, d), dtype=dtype, device=device),
        "attn": L.init_attention(generator, cfg, dtype, device, lead=(n,)),
        "ln2": torch.ones((n, d), dtype=dtype, device=device),
        "mlp": L.init_mlp(generator, cfg, dtype, device, lead=(n,)),
    }
    return p


def _stack_specs(specs):
    """Prepend the [L] stack dim (never sharded) to every leaf's spec."""
    return {k: _stack_specs(v) if isinstance(v, dict) else (None,) + v
            for k, v in specs.items()}


def param_specs(cfg: ArchConfig, model_axis: str = "model"):
    """The mesh axis of each dim of every leaf of ``init_params`` (None:
    replicated), as the reference's PartitionSpec tree: the vocabulary
    sharded over the model axis in the embedding and the LM head, the
    layers' Q/O and MLP as in models/layers.py, norms and K/V
    replicated."""
    _require_ported(cfg)
    sp: Dict[str, Any] = {"embed": (model_axis, None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        sp["lm_head"] = (None, model_axis)
    sp["layers"] = _stack_specs({
        "ln1": (None,), "attn": L.attention_specs(cfg, model_axis),
        "ln2": (None,), "mlp": L.mlp_specs(model_axis)})
    return sp


def _layer(tree, i: int):
    """Layer ``i`` of a stacked [L, ...] subtree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# embedding + logits
# ---------------------------------------------------------------------------

def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig,
                 ctx: ParallelCtx) -> torch.Tensor:
    """Vocab-parallel embedding: masked lookup in the local vocabulary
    shard, summed over the model axis by ``ctx.tp_all_reduce``."""
    table = p["embed"]                           # local [V_l, D]
    if ctx.tp_size <= 1:
        return table[tokens.long()]
    v_l = table.shape[0]
    local_id = tokens.long() - ctx.tp_index() * v_l
    valid = (local_id >= 0) & (local_id < v_l)
    emb = torch.where(valid[..., None], table[local_id.clamp(0, v_l - 1)],
                      0.0)
    return ctx.tp_all_reduce(emb)


def lm_logits_local(p, x: torch.Tensor, cfg: ArchConfig,
                    ctx: ParallelCtx) -> torch.Tensor:
    """[B,S,D] -> vocab logits [B,S,V_padded]; columns beyond the true
    vocab (padding for divisibility) are masked to -inf."""
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = x @ w
    if cfg.vocab_padded != cfg.vocab:
        v_l = logits.shape[-1]
        gid = ctx.tp_index() * v_l + torch.arange(v_l, device=x.device)
        logits = torch.where(gid < cfg.vocab, logits, -torch.inf)
    return logits


def vocab_parallel_xent(logits_l: torch.Tensor, labels: torch.Tensor,
                        ctx: ParallelCtx, vocab: int) -> torch.Tensor:
    """Cross-entropy over model-axis-sharded vocab logits -> per-token NLL
    [B,S] in float32: the distributed log-sum-exp.  The max is a
    stability shift whose gradient cancels, so it is detached (the
    reference's ``stop_gradient``) before its max over the model axis; the
    exp-sum and the label's logit are summed over the axis."""
    v_l = logits_l.shape[-1]
    lf = logits_l.float()
    m = ctx.tp_pmax_small(lf.detach().amax(dim=-1))            # [B,S]
    z = ctx.tp_psum_small(torch.exp(lf - m[..., None]).sum(-1))
    local_id = labels.long() - ctx.tp_index() * v_l
    valid = (local_id >= 0) & (local_id < v_l)
    picked = torch.gather(lf, -1, local_id.clamp(0, v_l - 1)[..., None]
                          )[..., 0]
    label_logit = ctx.tp_psum_small(torch.where(valid, picked, 0.0))
    return torch.log(z) + m - label_logit


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _dense_block(lp, x: torch.Tensor, cfg: ArchConfig,
                 ctx: ParallelCtx) -> torch.Tensor:
    h, _ = L.attention_block(lp["attn"], L.rms_norm(x, lp["ln1"],
                                                    cfg.norm_eps), cfg, ctx)
    x = x + h
    return x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                           ctx)


def forward(p, tokens: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx, *,
            remat=True):
    """Train/prefill forward -> (hidden [B,S,D], aux loss scalar).

    ``remat=True`` recomputes each layer's activations in the backward
    pass (one checkpoint per layer); ``False`` keeps them.  Layer 0's
    collectives are recorded, the later layers' and the recompute's not
    (``lax.scan`` traces the body once)."""
    _require_ported(cfg)
    if remat not in (True, False):
        raise NotImplementedError(f"remat={remat!r}: only True (per-layer "
                                  f"checkpointing) and False are ported")
    x = embed_tokens(p, tokens, cfg, ctx)
    for i in range(cfg.n_layers):                 # lax.scan in the reference
        lp = _layer(p["layers"], i)
        with ctx.unrecorded() if i else contextlib.nullcontext():
            if remat:
                x = checkpoint(_dense_block, lp, x, cfg, ctx,
                               use_reentrant=False,
                               context_fn=lambda: (contextlib.nullcontext(),
                                                   ctx.unrecorded()))
            else:
                x = _dense_block(lp, x, cfg, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rms_norm(x, p["final_norm"], cfg.norm_eps), aux


def lm_loss(p, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ctx: ParallelCtx, *, remat=True) -> torch.Tensor:
    """Mean next-token NLL over the local batch shard (the dense family
    has no auxiliary loss)."""
    x, _ = forward(p, batch["tokens"], cfg, ctx, remat=remat)
    logits_l = lm_logits_local(p, x, cfg, ctx)
    return vocab_parallel_xent(logits_l, batch["labels"], ctx,
                               cfg.vocab).mean()


# ---------------------------------------------------------------------------
# dense decode cache (wave engine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Static decode-shape parameters.

    cache_len_local : sequence length of the KV cache (local to the
                      device: the reference's sequence-sharded caches
                      need the communicator, ROADMAP queue 1, item 11)
    window_override : "cfg" or an int/None — the --swa-override variant
    """
    cache_len_local: int
    window_override: Any = "cfg"


def init_cache(cfg: ArchConfig, ctx: ParallelCtx, dcfg: DecodeConfig,
               batch_local: int, dtype=None, device=None):
    """Zero cache: ``{"k", "v"}`` of [L, B, S, kv_w, hd]."""
    _require_ported(cfg)
    L._one_shard(ctx, "the dense decode cache")
    dtype = dtype or cfg.dtype
    kv_w = L.head_layout(cfg, ctx)[1]
    shape = (cfg.n_layers, batch_local, dcfg.cache_len_local, kv_w,
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(p, cache, token: torch.Tensor, pos, cfg: ArchConfig,
                ctx: ParallelCtx, dcfg: DecodeConfig):
    """One decode step: token [B,S] int, pos a scalar or [B] ->
    (logits [B,V], cache).  The cache tensors are updated in place."""
    _require_ported(cfg)
    x = embed_tokens(p, token, cfg, ctx)
    pos_arr = torch.as_tensor(pos, device=x.device)
    steps = torch.arange(token.shape[1], device=x.device)
    positions = pos_arr[:, None] + steps if pos_arr.ndim else pos_arr + steps

    for i in range(cfg.n_layers):                 # lax.scan in the reference
        lp = _layer(p["layers"], i)
        h, (nk, nv) = L.attention_block(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, ctx,
            positions=positions, kv_cache=(cache["k"][i], cache["v"][i]),
            cache_pos=pos_arr, window_override=dcfg.window_override)
        cache["k"][i] = nk
        cache["v"][i] = nv
        x = x + h
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                            ctx)

    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return lm_logits_local(p, x[:, -1:], cfg, ctx)[:, 0], cache


# ---------------------------------------------------------------------------
# paged pool (continuous-batching engine, DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static paged-serving shape parameters (DESIGN.md §13).

    block_size         : tokens per physical KV block
    n_blocks           : physical blocks in the pool (per layer)
    max_blocks_per_req : logical blocks per request row
    attn_impl          : "reference" (dense block-gather, matches the wave
                         path) | "kernel" (the CUDA flash-decode kernel on
                         the card, its plain version on the CPU)
    window_override    : "cfg" or an int/None, as DecodeConfig
    """
    block_size: int = 16
    n_blocks: int = 64
    max_blocks_per_req: int = 8
    attn_impl: str = "reference"
    window_override: Any = "cfg"


def init_paged_pool(cfg: ArchConfig, ctx: ParallelCtx, pcfg: PagedConfig,
                    dtype=None, device=None):
    """Zero paged KV pool: ``[L, n_blocks, block_size, kv_w, hd]`` per K
    and V.  Block contents are never zeroed again — reuse relies on
    kv_valid masking (serving/paged_kv.py)."""
    _require_ported(cfg)
    L._one_shard(ctx, "the paged pool")
    dtype = dtype or cfg.dtype
    kv_w = L.head_layout(cfg, ctx)[1]
    shape = (cfg.n_layers, pcfg.n_blocks, pcfg.block_size, kv_w,
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_step(p, pool, tokens: torch.Tensor, positions: torch.Tensor,
                      row_req: torch.Tensor, block_tables: torch.Tensor,
                      sample_rows: torch.Tensor, cfg: ArchConfig,
                      ctx: ParallelCtx, pcfg: PagedConfig):
    """One packed continuous-batching step (context + generation phases).

    tokens/positions/row_req : [T] int — packed rows; ``row_req`` maps a
        row to its request row (block-table row), -1 for bucket padding
    block_tables             : [R, max_blocks_per_req] int
    sample_rows              : [R] int — packed index of each request
        row's sequence-frontier row

    Returns (logits [R, V], pool); the pool is updated in place.  Padding
    rows cost zero attention mass and zero pool writes.
    """
    _require_ported(cfg)
    valid = row_req >= 0
    n_req = block_tables.shape[0]
    btab = block_tables[torch.clamp(row_req, 0, n_req - 1).long()]
    kv_valid = torch.where(valid, positions + 1, 0)
    x = embed_tokens(p, tokens[:, None], cfg, ctx)           # [T, 1, D]

    for i in range(cfg.n_layers):                 # lax.scan in the reference
        lp = _layer(p["layers"], i)
        h, _ = L.paged_attention_block(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, ctx,
            positions=positions, kv_valid=kv_valid,
            pools=(pool["k"][i], pool["v"][i]), block_tables=btab,
            window_override=pcfg.window_override, impl=pcfg.attn_impl)
        x = x + h
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                            ctx)

    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    xs = x[torch.clamp(sample_rows, 0, x.shape[0] - 1).long()]  # [R, 1, D]
    return lm_logits_local(p, xs, cfg, ctx)[:, 0], pool
