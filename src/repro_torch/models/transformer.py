"""The LM engine: one generic decoder for the dense, MoE, SSM, hybrid, vlm
and encdec families: training forward and loss, and serving.

Port of ``src/repro/models/transformer.py``: ``init_params``,
``param_specs``, the vocab-parallel ``embed_tokens`` (masked local
lookup + ``ctx.tp_all_reduce``), ``lm_logits_local``,
``vocab_parallel_xent`` (the distributed log-sum-exp), the train/prefill
``forward`` and ``lm_loss`` (with the MoE router's aux loss and the
frontend stubs), the decode caches and ``decode_step`` (a local cache,
or one sequence-sharded over the model axis, or over data x model for
batch 1: ``DecodeConfig.seq_shard``), and the paged pool and
``paged_decode_step`` (dense, vlm and moe), each at any tp.  The
families:

* dense: a stack of attention + SwiGLU blocks;
* moe: ``n_dense_prefix`` dense blocks (``prefix``), then attention +
  MoE blocks (``layers``; models/moe.py, ``tp`` or ``ep_a2a``), their
  router aux losses summed.  An ``MLAArchConfig`` (Kimi-K2-Instruct)
  takes MLA for attention in both stacks (models/layers.py ``mla_core``)
  and, with a ``SigmoidMoEConfig``, the biased sigmoid router, a shared
  expert and experts of their own width (``d_expert``; the dense prefix
  keeps ``d_ff``); it trains and prefills, and refuses both decodes;
* ssm: a stack of Mamba2 blocks (models/ssm.py);
* hybrid (Zamba2): Mamba2 blocks with ONE shared attention + MLP block
  (``shared_attn``) after every group of ``attn_every`` of them; the
  remainder layers run without it;
* vlm (InternVL2's backbone): the dense stack over ``[vis_embed;
  tokens]``, the stub patch rows cut off before the final norm;
* encdec (Whisper): an encoder stack of bidirectional dense blocks over
  the stub frame embeddings ``enc_embed`` (``enc_layers``, ``enc_norm``),
  then decoder blocks of self-attention, cross-attention over the encoder
  output (``ln_x``, ``xattn``) and the MLP.

Activation checkpointing (the reference's ``jax.checkpoint`` around each
scanned block, ``remat=True``) is ``torch.utils.checkpoint`` around each
block.  ``remat="dots"`` is the reference's selective policy
(``dots_saveable``): torch's selective checkpoint contexts save every
matmul output (``aten.mm``, ``bmm``, ``addmm``) and the backward
recomputes only the rest of the block; Whisper's encoder blocks stay
fully checkpointed under it, as the reference's plain ``jax.checkpoint``
there.  ``init_params`` builds the GLOBAL tree with
the reference's keys and shapes, layers stacked on a leading [L] dim, so
a reference tree carries over 1:1 (``convert.py``); a rank holds the
local shards ``convert.shard_params`` cuts from it by ``param_specs``.
Each ``lax.scan`` over layers becomes a Python loop over the [L] dim.
The reference records a collective once per trace, and scan traces its
body once: here the first block of each scan records its calls (the
hybrid's first group: its first Mamba2 block, then the shared block),
and the later ones and the checkpoint recompute run under
``ctx.unrecorded()``; the decode paths record the same way, except the
moe family's dense prefix, a Python loop in the reference whose every
block records.  The caches are updated IN PLACE: ``decode_step``
writes each layer's new K/V or SSM state into the [L, ...] cache tensors
it was given, and ``paged_decode_step`` scatters into the pool
(models/layers.py).  Serving reads no frontend stub, as in the
reference: the paged engine serves vlm on its tokens, and encdec's
cross-attention cache ``xk``/``xv`` is made zero and never written (the
prefill program, launch/steps.py, is the serving-side path that feeds the
stubs through ``forward``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ArchConfig, mla_of
from repro_torch.models.tp import ParallelCtx
from repro_torch.runtime import spans

# ---------------------------------------------------------------------------
# init + specs
# ---------------------------------------------------------------------------

def _dense_init(gen, cfg: ArchConfig, dtype, device, lead=()):
    d = cfg.d_model
    return {
        "ln1": torch.ones(lead + (d,), dtype=dtype, device=device),
        "attn": L.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": torch.ones(lead + (d,), dtype=dtype, device=device),
        "mlp": L.init_mlp(gen, cfg, dtype, device, lead=lead),
    }


def _moe_init(gen, cfg: ArchConfig, dtype, device, lead):
    d = cfg.d_model
    return {
        "ln1": torch.ones(lead + (d,), dtype=dtype, device=device),
        "attn": L.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": torch.ones(lead + (d,), dtype=dtype, device=device),
        "moe": M.init_moe(gen, cfg, dtype, device, lead=lead),
    }


def _ssm_init(gen, cfg: ArchConfig, dtype, device, lead):
    return {"ln": torch.ones(lead + (cfg.d_model,), dtype=dtype,
                             device=device),
            "ssm": S.init_ssm(gen, cfg, dtype, device, lead=lead)}


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """GLOBAL-shaped parameter tree: the reference's keys and shapes,
    weights N(0, 0.02^2) in ``cfg.dtype``, norms ones (the SSM's dt_bias,
    a_log and d_skip float32).  ``generator`` must live on ``device``."""
    cfg.validate()
    dtype, gen = cfg.dtype, generator
    n, d = cfg.n_layers, cfg.d_model
    p: Dict[str, Any] = {
        "embed": L._normal(gen, (cfg.vocab_padded, d), dtype, device),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(gen, (d, cfg.vocab_padded), dtype, device)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["layers"] = _dense_init(gen, cfg, dtype, device, (n,))
    elif fam == "encdec":
        p["enc_layers"] = _dense_init(gen, cfg, dtype, device,
                                      (cfg.encdec.n_enc_layers,))
        p["enc_norm"] = torch.ones((d,), dtype=dtype, device=device)
        p["layers"] = _dense_init(gen, cfg, dtype, device, (n,))
        p["layers"]["ln_x"] = torch.ones((n, d), dtype=dtype, device=device)
        p["layers"]["xattn"] = L.init_attention(gen, cfg, dtype, device,
                                                lead=(n,))
    elif fam == "moe":
        npre = cfg.moe.n_dense_prefix
        if npre:
            p["prefix"] = _dense_init(gen, cfg, dtype, device, (npre,))
        p["layers"] = _moe_init(gen, cfg, dtype, device, (n - npre,))
    else:                                          # ssm, hybrid
        p["layers"] = _ssm_init(gen, cfg, dtype, device, (n,))
        if fam == "hybrid":
            p["shared_attn"] = _dense_init(gen, cfg, dtype, device)
    return p


def _stack_specs(specs):
    """Prepend the [L] stack dim (never sharded) to every leaf's spec."""
    return {k: _stack_specs(v) if isinstance(v, dict) else (None,) + v
            for k, v in specs.items()}


def param_specs(cfg: ArchConfig, data_axis: str = "data",
                model_axis: str = "model"):
    """The mesh axis of each dim of every leaf of ``init_params`` (None:
    replicated), as the reference's PartitionSpec tree: the vocabulary
    sharded over the model axis in the embedding and the LM head, the
    layers' Q/O, MLP, expert FFN hidden dims and SSM heads over the model
    axis, and ep_a2a experts over ``data_axis`` (``ctx.ep_spec_axis()``);
    norms, K/V and routers replicated."""
    sp: Dict[str, Any] = {"embed": (model_axis, None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        sp["lm_head"] = (None, model_axis)
    dense = {"ln1": (None,), "attn": L.attention_specs(cfg, model_axis),
             "ln2": (None,), "mlp": L.mlp_specs(model_axis)}
    fam = cfg.family
    if fam in ("dense", "vlm"):
        sp["layers"] = _stack_specs(dense)
    elif fam == "encdec":
        sp["enc_layers"] = _stack_specs(dense)
        sp["enc_norm"] = (None,)
        sp["layers"] = _stack_specs(dict(
            dense, ln_x=(None,), xattn=L.attention_specs(cfg, model_axis)))
    elif fam == "moe":
        if cfg.moe.n_dense_prefix:
            sp["prefix"] = _stack_specs(dense)
        sp["layers"] = _stack_specs({
            "ln1": (None,), "attn": L.attention_specs(cfg, model_axis),
            "ln2": (None,),
            "moe": M.moe_specs(cfg, data_axis, model_axis)})
    else:                                          # ssm, hybrid
        sp["layers"] = _stack_specs({"ln": (None,),
                                     "ssm": S.ssm_specs(model_axis)})
        if fam == "hybrid":
            sp["shared_attn"] = dense
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

def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block(lp, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx,
                 causal=True):
    """Attention + MLP; ``causal=False`` is Whisper's encoder block."""
    h, _ = L.attention_block(lp["attn"], L.rms_norm(x, lp["ln1"],
                                                    cfg.norm_eps), cfg, ctx,
                             causal=causal)
    x = x + h
    x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                        ctx)
    return x, _zero(x)


def _moe_block(lp, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx):
    h, _ = L.attention_block(lp["attn"], L.rms_norm(x, lp["ln1"],
                                                    cfg.norm_eps), cfg, ctx)
    x = x + h
    y, aux = M.moe_block(lp["moe"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                         cfg, ctx)
    return x + y, aux


#: cross-attention K/V [B, S_enc, kv_w, hd] of the encoder output through
#: this shard's KV-head columns of ``xattn``'s projections (the
#: reference's ``_xattn_kv``)
_xattn_kv = L._project_kv


def _decoder_block(lp, carry, cfg: ArchConfig, ctx: ParallelCtx):
    """Whisper's decoder block over the carry (x, encoder output): causal
    self-attention, cross-attention on ``rms_norm(x, ln_x)`` with K/V from
    the encoder output, the MLP.  The encoder output rides the carry (a
    block input, so a checkpoint recompute sees it) and its gradient sums
    over every decoder block."""
    x, enc = carry
    h, _ = L.attention_block(lp["attn"], L.rms_norm(x, lp["ln1"],
                                                    cfg.norm_eps), cfg, ctx)
    x = x + h
    h, _ = L.attention_block(lp["xattn"], L.rms_norm(x, lp["ln_x"],
                                                     cfg.norm_eps), cfg, ctx,
                             xattn_kv=_xattn_kv(lp["xattn"], enc, cfg, ctx))
    x = x + h
    x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                        ctx)
    return (x, enc), _zero(x)


def _ssm_block(lp, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx):
    h, _ = S.ssm_block(lp["ssm"], L.rms_norm(x, lp["ln"], cfg.norm_eps),
                       cfg, ctx)
    return x + h, _zero(x)


#: the ops whose outputs ``remat="dots"`` saves (the reference's
#: dot_general under ``dots_saveable``)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(_, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recompute(selective, ctx: ParallelCtx):
    """A checkpoint's recompute: unrecorded, under ``selective``, and
    outside the span counters and the backward spans
    (``spans.recomputing``, outermost: the selective context replays
    the forward's ops, and the backward spans' ranges are not of them)."""
    with spans.recomputing(), selective, ctx.unrecorded():
        yield


def _remat_contexts(ctx: ParallelCtx, remat):
    """(forward, recompute) contexts of one checkpointed block."""
    if remat == "dots":
        fwd, rec = create_selective_checkpoint_contexts(_save_dots)
    else:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    return fwd, _recompute(rec, ctx)


def _apply(block, lp, x, cfg, ctx, remat):
    """One block, checkpointed with ``remat`` (True, or "dots": matmul
    outputs saved; its recompute unrecorded): (x, aux)."""
    if not remat:
        return block(lp, x, cfg, ctx)
    return checkpoint(block, lp, x, cfg, ctx, use_reentrant=False,
                      context_fn=functools.partial(_remat_contexts, ctx,
                                                   remat))


def _first_records(ctx: ParallelCtx, i: int):
    """Block ``i`` of a scan: the first records its collectives, the
    later ones repeat them (``lax.scan`` traces its body once)."""
    return ctx.unrecorded() if i else contextlib.nullcontext()


def _scan(stacked, x, block, cfg, ctx, remat, aux, lo=0, hi=None):
    """Blocks [lo, hi) of a stacked subtree as one ``lax.scan`` over the
    carry ``x`` (a tensor, or encdec's (x, encoder output)): the first
    records; the aux losses summed into ``aux`` in order."""
    hi = _depth(stacked) if hi is None else hi
    for i in range(lo, hi):
        with _first_records(ctx, i - lo):
            x, a = _apply(block, _layer(stacked, i), x, cfg, ctx, remat)
        aux = aux + a
    return x, aux


def _depth(stacked) -> int:
    """The [L] size of a stacked subtree."""
    v = next(iter(stacked.values()))
    return _depth(v) if isinstance(v, dict) else v.shape[0]


def _stacks(p):
    """The attention stacks in layer order: the moe family's dense
    ``prefix`` (when it has one), then ``layers``."""
    return [p["prefix"], p["layers"]] if "prefix" in p else [p["layers"]]


def _hybrid_forward(p, x, cfg: ArchConfig, ctx: ParallelCtx, remat, aux):
    """Zamba2: groups of ``attn_every`` Mamba2 blocks, each followed by
    the SHARED attention block (the same weights every time); the
    remainder blocks run after the last group without it."""
    k = cfg.hybrid.attn_every
    g = cfg.n_layers // k
    for gi in range(g):                          # the group scan
        with _first_records(ctx, gi):
            x, aux = _scan(p["layers"], x, _ssm_block, cfg, ctx, remat, aux,
                           gi * k, (gi + 1) * k)
            x, a = _apply(_dense_block, p["shared_attn"], x, cfg, ctx,
                          remat)
        aux = aux + a
    if cfg.n_layers > g * k:                     # the remainder scan
        x, aux = _scan(p["layers"], x, _ssm_block, cfg, ctx, remat, aux,
                       g * k)
    return x, aux


def _encoder_forward(p, enc_embed: torch.Tensor, cfg: ArchConfig,
                     ctx: ParallelCtx, remat=True) -> torch.Tensor:
    """Whisper's encoder: its own scan of bidirectional blocks over the
    frame embeddings, then ``enc_norm``.  Any truthy ``remat`` checkpoints
    its blocks fully (the reference's plain ``jax.checkpoint`` here)."""
    enc, _ = _scan(p["enc_layers"], enc_embed,
                   functools.partial(_dense_block, causal=False), cfg, ctx,
                   bool(remat), _zero(enc_embed))
    return L.rms_norm(enc, p["enc_norm"], cfg.norm_eps)


def forward(p, tokens: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx, *,
            vis_embed=None, enc_embed=None, remat=True):
    """Train/prefill forward -> (hidden [B,S,D], aux loss scalar).

    ``vis_embed`` [B, n_vis, D] (vlm) and ``enc_embed`` [B, n_frames, D]
    (encdec) are the frontend stubs, cast to the activation dtype.
    ``remat=True`` recomputes each block's activations in the backward
    pass (one checkpoint per block); ``"dots"`` keeps each block's matmul
    outputs and recomputes the rest; ``False`` keeps them all."""
    if remat not in (True, False, "dots"):
        raise ValueError(f"remat={remat!r}: True, False or 'dots'")
    x = embed_tokens(p, tokens, cfg, ctx)
    aux = _zero(x)
    fam = cfg.family
    if fam == "vlm":
        assert vis_embed is not None, "vlm needs stub patch embeddings"
        x = torch.cat([vis_embed.to(x.dtype), x], dim=1)
    if fam in ("dense", "vlm"):
        x, aux = _scan(p["layers"], x, _dense_block, cfg, ctx, remat, aux)
    elif fam == "encdec":
        assert enc_embed is not None, "encdec needs stub frame embeddings"
        enc = _encoder_forward(p, enc_embed.to(x.dtype), cfg, ctx, remat)
        (x, _), aux = _scan(p["layers"], (x, enc), _decoder_block, cfg, ctx,
                            remat, aux)
    elif fam == "moe":
        if "prefix" in p:                        # its aux is dropped
            x, _ = _scan(p["prefix"], x, _dense_block, cfg, ctx, remat, aux)
        x, aux = _scan(p["layers"], x, _moe_block, cfg, ctx, remat, aux)
    elif fam == "ssm":
        x, aux = _scan(p["layers"], x, _ssm_block, cfg, ctx, remat, aux)
    else:
        x, aux = _hybrid_forward(p, x, cfg, ctx, remat, aux)
    if fam == "vlm":
        x = x[:, vis_embed.shape[1]:]
    return L.rms_norm(x, p["final_norm"], cfg.norm_eps), aux


def lm_loss(p, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ctx: ParallelCtx, *, remat=True) -> torch.Tensor:
    """Mean next-token NLL over the local batch shard, plus the MoE
    router's aux loss times its weight.  The batch's frontend stubs
    (``vis_embed``, ``enc_embed``) go to ``forward``."""
    x, aux = forward(p, batch["tokens"], cfg, ctx,
                     vis_embed=batch.get("vis_embed"),
                     enc_embed=batch.get("enc_embed"), remat=remat)
    logits_l = lm_logits_local(p, x, cfg, ctx)
    loss = vocab_parallel_xent(logits_l, batch["labels"], ctx,
                               cfg.vocab).mean()
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


# ---------------------------------------------------------------------------
# decode caches (wave engine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Static decode-shape parameters.

    cache_len_local : per-shard sequence slice of the KV cache
    seq_shard       : None (cache local: this shard's kv_w heads) |
                      "model" | "model_data" (the sequence split over the
                      model axis, or data x model; every n_kv_heads)
    window_override : "cfg" or an int/None — the --swa-override variant
    """
    cache_len_local: int
    seq_shard: Optional[str] = "model"
    window_override: Any = "cfg"


def init_cache(cfg: ArchConfig, ctx: ParallelCtx, dcfg: DecodeConfig,
               batch_local: int, dtype=None, device=None):
    """Zero cache, this shard's local shapes: ``{"k", "v"}`` of [L, B, S,
    kv, hd] (dense, vlm, moe), plus ``{"xk", "xv"}`` of [L, B, n_frames,
    kv_w, hd] (encdec: the cross-attention cache, which nothing writes, as
    in the reference); ``{"ssm", "conv"}`` of [L, B, ...] (ssm, this
    shard's SSM heads); both SSM leaves plus ``{"attn_k", "attn_v"}`` of
    [groups, B, S, kv, hd] (hybrid).  ``kv`` is every KV head for a
    sequence-sharded cache, else this shard's ``kv_w``; the
    cross-attention cache always holds ``kv_w``."""
    dtype = dtype or cfg.dtype
    kv_w = L.head_layout(cfg, ctx)[1] if cfg.n_heads else 0
    kv_s = cfg.n_kv_heads if dcfg.seq_shard is not None else kv_w

    def kv(n, heads=kv_s, length=dcfg.cache_len_local):
        return torch.zeros((n, batch_local, length, heads, cfg.head_dim_),
                           dtype=dtype, device=device)

    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
    if cfg.family == "encdec":
        n, se = cfg.n_layers, cfg.encdec.n_frames
        return {"k": kv(n), "v": kv(n), "xk": kv(n, kv_w, se),
                "xv": kv(n, kv_w, se)}
    c = _ssm_cache(cfg, ctx, batch_local, dtype, device)
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.hybrid.attn_every
        c["attn_k"], c["attn_v"] = kv(g), kv(g)
    return c


def _ssm_cache(cfg: ArchConfig, ctx: ParallelCtx, batch_local: int, dtype,
               device):
    ssm = cfg.ssm
    h_l = S._dims(cfg, ctx)[3]
    return {
        "ssm": torch.zeros((cfg.n_layers, batch_local, h_l, ssm.d_state,
                            ssm.head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((cfg.n_layers, batch_local,
                             ssm.conv_kernel - 1, h_l * ssm.head_dim),
                            dtype=dtype, device=device),
    }


def _prefix_records(ctx: ParallelCtx, stacked, p, i: int):
    """Block ``i`` of a decode stack: the first of each scan records, and
    every block of the moe family's dense prefix (a Python loop in the
    reference's decode paths)."""
    return _first_records(ctx, 0 if stacked is p.get("prefix") else i)


def _no_mla_decode(cfg: ArchConfig, step: str) -> None:
    if mla_of(cfg) is not None:
        raise ValueError(f"{step}: {cfg.name} has MLA, whose decode (a "
                         f"latent KV cache) is not built; it trains and "
                         f"prefills")


def decode_step(p, cache, token: torch.Tensor, pos, cfg: ArchConfig,
                ctx: ParallelCtx, dcfg: DecodeConfig):
    """One decode step: token [B,S] int, pos a scalar (a host int for a
    sequence-sharded cache) or [B] -> (logits [B,V_local], cache).  The
    cache tensors are updated in place; every self-attention runs over a
    cache sequence-sharded by ``dcfg.seq_shard``; encdec's cross-attention
    reads the cache's ``xk``/``xv``."""
    _no_mla_decode(cfg, "decode_step")
    x = embed_tokens(p, token, cfg, ctx)
    pos_arr = torch.as_tensor(pos, device=x.device)
    steps = torch.arange(token.shape[1], device=x.device)
    positions = pos_arr[:, None] + steps if pos_arr.ndim else pos_arr + steps

    def attn(lp, x, ck, cv):
        """Attention over one cache slice, written back in place."""
        h, (nk, nv) = L.attention_block(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, ctx,
            positions=positions, kv_cache=(ck, cv), cache_pos=pos,
            seq_shard=dcfg.seq_shard, window_override=dcfg.window_override)
        ck.copy_(nk)
        cv.copy_(nv)
        return x + h

    def ffn(lp, x):
        xn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if "mlp" in lp:
            return x + L.mlp_block(lp["mlp"], xn, ctx)
        return x + M.moe_block(lp["moe"], xn, cfg, ctx)[0]

    def mamba(i, x):
        lp = _layer(p["layers"], i)
        h, ns = S.ssm_block(lp["ssm"], L.rms_norm(x, lp["ln"], cfg.norm_eps),
                            cfg, ctx, state={"ssm": cache["ssm"][i],
                                             "conv": cache["conv"][i]})
        cache["ssm"][i] = ns["ssm"]
        cache["conv"][i] = ns["conv"]
        return x + h

    def xattn(lp, x, i):
        h, _ = L.attention_block(
            lp["xattn"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps), cfg, ctx,
            xattn_kv=(cache["xk"][i], cache["xv"][i]))
        return x + h

    fam = cfg.family
    if fam == "encdec":
        for i in range(cfg.n_layers):           # lax.scan in the reference
            lp = _layer(p["layers"], i)
            with _first_records(ctx, i):
                x = ffn(lp, xattn(lp, attn(lp, x, cache["k"][i],
                                           cache["v"][i]), i))
    elif fam in ("dense", "vlm", "moe"):
        # the moe family's dense prefix takes cache layers [0, npre)
        base = 0
        for stacked in _stacks(p):
            for i in range(_depth(stacked)):   # lax.scan in the reference
                lp = _layer(stacked, i)
                with _prefix_records(ctx, stacked, p, i):
                    x = ffn(lp, attn(lp, x, cache["k"][base + i],
                                     cache["v"][base + i]))
            base += _depth(stacked)
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            with _first_records(ctx, i):
                x = mamba(i, x)
    else:                                    # hybrid: the group scan, then
        k = cfg.hybrid.attn_every            # the remainder scan
        g = cfg.n_layers // k
        sp = p["shared_attn"]
        for gi in range(g):
            with _first_records(ctx, gi):
                for i in range(gi * k, (gi + 1) * k):
                    with _first_records(ctx, i - gi * k):
                        x = mamba(i, x)
                x = ffn(sp, attn(sp, x, cache["attn_k"][gi],
                                 cache["attn_v"][gi]))
        for i in range(g * k, cfg.n_layers):
            with _first_records(ctx, i - g * k):
                x = mamba(i, x)

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


PAGED_FAMILIES = ("dense", "vlm", "moe")


def init_paged_pool(cfg: ArchConfig, ctx: ParallelCtx, pcfg: PagedConfig,
                    dtype=None, device=None):
    """Zero paged KV pool: ``[L, n_blocks, block_size, kv_w, hd]`` per K
    and V.  Block contents are never zeroed again — reuse relies on
    kv_valid masking (serving/paged_kv.py)."""
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"paged serving supports {PAGED_FAMILIES}, got {cfg.family} "
            f"(ssm/hybrid/encdec stay on the wave engine)")
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

    Returns (logits [R, V_local], pool); the pool is updated in place.
    Padding rows cost zero attention mass and zero pool writes; the MoE
    routes them all the same, so they take expert capacity, as the
    reference's
    (the capacity counts the padded bucket).  The moe family's dense
    prefix takes pool layers [0, npre).
    """
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(cfg.family)
    _no_mla_decode(cfg, "paged_decode_step")
    valid = row_req >= 0
    n_req = block_tables.shape[0]
    btab = block_tables[torch.clamp(row_req, 0, n_req - 1).long()]
    kv_valid = torch.where(valid, positions + 1, 0)
    x = embed_tokens(p, tokens[:, None], cfg, ctx)           # [T, 1, D]

    base = 0
    for stacked in _stacks(p):
        for i in range(_depth(stacked)):     # lax.scan in the reference
            lp = _layer(stacked, i)
            with _prefix_records(ctx, stacked, p, i):
                h, _ = L.paged_attention_block(
                    lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                    ctx, positions=positions, kv_valid=kv_valid,
                    pools=(pool["k"][base + i], pool["v"][base + i]),
                    block_tables=btab, window_override=pcfg.window_override,
                    impl=pcfg.attn_impl)
                x = x + h
                xn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
                if "mlp" in lp:
                    x = x + L.mlp_block(lp["mlp"], xn, ctx)
                else:
                    x = x + M.moe_block(lp["moe"], xn, cfg, ctx)[0]
        base += _depth(stacked)

    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    xs = x[torch.clamp(sample_rows, 0, x.shape[0] - 1).long()]  # [R, 1, D]
    return lm_logits_local(p, xs, cfg, ctx)[:, 0], pool
