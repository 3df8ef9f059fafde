"""The four assigned input shapes and their meta-tensor stand-ins.

Port of ``src/repro/launch/shapes.py``.  ``input_specs(cfg, shape, ...)``
returns a ``torch.empty(..., device="meta")`` tensor (shape and dtype, no
storage) for every model input, in place of the reference's
``jax.ShapeDtypeStruct``.  The partition specs are the port's per-dim
axis tuples, the convention of ``layers.attention_specs`` and
``convert.spec_axes``: each entry is None (replicated), a mesh axis name,
or a tuple of axis names, outermost first, for a dim split over several
(``("data", "model")``: the batch-1 decode cache's sequence dim).

Shape semantics:
  train_4k     the train step    (tokens + labels, full fwd + bwd + opt)
  prefill_32k  the prefill step  (forward only, last-position logits)
  decode_32k   the serve step    (ONE token, KV cache of seq_len)
  long_500k    the serve step    with a 524288-long sharded cache;
               requires sub-quadratic attention (SSM/hybrid native; SWA
               native for mixtral/starcoder2; the --swa-override variant
               for the remaining full-attention archs)
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import DecodeConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}

#: archs with native sub-quadratic long-context support
NATIVE_SUBQUADRATIC = {
    "mamba2-1.3b",      # SSM: O(1) state
    "zamba2-1.2b",      # hybrid
    "mixtral-8x7b",     # native SWA 4096
    "starcoder2-15b",   # native SWA 4096
}


def needs_swa_override(cfg: ArchConfig, shape: InputShape) -> bool:
    """long_500k on a pure full-attention arch -> run the documented
    sliding-window decode variant."""
    return (shape.name == "long_500k"
            and cfg.name not in NATIVE_SUBQUADRATIC
            and cfg.family not in ("ssm", "hybrid"))


def decode_config(cfg: ArchConfig, shape: InputShape, *,
                  tp: int, dp: int) -> DecodeConfig:
    """The serve step's DecodeConfig: batch 1 shards the cache's sequence
    over data x model, a larger batch over model alone (its rows split
    over data); one shard in all keeps the cache local."""
    if shape.kind != "decode":
        raise ValueError(f"decode_config: {shape.name} is a "
                         f"{shape.kind} shape")
    if shape.global_batch == 1:
        seq_shard, shards = "model_data", tp * dp
    else:
        seq_shard, shards = "model", tp
    shards = max(shards, 1)
    if shape.seq_len % shards:
        raise ValueError(f"seq_len {shape.seq_len} does not divide over "
                         f"{shards} shards")
    window = 4096 if needs_swa_override(cfg, shape) else "cfg"
    return DecodeConfig(cache_len_local=shape.seq_len // shards,
                        seq_shard=seq_shard if shards > 1 else None,
                        window_override=window)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                tp: int = 1, dp: int = 1, pods: int = 1,
                dtype=None) -> Dict[str, Any]:
    """GLOBAL-shaped meta tensors for one (arch, input-shape) pair.

    Frontend stubs: whisper gets frame embeddings, internvl2 patch
    embeddings, both [B, n, d_model].
    """
    dtype = dtype or cfg.dtype
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"tokens": _meta((b, s), torch.int32),
                                 "labels": _meta((b, s), torch.int32)}
        if cfg.family == "vlm":
            specs["vis_embed"] = _meta((b, cfg.vlm.n_vis_tokens,
                                        cfg.d_model), dtype)
        if cfg.family == "encdec":
            specs["enc_embed"] = _meta((b, cfg.encdec.n_frames,
                                        cfg.d_model), dtype)
        return specs
    # decode: ONE new token + cache of seq_len
    dcfg = decode_config(cfg, shape, tp=tp, dp=dp)
    return {"token": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": cache_specs(cfg, shape, dcfg, tp=tp, dp=dp,
                                 dtype=dtype)}


def cache_specs(cfg: ArchConfig, shape: InputShape, dcfg: DecodeConfig, *,
                tp: int, dp: int, dtype) -> Dict[str, Any]:
    """GLOBAL cache shapes (sequence dim = the full seq_len; the mesh
    shards it per ``input_partition_specs``).  The head layout comes from
    the sizes alone (``head_layout`` reads only ``tp_size``), with no
    communicator behind it."""
    shards = types.SimpleNamespace(tp_size=tp)
    b, s, hd = shape.global_batch, shape.seq_len, cfg.head_dim_
    fam = cfg.family
    out: Dict[str, Any] = {}
    if fam in ("ssm", "hybrid"):
        ssm = cfg.ssm
        out["ssm"] = _meta((cfg.n_layers, b, ssm.n_heads(cfg.d_model),
                            ssm.d_state, ssm.head_dim), torch.float32)
        out["conv"] = _meta((cfg.n_layers, b, ssm.conv_kernel - 1,
                             ssm.d_inner(cfg.d_model)), dtype)
        if fam == "ssm":
            return out
    # sequence-sharded caches store the FULL KV head set per shard; a
    # local one the kv_w heads of a shard's Q heads
    kv_w = L.head_layout(cfg, shards)[1]
    kv = cfg.n_kv_heads if dcfg.seq_shard is not None else kv_w
    if fam == "hybrid":
        g = cfg.n_layers // cfg.hybrid.attn_every
        out["attn_k"] = _meta((g, b, s, kv, hd), dtype)
        out["attn_v"] = _meta((g, b, s, kv, hd), dtype)
        return out
    if fam not in ("dense", "vlm", "moe", "encdec"):
        raise ValueError(fam)
    n = cfg.n_layers
    out["k"] = _meta((n, b, s, kv, hd), dtype)
    out["v"] = _meta((n, b, s, kv, hd), dtype)
    if fam == "encdec":
        # cross-attention KV: the encoder axis is not sequence-sharded, so
        # each shard stores only the kv_w heads its local Q heads use
        se = cfg.encdec.n_frames
        out["xk"] = _meta((n, b, se, kv_w, hd), dtype)
        out["xv"] = _meta((n, b, se, kv_w, hd), dtype)
    return out


# ---------------------------------------------------------------------------
# partition specs for the inputs (mesh axes: ["pod",] ["node",] "data",
# "model")
# ---------------------------------------------------------------------------

def batch_axes(pods: int, nodes: int = 1):
    """The mesh axes the global batch is split over, outermost first:
    pod (DCN), node (cluster NIC tier), data (in-node DP)."""
    axes = []
    if pods > 1:
        axes.append("pod")
    if nodes > 1:
        axes.append("node")
    axes.append("data")
    return tuple(axes)


def _entry(axes):
    """One spec entry: a lone axis by its name, several as a tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def input_partition_specs(cfg: ArchConfig, shape: InputShape, *,
                          tp: int, dp: int, pods: int = 1, nodes: int = 1):
    """Per input (and per cache leaf for decode), the mesh axes of each
    dim.  Decode stays within one node: a multi-node mesh replicates the
    decode wave over the node axis."""
    ba = _entry(batch_axes(pods, nodes))
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": (ba, None), "labels": (ba, None)}
        if cfg.family == "vlm":
            specs["vis_embed"] = (ba, None, None)
        if cfg.family == "encdec":
            specs["enc_embed"] = (ba, None, None)
        return specs
    decode_config(cfg, shape, tp=tp, dp=dp)      # the shape must divide
    if shape.global_batch == 1:
        tok, seq, bat = (None, None), ("data", "model"), None
    else:
        tok, seq, bat = ("data", None), "model", "data"
    fam = cfg.family
    cache: dict = {}
    if fam in ("dense", "vlm", "moe", "encdec"):
        cache["k"] = (None, bat, seq, None, None)
        cache["v"] = (None, bat, seq, None, None)
        if fam == "encdec":
            # cross-attention KV is short (n_frames): the seq dim replicated
            cache["xk"] = (None, bat, None, None, None)
            cache["xv"] = (None, bat, None, None, None)
    else:
        cache["ssm"] = (None, bat, "model", None, None)
        cache["conv"] = (None, bat, None, "model")
        if fam == "hybrid":
            cache["attn_k"] = (None, bat, seq, None, None)
            cache["attn_v"] = (None, bat, seq, None, None)
    return {"token": tok, "pos": (), "cache": cache}
