"""The plain reference of the dense and moe families: forward and loss in
float32, written from the published description, with nothing of the
program under test.

A decoder of pre-norm blocks: RMSNorm, causal grouped-query attention with
rotary embeddings (each head's two halves rotated, the form the program
runs), a SwiGLU MLP or a top-k mixture of SwiGLU experts with a capacity
of ``ceil(tokens * k / experts * capacity_factor)`` (at least 4) a
expert, tokens past it falling back to the residual path, and a
Switch-style load-balance loss.  Each block is checkpointed and the head
runs in blocks of rows, so a whole stage fits on one card in float32.

``mm`` is the matrix product of every projection and expert (the control
swaps in a lower-precision one); attention's own products and the router
stay in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: rows of the LM head and loss computed at once
HEAD_ROWS = 1024

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd] at positions 0..S-1: the pair (i, i + hd/2) of each
    head rotated by position * theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(h: torch.Tensor, p: Dict, cfg: Dict, mm: Matmul) -> torch.Tensor:
    bsz, s, _ = h.shape
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    q = mm(h, p["wq"])
    k = mm(h, p["wk"])
    v = mm(h, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rotary(q.view(bsz, s, nh, hd), cfg["rope_theta"])
    k = rotary(k.view(bsz, s, nkv, hd), cfg["rope_theta"])
    v = v.view(bsz, s, nkv, hd)
    # query head j reads key/value head j // (nh / nkv)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    pos = torch.arange(s, device=h.device)
    dist = pos[:, None] - pos[None, :]
    keep = dist >= 0
    if cfg.get("sliding_window"):
        keep = keep & (dist < cfg["sliding_window"])
    scores = scores.masked_fill(~keep, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return mm(out.reshape(bsz, s, nh * hd), p["wo"])


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, mm: Matmul) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def experts(h: torch.Tensor, p: Dict, cfg: Dict, mm: Matmul):
    """The mixture of experts: (output, load-balance loss)."""
    bsz, s, d = h.shape
    x = h.reshape(bsz * s, d)
    t = x.shape[0]
    n_exp, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ p["w_router"], dim=-1)
    top_p, top_e = probs.topk(k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    share = torch.bincount(top_e.reshape(-1), minlength=n_exp) / (t * k)
    aux = n_exp * torch.sum(share * probs.mean(0))
    cap = max(math.ceil(t * k / n_exp * cfg["capacity_factor"]), 4)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    ex = p["experts"]
    y = torch.zeros_like(x)
    for e in range(n_exp):
        # the first `cap` (token, choice) pairs routed to e, in token order
        picks = torch.nonzero(flat_e == e).squeeze(1)[:cap]
        rows = picks // k
        out = swiglu(x[rows], ex["w_gate"][e], ex["w_up"][e],
                     ex["w_down"][e], mm)
        y = y.index_add(0, rows, out * flat_p[picks, None])
    return y.view(bsz, s, d), aux


def block(x: torch.Tensor, p: Dict, cfg: Dict, mm: Matmul):
    """One decoder block: (x, load-balance loss or 0)."""
    eps = cfg["rms_norm_eps"]
    x = x + attention(rms_norm(x, p["ln1"], eps), p["attn"], cfg, mm)
    h = rms_norm(x, p["ln2"], eps)
    if "moe" in p:
        y, aux = experts(h, p["moe"], cfg, mm)
        return x + y, aux
    m = p["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"], mm), \
        torch.zeros((), device=x.device)


def _layer(tree: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _nll_sum(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             mm: Matmul) -> torch.Tensor:
    logits = mm(x, w)
    picked = logits.gather(-1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum()


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, mm: Matmul = torch.matmul) -> torch.Tensor:
    """Mean next-token NLL over the rows, plus the load-balance loss of
    every expert layer times its weight."""
    x = params["embed"][tokens.long()]
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        x, a = checkpoint(block, x, _layer(params["layers"], i), cfg, mm,
                          use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    w = params["embed"].T if cfg.get("tie_word_embeddings") \
        else params["lm_head"]
    flat, lab = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    total = sum(checkpoint(_nll_sum, flat[r:r + HEAD_ROWS], w,
                           lab[r:r + HEAD_ROWS], mm, use_reentrant=False)
                for r in range(0, flat.shape[0], HEAD_ROWS))
    out = total / flat.shape[0]
    if cfg["family"] == "moe":
        out = out + cfg["router_aux_loss_coef"] * aux
    return out
