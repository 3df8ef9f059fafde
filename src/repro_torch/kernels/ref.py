"""Plain PyTorch versions of the port's kernels: the CPU path of
``kernels/ops.py`` and the check every kernel is held against on the card.

Port of ``src/repro/kernels/ref.py`` (the kernels this slice ports).
"""

from __future__ import annotations

import math

import torch


def chunk_accumulate_ref(a: torch.Tensor, b: torch.Tensor, *,
                         acc_dtype=torch.float32) -> torch.Tensor:
    """The staged ring's step reduce: ``a + b`` in ``acc_dtype``, rounded
    once to a's dtype."""
    return (a.to(acc_dtype) + b.to(acc_dtype)).to(a.dtype)


def paged_flash_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           kv_valid: torch.Tensor, *,
                           window=None) -> torch.Tensor:
    """Dense-gather version of kernels/flash_decode.py: materialize every
    row's [S, Hkv, hd] K/V via its block table, one fp32 softmax over the
    ``kv_valid`` prefix.  Masked scores are -inf, masked probabilities
    exact zeros, all-masked rows (kv_valid == 0, bucket padding) return
    exact zeros."""
    t_rows, hq, hd = q.shape
    nb, bs, hkv, _ = k_pool.shape
    maxb = block_tables.shape[1]
    s_len = maxb * bs
    flat = (block_tables[:, :, None].long() * bs +
            torch.arange(bs, device=q.device)[None, None, :]
            ).reshape(t_rows, s_len)
    k = k_pool.reshape(nb * bs, hkv, hd)[flat].float()
    v = v_pool.reshape(nb * bs, hkv, hd)[flat].float()
    group = hq // hkv
    qg = (q.float() / math.sqrt(hd)).reshape(t_rows, hkv, group, hd)
    s = torch.einsum("tkgd,tskd->tkgs", qg, k)
    k_pos = torch.arange(s_len, device=q.device)[None, :]
    kvv = kv_valid[:, None]
    keep = k_pos < kvv
    if window is not None:
        keep = keep & ((kvv - 1 - k_pos) < window)
    s = torch.where(keep[:, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    out = torch.einsum("tkgs,tskd->tkgd", p, v) / \
        torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(t_rows, hq, hd).to(q.dtype)
