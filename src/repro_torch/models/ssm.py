"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060].

Port of ``src/repro/models/ssm.py``.  Chunked dual form: within a chunk of
Q steps the output is a masked quadratic (attention-like) product; across
chunks a small recurrent state [H, d_state, hd] carries.  Mamba2's A is a
scalar per head, which keeps the decay algebra closed-form:

  decay(i, j) = exp(cum_a_i - cum_a_j),  cum_a = cumsum(dt * A)

  y_intra[i] = sum_{j<=i} decay(i,j) * (C_i . B_j) * dt_j * x_j
  state'     = exp(cum_a_Q) * state + sum_j exp(cum_a_Q - cum_a_j) dt_j B_j x_j^T
  y_inter[i] = exp(cum_a_i) * (C_i . state)

TP: heads are sharded over the model axis (in_proj column-parallel,
out_proj row-parallel with a FlexLink all-reduce); the recurrence is
local per head and needs no collective.  Decode is the O(1) recurrence
state' = da * state + dt * B x^T.

The reference's ``lax.scan`` over chunks is a Python loop over chunks,
in float32.  The intra-chunk decay takes ``exp`` of the masked exponent
(``-inf`` above the diagonal) where the reference masks ``exp`` of the
raw one: the values are the same, but torch's gradient of the
reference's form is ``0 * inf = NaN`` once a chunk's summed decay passes
float32's ``exp`` range (about 88), where XLA's stays finite.  It has no
kernel in the reference and none here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _normal, rms_norm, silu
from repro_torch.models.tp import ParallelCtx


def _dims(cfg: ArchConfig, ctx: ParallelCtx):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    n_heads = ssm.n_heads(cfg.d_model)
    tp = max(ctx.tp_size, 1)
    assert n_heads % tp == 0 or tp == 1, (n_heads, tp)
    h_l = n_heads // tp if tp > 1 else n_heads
    return ssm, d_in, n_heads, h_l


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             lead: Tuple[int, ...] = ()):
    """GLOBAL shapes with ``lead`` prepended; heads sharded over model by
    ``ssm_specs``.  dt_bias, a_log and d_skip are float32 whatever
    ``dtype`` (A = -exp(a_log))."""
    ssm = cfg.ssm
    d, hd, ds = cfg.d_model, ssm.head_dim, ssm.d_state
    h = ssm.n_heads(cfg.d_model)
    d_in = h * hd

    def f32(value):
        return torch.full(lead + (h,), value, dtype=torch.float32,
                          device=device)

    return {
        "w_in_z": _normal(gen, lead + (d, d_in), dtype, device),
        "w_in_x": _normal(gen, lead + (d, d_in), dtype, device),
        "w_in_b": _normal(gen, lead + (d, ds), dtype, device),
        "w_in_c": _normal(gen, lead + (d, ds), dtype, device),
        "w_in_dt": _normal(gen, lead + (d, h), dtype, device),
        "dt_bias": f32(0.0),
        "a_log": f32(0.0),
        "d_skip": f32(1.0),
        "conv_w": _normal(gen, lead + (ssm.conv_kernel, d_in), dtype, device),
        "norm_w": torch.ones(lead + (d_in,), dtype=dtype, device=device),
        "w_out": _normal(gen, lead + (d_in, d), dtype, device),
    }


def ssm_specs(model_axis: str):
    """The mesh axis of each dim of every leaf of ``init_ssm``."""
    return {
        "w_in_z": (None, model_axis), "w_in_x": (None, model_axis),
        "w_in_b": (None, None), "w_in_c": (None, None),
        "w_in_dt": (None, model_axis), "dt_bias": (model_axis,),
        "a_log": (model_axis,), "d_skip": (model_axis,),
        "conv_w": (None, model_axis), "norm_w": (model_axis,),
        "w_out": (model_axis, None),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x: [B,S,C]; w: [K,C].

    With conv_state [B,K-1,C] (decode), prepends the state; returns
    (y, new_state)."""
    k = w.shape[0]
    if conv_state is not None:
        xin = torch.cat([conv_state.to(x.dtype), x], dim=1)
        new_state = xin[:, -(k - 1):, :] if k > 1 else conv_state
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
        new_state = xin[:, -(k - 1):, :] if k > 1 else None
    # sum_k w[k] * x[t - K + 1 + k]
    s_out = x.shape[1]
    y = sum(xin[:, i:i + s_out, :] * w[i] for i in range(k))
    return y, new_state


def _ssd_chunked(xh, bt, ct, dt, a, chunk):
    """Chunked SSD scan.

    xh: [B,S,H,hd]  bt/ct: [B,S,ds]  dt: [B,S,H]  a: [H] (negative)
    returns (y [B,S,H,hd], final state [B,H,ds,hd])
    """
    b, s, h, hd = xh.shape
    ds = bt.shape[-1]
    q = chunk
    pad = (-s) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bt = F.pad(bt, (0, 0, 0, pad))
        ct = F.pad(ct, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = xh.reshape(b, nc, q, h, hd)
    bc = bt.reshape(b, nc, q, ds)
    cc = ct.reshape(b, nc, q, ds)
    dc = dt.reshape(b, nc, q, h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]

    state = torch.zeros((b, h, ds, hd), dtype=torch.float32,
                        device=xh.device)
    ys = []
    for c in range(nc):                      # lax.scan in the reference
        xq, bq, cq, dq = xc[:, c], bc[:, c], cc[:, c], dc[:, c]
        da = dq * a                                       # [B,q,H]
        cum = torch.cumsum(da, dim=1)                     # [B,q,H]
        # intra-chunk quadratic term
        li = cum[:, :, None, :] - cum[:, None, :, :]      # [B,qi,qj,H]
        decay = torch.exp(torch.where(mask, li, -torch.inf))
        cb = torch.einsum("bis,bjs->bij", cq, bq)         # [B,qi,qj]
        w_ij = decay * cb[..., None] * dq[:, None, :, :]  # [B,qi,qj,H]
        y_intra = torch.einsum("bijh,bjhd->bihd", w_ij, xq)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bis,bhsd->bihd", cq,
                               state) * torch.exp(cum)[..., None]
        # state update
        seg = torch.exp(cum[:, -1:, :] - cum)             # [B,q,H]
        upd = torch.einsum("bjh,bjs,bjhd->bhsd", dq * seg, bq, xq)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, hd)
    return (y[:, :s] if pad else y), state


def ssm_block(p, x: torch.Tensor, cfg: ArchConfig, ctx: ParallelCtx, *,
              state=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """One Mamba2 block.  x: [B,S,D].

    Train/prefill: state=None, chunked SSD.
    Decode: state={"ssm": [B,H_l,ds,hd], "conv": [B,K-1,d_in_l]}, S==1.
    Returns (out, new_state).
    """
    ssm, d_in, n_heads, h_l = _dims(cfg, ctx)
    hd = ssm.head_dim
    b, s, d = x.shape

    z = x @ p["w_in_z"]                                   # [B,S,d_in_l]
    xr = x @ p["w_in_x"]
    bt = (x @ p["w_in_b"]).float()
    ct = (x @ p["w_in_c"]).float()
    dt_raw = (x @ p["w_in_dt"]).float() + p["dt_bias"]
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus returns x
    # above its threshold)
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))  # [B,S,H_l]
    a = -torch.exp(p["a_log"])                            # [H_l]

    conv_state = state["conv"] if state is not None else None
    xr, new_conv = _causal_conv(xr, p["conv_w"], conv_state)
    xr = silu(xr)
    xh = xr.reshape(b, s, h_l, hd).float()

    if state is None:
        y, s_fin = _ssd_chunked(xh, bt, ct, dt, a, ssm.chunk)
        # the final state is returned for the prefill -> decode handoff
        new_state = {"ssm": s_fin, "conv": new_conv}
    else:
        # O(1) decode recurrence (S == 1)
        s_prev = state["ssm"].float()                     # [B,H_l,ds,hd]
        da = torch.exp(dt[:, 0] * a)                      # [B,H_l]
        upd = torch.einsum("bh,bs,bhd->bhsd", dt[:, 0], bt[:, 0], xh[:, 0])
        s_new = s_prev * da[:, :, None, None] + upd
        y = torch.einsum("bs,bhsd->bhd", ct[:, 0], s_new)[:, None]
        new_state = {"ssm": s_new, "conv": new_conv}

    y = y + xh * p["d_skip"][None, None, :, None]         # D skip connection
    y = y.reshape(b, s, h_l * hd).to(x.dtype)
    y = rms_norm(y, p["norm_w"], cfg.norm_eps) * silu(z)
    out = y @ p["w_out"]
    return ctx.tp_all_reduce(out), new_state
