"""Kimi-K2-Instruct's blocks in the port (``MLAArchConfig``): multi-head
latent attention with YaRN RoPE, the biased sigmoid router, the shared
expert and the layer that holds a share of its experts, held against the
plain float32 reference of the benchmark's ``mla_moe`` family
(``bench/reference/mla_moe.py``, which imports nothing of the port) at
that family's CPU cut, on seeded weights.  No JAX: the reference package
has no such model."""

import dataclasses
import json
import math
import pathlib
import sys
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import cells  # noqa: E402
from bench import weights as W  # noqa: E402
from bench.reference import mla_moe as R  # noqa: E402
from bench.reference import model as RM  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.tp import ParallelCtx  # noqa: E402
from repro_torch.models.transformer import (DecodeConfig,  # noqa: E402
                                            PagedConfig, decode_step,
                                            lm_loss, paged_decode_step)

SEED = 2 ** 31 + 33
#: float32 on both sides, the same equations in other orders of summation
#: (the chunked streaming softmax against one softmax a query block, the
#: scatter of slots against a loop over experts): what is left is
#: rounding, about 1e-7 of a leaf's gradient; 1e-5 leaves a hundredfold
#: room and is far below any change of the mathematics (a dropped term
#: moves a leaf by its own share, 1e-2 or more)
GRAD_RTOL = 1e-5


def _file_cfg():
    return json.loads((ROOT / "bench" / "configs" / "kimi-k2-instruct.json")
                      .read_text())


def _small():
    """The family's CPU cut and the port's config of it, in float32."""
    cfg = R.small(_file_cfg())
    arch = dataclasses.replace(cells.program_config(cfg),
                               param_dtype="float32")
    return cfg, arch


def _batch(rows=2, seq=64, vocab=256):
    g = torch.Generator().manual_seed(SEED)
    tok = torch.randint(0, vocab, (rows, seq + 1), generator=g)
    return tok[:, :-1], tok[:, 1:]


def test_program_loss_and_every_gradient_match_the_reference():
    cfg, arch = _small()
    params = W.make(cfg, SEED, "cpu", torch.float32)
    leaves = W.flatten(params)
    for _, x in leaves:
        x.requires_grad_(True)
    tokens, labels = _batch()
    xs = [x for _, x in leaves]
    got = lm_loss(params, {"tokens": tokens, "labels": labels}, arch,
                  ParallelCtx(), remat=True)
    g_got = torch.autograd.grad(got, xs)
    want = R.loss(params, tokens, labels, cfg)
    g_want = torch.autograd.grad(want, xs)
    # the loss: a mean of 128 NLLs and the balance term, both in float32
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-6)
    for (path, _), a, b in zip(leaves, g_got, g_want):
        name = "/".join(path)
        if name.endswith("router_bias"):
            # the bias selects and never weighs: exactly zero on both
            assert not a.any() and not b.any(), name
            continue
        assert b.norm() > 0, name
        assert float((a - b).norm() / b.norm()) < GRAD_RTOL, name


def test_router_selects_by_score_plus_bias_and_weighs_by_score():
    _, arch = _small()
    moe = arch.moe
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(64, arch.d_model, generator=g)
    w = torch.randn(arch.d_model, moe.n_router, generator=g) * 0.3
    bias = (torch.randn(moe.n_router, generator=g) * 0.5).requires_grad_()
    weights, idx, aux = M.route_sigmoid(x, w, bias, moe, seqs=2)
    s = torch.sigmoid(x @ w)
    want_idx = torch.sort(s + bias.detach(), dim=-1, descending=True,
                          stable=True)[1][:, :moe.top_k]
    assert torch.equal(idx, want_idx)
    # the bias changed some choices, so the check above tells
    plain = torch.sort(s, dim=-1, descending=True)[1][:, :moe.top_k]
    assert not torch.equal(idx.sort(-1)[0], plain.sort(-1)[0])
    picked = s.gather(1, idx)
    assert torch.allclose(weights, 2.827 * picked / picked.sum(-1, True),
                          rtol=1e-6)
    assert torch.allclose(weights.sum(-1), torch.full((64,), 2.827),
                          rtol=1e-6)
    (gb,) = torch.autograd.grad(aux + weights.sum(), bias)
    assert not gb.any()
    # the sequence-wise balance loss, per sequence of 32, as DeepSeek-V3
    r, k = moe.n_router, moe.top_k
    chosen = torch.zeros_like(s).scatter(1, idx, 1.0).view(2, 32, r)
    f = chosen.sum(1) * r / (k * 32)
    p = (s / s.sum(-1, keepdim=True)).view(2, 32, r).mean(1)
    assert float(aux.detach()) == pytest.approx(
        float((f * p).sum(-1).mean()), rel=1e-6)


def test_yarn_at_the_published_widths():
    arch = get_config("kimi-k2-instruct")
    m = arch.mla
    assert m.yarn_ramp(arch.rope_theta) == (19, 20)
    assert m.softmax_scale == pytest.approx(0.130861, abs=5e-7)
    assert m.softmax_scale == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2, rel=1e-12)
    freqs = L.yarn_freqs(m, arch.rope_theta)
    base = L.rope_freqs(64, 50000.0)
    assert freqs.shape == (32,)
    assert torch.equal(freqs[:20], base[:20])
    assert torch.equal(freqs[20:], base[20:] / 32)
    # the reference's, worked out in float64 from the file's own group
    want, scale = R.yarn(_file_cfg())
    assert torch.allclose(freqs.double(), want, rtol=1e-6, atol=0)
    assert m.softmax_scale == pytest.approx(scale, rel=1e-12)


@pytest.mark.parametrize("chunk", [16, 64])
def test_value_width_and_scale_against_a_dense_softmax(chunk):
    g = torch.Generator().manual_seed(SEED)
    b, s, hq, hkv, hd, hv = 2, 37, 4, 2, 12, 7
    q = torch.randn(b, s, hq, hd, generator=g)
    k = torch.randn(b, s, hkv, hd, generator=g)
    v = torch.randn(b, s, hkv, hv, generator=g)
    out = L.chunked_attention(q, k, v, causal=True, chunk=chunk, scale=0.3)
    kk = k.repeat_interleave(hq // hkv, dim=2)
    vv = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 0.3
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    assert out.shape == (b, s, hq, hv)
    assert torch.allclose(out, want, atol=2e-6, rtol=1e-5)
    # the default scale is 1/sqrt(hd), bit for bit the explicit one
    v2 = torch.randn(b, s, hkv, hd, generator=g)
    assert torch.equal(
        L.chunked_attention(q, k, v2, causal=True, chunk=chunk),
        L.chunked_attention(q, k, v2, causal=True, chunk=chunk,
                            scale=1.0 / math.sqrt(hd)))


def test_shares_add_up_to_the_uncut_layer():
    """Router width 8, 2 experts held: shares 0-3 each compute their
    experts' part; those parts plus the shared expert once equal the
    layer that holds all 8, the program's and the reference's."""
    cfg, arch = _small()
    d, f = arch.d_model, arch.d_expert
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(2, 32, d, generator=g)
    full = {"w_router": torch.randn(d, 8, generator=g) * 0.3,
            "router_bias": torch.randn(8, generator=g) * 0.1,
            "experts": {"w_gate": torch.randn(8, d, f, generator=g) * 0.1,
                        "w_up": torch.randn(8, d, f, generator=g) * 0.1,
                        "w_down": torch.randn(8, f, d, generator=g) * 0.1},
            "shared": {"w_gate": torch.randn(d, f, generator=g) * 0.1,
                       "w_up": torch.randn(d, f, generator=g) * 0.1,
                       "w_down": torch.randn(f, d, generator=g) * 0.1}}
    ctx = ParallelCtx()

    def program(held, share):
        moe = dataclasses.replace(arch.moe, n_experts=held, router_experts=8,
                                  expert_share=share)
        lo = share * held
        p = dict(full, experts={k: v[lo:lo + held]
                                for k, v in full["experts"].items()})
        return M.moe_block(p, x, dataclasses.replace(arch, moe=moe), ctx)

    shared = L.mlp_block(full["shared"], x, ctx)
    uncut, aux = program(8, 0)
    parts = [program(2, j) for j in range(4)]
    total = shared + sum(y - shared for y, _ in parts)
    assert torch.allclose(total, uncut, atol=1e-6, rtol=1e-5)
    # every share routes over the same 8: the same balance loss
    assert all(float(a) == float(aux) for _, a in parts)
    # a share's part is its own: shares 0 and 1 differ
    assert not torch.allclose(parts[0][0], parts[1][0])
    want, want_aux = R.experts(x, full, dict(cfg, n_routed_experts=8,
                                             router_experts=8,
                                             expert_share=0), torch.matmul)
    assert torch.allclose(uncut, want, atol=1e-6, rtol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


def test_held_layer_counts_only_its_own_pairs():
    """``moe.assigned`` counts the pairs routed to held experts and
    ``moe.dropped`` those past capacity; the capacity is over the
    router's width (107 slots at 4096 tokens for Kimi-K2)."""
    from repro_torch.runtime import spans
    cfg, arch = _small()
    assert M.capacity_of(4096, get_config("kimi-k2-instruct").moe) == 107
    params = W.make(cfg, SEED, "cpu", torch.float32)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()
          if not isinstance(v, dict)}
    lp["experts"] = {k: v[0]
                     for k, v in params["layers"]["moe"]["experts"].items()}
    lp["shared"] = {k: v[0]
                    for k, v in params["layers"]["moe"]["shared"].items()}
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(1, 256, arch.d_model, generator=g)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        spans.counters()
        M.moe_block(lp, x, arch, ParallelCtx())
        got = spans.counters()
    _, idx, _ = M.route_sigmoid(x[0], lp["w_router"], lp["router_bias"],
                                arch.moe, 1)
    held = range(arch.moe.first_held,
                 arch.moe.first_held + arch.moe.n_experts)
    cap = M.capacity_of(256, arch.moe)
    counts = [int((idx == e).sum()) for e in held]
    assert 0 < sum(counts) < idx.numel()      # other pairs go elsewhere
    assert got["moe.assigned"] == sum(counts)
    assert got["moe.dropped"] == sum(max(c - cap, 0) for c in counts)


def _refusal_cfg():
    _, arch = _small()
    params = W.make(R.small(_file_cfg()), SEED, "cpu", torch.float32)
    return arch, params


def test_mla_refuses_a_model_axis():
    arch, params = _refusal_cfg()
    lp = {k: v[0] for k, v in params["prefix"]["attn"].items()}
    # the refusal comes before any collective, so a stand-in ctx will do
    ctx = types.SimpleNamespace(tp_size=2)
    with pytest.raises(ValueError, match="model axis"):
        L.attention_block(lp, torch.zeros(1, 4, arch.d_model), arch, ctx)


@pytest.mark.parametrize("step", ["decode_step", "paged_decode_step"])
def test_mla_refuses_decode(step):
    arch, params = _refusal_cfg()
    ctx = ParallelCtx()
    tok = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="MLA"):
        if step == "decode_step":
            decode_step(params, {}, tok, 0, arch, ctx,
                        DecodeConfig(cache_len_local=8, seq_shard=None))
        else:
            paged_decode_step(params, {}, tok[0], tok[0], tok[0],
                              torch.zeros(1, 1, dtype=torch.long), tok[0],
                              arch, ctx, PagedConfig())


def test_configs_of_the_reference_keep_their_fields():
    """The new settings live in classes only the new config carries: the
    ten reference configurations' MoE configs have none of them."""
    cfg = get_config("kimi-k2-instruct")
    assert cfg.name == "kimi-k2-instruct" and cfg.mla is not None
    mix = get_config("mixtral-8x7b")
    assert not hasattr(mix, "mla")
    assert "router_experts" not in dataclasses.asdict(mix.moe)
    assert mix.d_expert == mix.d_ff and mix.moe.n_router == 8
    assert RM.SMALL["hidden_size"] == R.small(_file_cfg())["hidden_size"]
