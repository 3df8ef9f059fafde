"""The port's vlm and encdec families against the JAX reference.

The parameters are the reference's ``init_params`` trees (float32)
carried across by ``convert.py``; inputs are drawn from a seeded numpy
generator and go through both packages.  On one device:
``attention_block``'s cross-attention and its bidirectional form at a
length off ``ATTN_CHUNK`` (1e-5), ``init_params`` keys, shapes and
dtypes, forward logits (1e-5) and ``lm_loss`` gradients leaf by leaf
(relative 1e-5) at remat on and off for reduced internvl2-76b /
whisper-medium and tests/test_models.py's ``FAMILY_CFGS["vlm"]`` /
``["encdec"]``, 3 train steps (losses within 5e-3), the prefill step,
Whisper's teacher-forced decode over a cross-attention cache filled from
the encoder output, greedy streams of Whisper's wave engine and
InternVL2's paged engine (dense gather and kernel) equal to the JAX
engines', the pinned quirk that a served Whisper request's
cross-attention adds exactly zero, the paged pool's refusal of encdec,
and every one of the ten configs trained and served at ``reduced()``.

On a (data=2, model=2) mesh, 4 gloo ranks spawned once (rank side in
``_torch_ranks.vlm_encdec``) against the reference's ``shard_map`` on
the conftest's CPU devices, for reduced whisper and internvl2 with the
model axis's all-reduce slot pinned to primary 50 / staged 25 / ortho
25: 3 steps of nccl and flexlink, what both axes recorded after one step
and their plan signatures, the prefill program's logits against the
reference's shards, and Whisper checkpoints across packages both ways.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _torch_ranks
from repro.configs import get_config as j_get_config
from repro.core import communicator as j_comm
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import single_device_ctx as j_ctx
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_reference, shard_params
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import config as TC
from repro_torch.models import layers as TL
from repro_torch.models import single_device_ctx as t_ctx
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

TOL = 5e-3          # per-step losses, as tests/test_torch_train.py
REL_GRAD = 1e-5     # a gradient leaf's relative error norm, float32
STEPS = 3
PROFILE = "h800"
SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}
MESH = (2, 2)
ARCHS = ("whisper-medium", "internvl2-76b")


def t_config(jcfg):
    """The port's ArchConfig with the same data as a reference one."""
    d = dataclasses.asdict(jcfg)
    for key, cls in (("encdec", TC.EncDecConfig), ("vlm", TC.VLMConfig)):
        if d.get(key) is not None:
            d[key] = cls(**d[key])
    return TC.ArchConfig(**d)


def j_init(jcfg):
    """The reference's ``init_params`` tree, jitted."""
    return jax.jit(j_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)


def _family(name):
    from test_models import FAMILY_CFGS
    return FAMILY_CFGS[name]


CFGS = {"internvl2": lambda: j_get_config("internvl2-76b").reduced(),
        "whisper": lambda: j_get_config("whisper-medium").reduced(),
        "family-vlm": lambda: _family("vlm"),
        "family-encdec": lambda: _family("encdec")}


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    jcfg = CFGS[request.param]()
    jp = j_init(jcfg)
    return jcfg, t_config(jcfg), jp, params_from_reference(
        jax.tree.map(np.asarray, jp))


def _inputs(cfg, b=2, s=12, seed=0):
    """Tokens, labels and the family's frontend stub, from a seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vis_embed"] = (rng.standard_normal(
            (b, cfg.vlm.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_embed"] = (rng.standard_normal(
            (b, cfg.encdec.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _stubs(batch, conv):
    return {k: conv(v) for k, v in batch.items()
            if k in ("vis_embed", "enc_embed")}


# ---------------------------------------------------------------------------
# attention and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["xattn", "bidirectional-600"])
def test_attention_block_matches_reference(case):
    """Cross-attention over given K/V (Q projected, no RoPE, no mask) and
    the encoder's bidirectional self-attention at 600 positions (one
    full ATTN_CHUNK and a padded tail masked by local index)."""
    jcfg = j_get_config("whisper-medium").reduced()
    tcfg = t_config(jcfg)
    ap = JL.init_attention(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = params_from_reference(jax.tree.map(np.asarray, ap))
    rng = np.random.default_rng(4)
    s = 7 if case == "xattn" else 600
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    kv = None
    if case == "xattn":
        kv = [rng.standard_normal((2, 600, jcfg.n_kv_heads, jcfg.head_dim_)
                                  ).astype(np.float32) for _ in range(2)]
    else:
        assert s % TL.ATTN_CHUNK and s > TL.ATTN_CHUNK

    def conv(f):
        return None if kv is None else tuple(map(f, kv))
    jo, _ = jax.jit(lambda p, x, kv: JL.attention_block(
        p, x, jcfg, j_ctx(), causal=False, xattn_kv=kv))(
            ap, jnp.asarray(x), conv(jnp.asarray))
    to, cache = TL.attention_block(tp, torch.from_numpy(x), tcfg, t_ctx(),
                                   causal=False,
                                   xattn_kv=conv(torch.from_numpy))
    assert cache is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)


def test_init_params_match_reference(model):
    """The port's own init and the carried-over reference tree share keys,
    shapes and dtypes (encdec: ``enc_layers``, ``enc_norm``, and decoder
    blocks with ``ln_x`` and an ``xattn`` subtree); the specs tree names
    the same leaves."""
    jcfg, tcfg, _, tp = model
    own = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in _paths(own)} == \
        {k: (tuple(v.shape), v.dtype) for k, v in _paths(tp)}
    specs = TT.param_specs(tcfg)
    assert set(k for k, _ in _paths(specs)) == \
        set(k for k, _ in _paths(own))
    if tcfg.family == "encdec":
        assert {"enc_layers", "enc_norm"} <= set(own)
        assert set(own["layers"]["xattn"]) == set(own["layers"]["attn"])
        assert own["layers"]["ln_x"].shape == (tcfg.n_layers, tcfg.d_model)


def _paths(tree, prefix=""):
    """[("a/b/c", leaf)] of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _paths(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


# ---------------------------------------------------------------------------
# forward, gradients, train steps, prefill
# ---------------------------------------------------------------------------

def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def j_grads(model):
    """The reference's logits, ``lm_loss`` and its gradient on
    ``_inputs``, one jitted call (its remat changes no value)."""
    jcfg, _, jp, _ = model
    jb = {k: jnp.asarray(v) for k, v in _inputs(jcfg).items()}

    def f(p, b):
        x, _ = JT.forward(p, b["tokens"], jcfg, j_ctx(),
                          **_stubs(b, lambda v: v))
        loss, g = jax.value_and_grad(
            lambda q: JT.lm_loss(q, b, jcfg, j_ctx()))(p)
        return JT.lm_logits_local(p, x, jcfg, j_ctx()), loss, g
    logits, loss, g = jax.jit(f)(jp, jb)
    return (np.asarray(logits), float(loss),
            _torch_ranks.flat_leaves(jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("remat", [True, False])
def test_forward_and_grads_match_reference(model, j_grads, remat):
    """Logits of ``forward`` (1e-5) and every ``lm_loss`` gradient leaf
    (relative error norm 1e-5), with and without per-block checkpoints;
    the encoder's stub gets a gradient through every decoder block."""
    jcfg, tcfg, _, tp = model
    jl, jloss, want = j_grads
    tb = {k: torch.from_numpy(v) for k, v in _inputs(jcfg).items()}
    leaves, spec = pytree.tree_flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    stub = next(iter(_stubs(tb, lambda v: v.requires_grad_(True)).values()))
    tx, _ = TT.forward(tp, tb["tokens"], tcfg, t_ctx(), remat=remat,
                       **_stubs(tb, lambda v: v))
    tl = TT.lm_logits_local(tp, tx, tcfg, t_ctx()).detach().numpy()
    real = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), real)
    np.testing.assert_allclose(tl[real], jl[real], atol=1e-5, rtol=1e-5)
    tloss = TT.lm_loss(tp, tb, tcfg, t_ctx(), remat=remat)
    grads = torch.autograd.grad(tloss, leaves + [stub])
    for p in leaves:
        p.requires_grad_(False)
    assert abs(tloss.item() - jloss) < 1e-5
    got = _torch_ranks.flat_leaves(pytree.tree_unflatten(list(grads[:-1]),
                                                         spec))
    assert got.keys() == want.keys()
    bad = {k: e for k in want if (e := _rel(got[k], want[k])) > REL_GRAD}
    assert not bad, bad
    assert float(grads[-1].abs().max()) > 0


@pytest.mark.parametrize("name", ["internvl2", "whisper"])
def test_three_steps_match_reference(name):
    """``build_train_step`` on one device, 3 AdamW steps with the stubs in
    the batch, against the reference's on a (1, 1) mesh."""
    from repro.data.pipeline import make_batches as j_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_step as j_build
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.data.pipeline import make_batches
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_state
    jcfg = CFGS[name]()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    j_comm.comm_destroy_all()
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep, _ = j_build(jcfg, mesh, opt=JOpt(lr=1e-3, warmup_steps=2,
                                            total_steps=20),
                       shape=SH.InputShape("t", "train", 32, 4))
    step, _ = build_train_step(tcfg, opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20), device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    ts = init_state(tp)
    js = j_init_state(jp)
    jb = j_batches(jcfg, seq_len=32, batch_per_shard=4, seed=7)
    tb = make_batches(tcfg, seq_len=32, batch_per_shard=4, seed=7)
    losses = []
    with mesh:
        for _ in range(STEPS):
            jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                        for k, v in next(jb).items()})
            tp, ts, tm = step(tp, ts, next(tb))
            losses.append((float(tm["loss"]), float(jm["loss"])))
    j_comm.comm_destroy_all()
    assert all(abs(a - b) < TOL for a, b in losses), losses
    assert losses[-1][0] < losses[0][0]


@pytest.mark.parametrize("name", ["internvl2", "whisper"])
def test_prefill_step_matches_reference(name):
    """The prefill step's last-position logits [B, V] with the stubs,
    against the reference's ``build_prefill_step`` on a (1, 1) mesh."""
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_prefill_step as j_build
    from repro_torch.launch.steps import build_prefill_step
    jcfg = CFGS[name]()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    batch = _inputs(jcfg, b=4, s=20, seed=5)
    j_comm.comm_destroy_all()
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep, _ = j_build(jcfg, mesh, shape=SH.InputShape("p", "prefill", 20,
                                                        4))
    with mesh:
        jl = np.asarray(jstep(jp, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    j_comm.comm_destroy_all()
    step, _ = build_prefill_step(tcfg, device="cpu")
    tl = step(params_from_reference(jax.tree.map(np.asarray, jp)),
              batch).numpy()
    assert tl.shape == jl.shape == (4, jcfg.vocab_padded)
    real = np.isfinite(jl)
    np.testing.assert_allclose(tl[real], jl[real], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------

def _fill_cross_cache(mod, p, cache, enc, cfg, ctx, setter):
    """Each decoder layer's ``xk``/``xv`` from the encoder output through
    that package's ``_xattn_kv``."""
    for i in range(cfg.n_layers):
        ap = jax.tree.map(lambda a: a[i], p["layers"]["xattn"]) \
            if mod is JT else TT._layer(p["layers"]["xattn"], i)
        k, v = mod._xattn_kv(ap, enc, cfg, ctx)
        cache = setter(cache, i, k, v)
    return cache


def test_whisper_decode_matches_forward_and_reference():
    """Teacher-forced decode of reduced whisper with the cross-attention
    cache filled layer by layer from the encoder output: each step's
    logits equal ``forward``'s row (1e-5) and the reference's decode's
    (1e-5)."""
    jcfg = CFGS["whisper"]()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    b, s = 2, 10
    batch = _inputs(jcfg, b, s, seed=1)
    toks, enc_np = batch["tokens"], batch["enc_embed"]
    tx, _ = TT.forward(tp, torch.from_numpy(toks), tcfg, t_ctx(),
                       enc_embed=torch.from_numpy(enc_np), remat=False)
    full = TT.lm_logits_local(tp, tx, tcfg, t_ctx()).numpy()
    jd = JT.DecodeConfig(cache_len_local=s, seq_shard=None)
    td = TT.DecodeConfig(cache_len_local=s)
    jenc = JT._encoder_forward(jp, jnp.asarray(enc_np), jcfg, j_ctx(),
                               remat=False)
    tenc = TT._encoder_forward(tp, torch.from_numpy(enc_np), tcfg, t_ctx(),
                               remat=False)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=1e-5)

    def j_set(c, i, k, v):
        return dict(c, xk=c["xk"].at[i].set(k), xv=c["xv"].at[i].set(v))

    def t_set(c, i, k, v):
        c["xk"][i], c["xv"][i] = k, v
        return c
    jc = _fill_cross_cache(JT, jp, JT.init_cache(jcfg, j_ctx(), jd, b), jenc,
                           jcfg, j_ctx(), j_set)
    tc = _fill_cross_cache(TT, tp, TT.init_cache(tcfg, t_ctx(), td, b), tenc,
                           tcfg, t_ctx(), t_set)
    assert tc["xk"].shape == (jcfg.n_layers, b, jcfg.encdec.n_frames,
                              jcfg.n_kv_heads, jcfg.head_dim_)
    j_decode = jax.jit(lambda p, c, tok, pos: JT.decode_step(
        p, c, tok, pos, jcfg, j_ctx(), jd))
    for t in range(s):
        jl, jc = j_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                t, tcfg, t_ctx(), td)
        real = np.isfinite(full[:, t])
        np.testing.assert_allclose(tl.numpy()[real], full[:, t][real],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   rtol=1e-5, atol=1e-5)
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


def _prompts(sizes, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in sizes]


def _serve(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    eng.run_until_drained()
    fin = eng.finished()
    eng.close()
    return fin


def _wave(mod, p, cfg, ctx, prompts):
    eng = mod.ServeEngine(p, cfg, ctx, mod.ServeConfig(slots=4,
                                                       cache_len=96))
    return _serve(eng, prompts), eng


def _paged(mod, p, cfg, ctx, prompts, **kw):
    return _serve(mod.PagedServeEngine(p, cfg, ctx, mod.PagedServeConfig(
        max_requests=4, cache_len=96, kv_block=16, max_tokens_in_flight=16,
        min_bucket=4, **kw)), prompts)


@pytest.mark.parametrize("name", ["internvl2", "whisper"])
def test_engines_match_jax_engines(name):
    """Greedy streams bit for bit: Whisper's wave engine; InternVL2's wave
    engine and paged engine (dense gather and kernel), each equal to the
    JAX engines' and to one another."""
    jcfg = CFGS[name]()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    prompts = _prompts([5, 3, 9, 2, 7, 12], jcfg.vocab)
    want = _wave(JE, jp, jcfg, j_ctx(), prompts)[0]
    assert _wave(TE, tp, tcfg, t_ctx(), prompts)[0] == want
    assert all(len(v) == 6 for v in want.values())
    if jcfg.family == "vlm":
        assert _paged(JE, jp, jcfg, j_ctx(), prompts) == want
        for impl in ("reference", "kernel"):
            assert _paged(TE, tp, tcfg, t_ctx(), prompts,
                          attn_impl=impl) == want, impl


def test_served_whisper_cross_attention_adds_zero():
    """A reference quirk, pinned: the wave engine never writes the
    cross-attention cache, so a served Whisper request attends to zero
    keys and values and its cross-attention adds exactly zero.  The
    streams do not move when every ``xattn`` weight is redrawn, in either
    package, and the port's ``xk``/``xv`` stay zero."""
    jcfg = CFGS["whisper"]()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    prompts = _prompts([4, 8, 3], jcfg.vocab, seed=9)
    rng = np.random.default_rng(6)
    jp2 = dict(jp, layers=dict(jp["layers"], xattn=jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jp["layers"]["xattn"])))
    tp2 = params_from_reference(jax.tree.map(np.asarray, jp2))
    fin, eng = _wave(TE, tp, tcfg, t_ctx(), prompts)
    assert not eng.cache["xk"].any() and not eng.cache["xv"].any()
    assert eng.cache["k"].any()
    assert _wave(TE, tp2, tcfg, t_ctx(), prompts)[0] == fin
    assert _wave(JE, jp, jcfg, j_ctx(), prompts)[0] == fin
    assert _wave(JE, jp2, jcfg, j_ctx(), prompts)[0] == fin


def test_paged_pool_refuses_encdec_as_reference():
    jcfg = CFGS["whisper"]()
    with pytest.raises(ValueError) as jerr:
        JT.init_paged_pool(jcfg, j_ctx(), JT.PagedConfig())
    with pytest.raises(ValueError) as terr:
        TT.init_paged_pool(t_config(jcfg), t_ctx(), TT.PagedConfig())
    assert str(terr.value) == str(jerr.value)
    assert "encdec stay on the wave engine" in str(terr.value)


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_every_config_trains_and_serves_reduced(arch):
    """Each of the ten configs at ``reduced()``: ``init_params``,
    ``forward`` and ``lm_loss`` finite with its frontend stub, and greedy
    streams served by the wave engine and, for the paged families, by the
    paged engine through the kernel's plain version, equal."""
    from repro_torch.data.pipeline import frontend_stub
    cfg = t_configs.get_config(arch).reduced()
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _inputs(cfg, s=8)
    batch.update(frontend_stub(cfg, 2, np.random.default_rng(1)) or {})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = TT.lm_loss(p, tb, cfg, t_ctx(), remat=False)
    assert torch.isfinite(loss) and float(loss) > 0
    prompts = _prompts([4, 6], cfg.vocab)
    fin, _ = _wave(TE, p, cfg, t_ctx(), prompts)
    assert sorted(fin) == [0, 1] and all(
        len(v) == 6 and all(0 <= t < cfg.vocab for t in v)
        for v in fin.values())
    if cfg.family in TT.PAGED_FAMILIES and cfg.moe is None:
        assert _paged(TE, p, cfg, t_ctx(), prompts,
                      attn_impl="kernel") == fin


def test_grad_buckets_match_reference():
    """Reduced whisper's bucketed gradient sync plan (``enc_layers`` and
    ``enc_norm`` sort between ``embed`` and ``final_norm``) equals the
    reference GradBucketer's, bucket by bucket."""
    from repro.train.bucketer import GradBucketer as JBucketer
    from repro_torch.train.bucketer import GradBucketer, tree_paths
    jcfg = CFGS["whisper"]()
    grads = TT.init_params(t_config(jcfg), torch.Generator().manual_seed(0),
                           "cpu")
    jgrads = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    plan = GradBucketer(grads, bucket_mb=0.25)
    jplan = JBucketer(jgrads, bucket_mb=0.25)

    def rows(b):
        return [(bk.tag, tuple((p.leaf, p.rows, p.nbytes)
                               for p in bk.pieces), bk.nbytes, bk.dtype)
                for bk in b.buckets]
    assert rows(plan) == rows(jplan)
    assert len(plan.buckets) > 2
    assert [k[0] for k, _ in tree_paths(grads)][:3] == \
        ["embed", "enc_layers", "enc_layers"]


# ---------------------------------------------------------------------------
# (data=2, model=2): 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("vlm_encdec")
    for sub in ("json", "port_ckpt", "ref_ckpt"):
        (d / sub).mkdir()
    pinned = _torch_ranks.pinned_profile(str(d / "pinned.json"), PROFILE,
                                         MESH[1], SHARES)
    comm = {"profile": PROFILE, "tuning_cache": pinned}
    runs = {"nccl": {"comm": dict(comm, backend="nccl")},
            "flexlink": {"comm": comm, "record": True, "ckpt": True}}
    prefill = {"comm": comm}
    for arch in ARCHS:
        prefill[arch] = _inputs(j_get_config(arch).reduced(), b=4, s=24,
                                seed=11)
    return {"dir": d, "comm": comm, "runs": runs, "prefill": prefill}


@pytest.fixture(scope="module")
def init_np():
    return {arch: jax.tree.map(np.asarray,
                               j_init(j_get_config(arch).reduced()))
            for arch in ARCHS}


def _ref_program(jcfg, mesh, comm):
    """The reference's train program on ``mesh``, as
    ``launch.steps.build_train_program`` builds it, but jitted WITHOUT
    buffer donation: on this mesh reduced whisper's donated step fails in
    XLA with the aliasing error of the reference's multi-node steps
    (ROADMAP queue 3), as tests/test_torch_moe.py's ep_a2a step does."""
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.launch import shapes as SH
    from repro.launch import steps as JS
    from repro.optim.adamw import AdamWConfig
    from repro.runtime.program import StepProgram
    from repro.train.train_step import make_train_step
    ctx = JS.make_ctx(mesh, j_comm.CommConfig(**comm))
    psp = JT.param_specs(jcfg)
    osp = JS.opt_state_specs(psp)
    bsp = JS._batch_specs(jcfg, SH.InputShape("t", "train", 32, 4), mesh)

    def builder():
        step = make_train_step(jcfg, ctx, AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=20), remat=True)
        return jax.jit(shard_map(step, mesh=mesh, in_specs=(psp, osp, bsp),
                                 out_specs=(psp, osp, P()),
                                 check_vma=False))
    return StepProgram(builder, ctx, name="flexlink"), ctx


def _ref_arch(arch, work, init):
    """The reference on the (2, 2) mesh for one arch: the flexlink run's
    losses, its recording after step 1 and its final global state (saved
    as a checkpoint for whisper), and the prefill logits (global [B, V])."""
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_prefill_step
    from repro.optim.adamw import init_state
    cfg = j_get_config(arch).reduced()
    out = {}
    j_comm.comm_destroy_all()
    mesh = make_mesh(MESH, ("data", "model"))
    program, ctx = _ref_program(cfg, mesh, work["comm"])
    params = jax.tree.map(jnp.asarray, init)
    opt_state = init_state(params)
    batches = make_batches(cfg, seq_len=32, batch_per_shard=4, seed=7)
    out["losses"] = []
    with mesh:
        for i in range(STEPS):
            params, opt_state, m = program.step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            out["losses"].append(float(m["loss"]))
            if i == 0:
                out["recording"] = _torch_ranks.recording(
                    ctx, "flexlink",
                    str(work["dir"] / "json" / f"ref-{arch}.json"))
    program.close()
    if arch == "whisper-medium":
        JCkpt(str(work["dir"] / "ref_ckpt")).save(STEPS, params, opt_state)
        out["saved"] = {k: _torch_ranks.flat_leaves(jax.tree.map(np.asarray,
                                                                 t))
                        for k, t in (("params", params),
                                     ("mu", opt_state.mu),
                                     ("nu", opt_state.nu))}
    j_comm.comm_destroy_all()
    batch = work["prefill"][arch]
    step, _ = build_prefill_step(
        cfg, mesh, comm=j_comm.CommConfig(**work["comm"]),
        shape=SH.InputShape("p", "prefill", batch["tokens"].shape[1],
                            batch["tokens"].shape[0]))
    with mesh:
        out["prefill"] = np.asarray(step(jax.tree.map(jnp.asarray, init),
                                         {k: jnp.asarray(v)
                                          for k, v in batch.items()}))
    j_comm.comm_destroy_all()
    return out


@pytest.fixture(scope="module")
def reference(work, init_np):
    return {arch: _ref_arch(arch, work, init_np[arch]) for arch in ARCHS}


@pytest.fixture(scope="module")
def port(work, init_np, reference):
    d = work["dir"]
    return run_ranks(_torch_ranks.vlm_encdec, 4, backend="gloo",
                     device="cpu", timeout_s=600,
                     args=(init_np, work["runs"], STEPS, work["prefill"],
                           {"whisper-medium": str(d / "port_ckpt")},
                           {"whisper-medium": str(d / "ref_ckpt")},
                           str(d / "json")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ["nccl", "flexlink"])
def test_tp_losses_match_reference(port, reference, arch, run):
    """3 steps on (data=2, model=2) within 5e-3 of the reference's, equal
    on every rank, falling."""
    got = port[0][arch][run]["losses"]
    want = reference[arch]["losses"]
    assert len(got) == STEPS and np.all(np.isfinite(got))
    assert np.max(np.abs(np.array(got) - np.array(want))) < TOL, (got, want)
    assert all(r[arch][run]["losses"] == got for r in port)
    assert got[-1] < got[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recording_matches_reference(port, reference, arch):
    """After one step, both axes' recorded calls, plan signatures and
    saved TuningProfile equal the reference's: on the model axis the
    embedding combine and the first block of each scan (Whisper: 2
    encoder combines, then 3 decoder ones, cross-attention's ``wo``
    included), one data-axis all-reduce a gradient leaf."""
    got = port[0][arch]["flexlink"]["recording"]
    want = reference[arch]["recording"]
    for axis in ("model", "data"):
        assert got[axis]["calls"] == want[axis]["calls"], axis
        assert got[axis]["signature"] == want[axis]["signature"], axis
    n_model = {"whisper-medium": 1 + 2 + 3, "internvl2-76b": 1 + 2}[arch]
    assert [c[0] for c in got["model"]["calls"]] == ["all_reduce"] * n_model
    units = dict(dict(got["model"]["signature"][0][2])["chunk_units"])
    assert set(units) == {"primary", "staged", "ortho"}, units
    assert got["profile_json"] == want["profile_json"]
    assert all(r[arch]["flexlink"]["recording"]["model"] == got["model"]
               for r in port)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_matches_reference_shards(port, reference, arch):
    """Each rank's prefill logits [B / 2, V / 2] equal the reference's
    shard at its mesh position (rank = data * 2 + model)."""
    want = reference[arch]["prefill"]
    b, v = want.shape[0] // 2, want.shape[1] // 2
    for r, got in enumerate(port):
        d, m = divmod(r, 2)
        w = want[d * b:(d + 1) * b, m * v:(m + 1) * v]
        g = got[arch]["prefill"]
        real = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), real)
        np.testing.assert_allclose(g[real], w[real], atol=1e-5, rtol=1e-5)


def test_whisper_checkpoints_cross_packages(port, reference, init_np, work):
    """The port's (2, 2) Whisper checkpoint (encoder leaves, cross-
    attention subtree) restores in the reference as the global tree the
    ranks' shards gather into; every rank restores the reference's
    checkpoint as its shards of the tree the reference saved."""
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.configs import get_config
    from repro_torch.convert import gather_params
    arch = "whisper-medium"
    specs = TT.param_specs(get_config(arch).reduced())
    tmpl = init_np[arch]
    jp, jopt, meta = JCkpt(str(work["dir"] / "port_ckpt")).restore(
        tmpl, j_init_state(tmpl))
    assert meta["step"] == STEPS
    restored = {"params": jp, "mu": jopt.mu, "nu": jopt.nu}
    for tree in ("params", "mu", "nu"):
        local = [_unflat(port[m][arch]["state"][tree]) for m in range(2)]
        want = _torch_ranks.flat_leaves(gather_params(local, specs))
        got = _torch_ranks.flat_leaves(jax.tree.map(np.asarray,
                                                    restored[tree]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "layers/xattn/wq" in want and "enc_layers/attn/wk" in want
    saved = reference[arch]["saved"]
    for r, res in enumerate(port):
        got = res[arch]["restored"]
        assert got["step"] == STEPS
        for tree in ("params", "mu", "nu"):
            want = _torch_ranks.flat_leaves(shard_params(
                _unflat(saved[tree]), specs, r % 2, 2))
            for k, w in want.items():
                np.testing.assert_array_equal(got[tree][k], w,
                                              err_msg=f"{r} {tree} {k}")


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_train_launcher_whisper_smoke_learns():
    """``--arch whisper-medium --smoke`` on 4 gloo CPU ranks at
    (data=2, model=2): the loss falls."""
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "whisper-medium", "--smoke", "--device", "cpu", "--dist", "gloo",
         "--mesh-shape", "2,2", "--steps", "6"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("final loss:")][0]
    final, first = (float(v) for v in
                    line.removeprefix("final loss: ").replace(
                        "(from ", "").rstrip(")").split())
    assert np.isfinite(final) and final < first, line
