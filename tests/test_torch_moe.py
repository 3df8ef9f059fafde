"""The port's MoE family against the JAX reference.

The parameters are the reference's ``init_params`` trees (float32)
carried across by ``convert.py``.  On one device: ``route``,
``dispatch_indices``, ``gather_to_buffers`` and ``combine_from_buffers``
(integer outputs and buffers bit for bit, ties included, and a
hypothesis case over (t, e, cap, seed) as tests/test_models.py:193),
``moe_block`` for both impls (1e-5), forward logits (1e-5) and 3 train
steps (losses within 5e-3) of reduced mixtral-8x7b, reduced
kimi-k2-1t-a32b and the reference's ``FAMILY_CFGS["moe"]`` (a dense
prefix layer), decode against forward at capacity factor 8
(tests/test_models.py:82-110) and against the reference's decode, the
paged decode step, and greedy streams of both engines equal to the JAX
engines'.

On a (data=2, model=2) mesh, 4 gloo ranks spawned once (rank side in
``_torch_ranks.moe_ep``) against the reference's ``shard_map`` on the
conftest's CPU devices, with reduced kimi-k2 (ep_a2a: 4 experts over
the data axis, their FFN hidden dim over the model axis): the
``ep_all_to_all`` forward and backward on small-integer payloads bit for
bit; 3 train steps whose losses match the reference's, flexlink equal to
nccl, with the data axis's all_to_all slot pinned to primary + staged so
the staged ring runs forward, in the recompute and in the backward; the
calls recorded, the collectives executed a step and the plan signatures;
and a checkpoint of the data- and model-sharded expert leaves that every
rank restores and the reference reads as the global tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from _hyp import given, settings, st
from repro.configs import get_config as j_get_config
from repro.core import communicator as j_comm
from repro.models import init_params as j_init_params
from repro.models import moe as JM
from repro.models import single_device_ctx as j_ctx
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch.convert import params_from_reference
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import config as TC
from repro_torch.models import moe as TM
from repro_torch.models import single_device_ctx as t_ctx
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

TOL = 5e-3          # per-step losses, as tests/test_torch_train.py
STEPS = 3
PROFILE = "h800"
SHARES = {"nvlink": 50, "pcie": 25, "rdma": 25}


def t_config(jcfg):
    """The port's ArchConfig with the same data as a reference one."""
    d = dataclasses.asdict(jcfg)
    for key, cls in (("moe", TC.MoEConfig), ("ssm", TC.SSMConfig),
                     ("hybrid", TC.HybridConfig)):
        if d.get(key) is not None:
            d[key] = cls(**d[key])
    return TC.ArchConfig(**d)


def j_init(jcfg):
    """The reference's ``init_params`` tree, jitted (the same values as
    eager, a fraction of the time)."""
    return jax.jit(j_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)


def _family_moe():
    from test_models import FAMILY_CFGS
    return FAMILY_CFGS["moe"]


CFGS = {"mixtral": lambda: j_get_config("mixtral-8x7b").reduced(),
        "kimi": lambda: j_get_config("kimi-k2-1t-a32b").reduced(),
        "family": _family_moe}


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    jcfg = CFGS[request.param]()
    jp = j_init(jcfg)
    return jcfg, t_config(jcfg), jp, params_from_reference(
        jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,e,k,ties", [(24, 4, 2, False), (64, 8, 2, True),
                                        (33, 16, 8, True)])
def test_route_matches_reference(t, e, k, ties):
    """Expert indices equal (ties: two router columns equal, the lower
    index first as lax.top_k), weights and the aux loss within 1e-6."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, 16)).astype(np.float32)
    w = (rng.standard_normal((16, e)) * 0.5).astype(np.float32)
    if ties:
        w[:, 2] = w[:, 1]
    moe = TC.MoEConfig(n_experts=e, top_k=k)
    jw, jidx, jaux = JM.route(jnp.asarray(x), jnp.asarray(w), moe)
    tw, tidx, taux = TM.route(torch.from_numpy(x), torch.from_numpy(w), moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(float(taux) - float(jaux)) < 1e-6
    if ties:
        both = (tidx.numpy() == 1).any(-1) & (tidx.numpy() == 2).any(-1)
        assert np.any(both)


def _dispatch_pair(experts, e, cap):
    js, jk = JM.dispatch_indices(jnp.asarray(experts), e, cap)
    ts, tk = TM.dispatch_indices(torch.from_numpy(experts), e, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    return ts, tk


@pytest.mark.parametrize("t,e,cap", [(16, 4, 8), (64, 8, 3), (7, 2, 1)])
def test_dispatch_gather_combine_bit_for_bit(t, e, cap):
    """Slots and keep flags equal; the expert buffers and the combined
    rows equal bit for bit (each kept slot is written once, dropped
    tokens add exact zeros)."""
    rng = np.random.default_rng(t * e)
    experts = rng.integers(0, e, t).astype(np.int32)
    x = rng.standard_normal((t, 8)).astype(np.float32)
    wts = rng.random(t).astype(np.float32)
    ts, tk = _dispatch_pair(experts, e, cap)
    js, jk = JM.dispatch_indices(jnp.asarray(experts), e, cap)
    jbuf = JM.gather_to_buffers(jnp.asarray(x), js, jk, e, cap)
    tbuf = TM.gather_to_buffers(torch.from_numpy(x), ts, tk, e, cap)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    jout = JM.combine_from_buffers(jbuf, js, jk, jnp.asarray(wts))
    tout = TM.combine_from_buffers(tbuf, ts, tk, torch.from_numpy(wts))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert TM.capacity_of(t, TC.MoEConfig(n_experts=e, top_k=2)) == \
        JM.capacity_of(t, TC.MoEConfig(n_experts=e, top_k=2))


@given(t=st.sampled_from([4, 9, 33, 64]), e=st.sampled_from([2, 4, 8]),
       cap=st.integers(1, 16), seed=st.integers(0, 100))
@settings(max_examples=30, deadline=None)
def test_property_dispatch_matches_reference(t, e, cap, seed):
    """tests/test_models.py:193's cases through both packages: equal
    slots and keep flags, and the port's within capacity (t from four
    lengths in its range, so the reference's eager ops compile once a
    shape)."""
    experts = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (t,),
                                            0, e)).astype(np.int64)
    slots, keep = _dispatch_pair(experts, e, cap)
    kept = slots.numpy()[keep.numpy()]
    assert len(set(kept.tolist())) == len(kept)
    es = experts[keep.numpy()]
    assert ((kept >= es * cap) & (kept < (es + 1) * cap)).all()


@pytest.mark.parametrize("impl", ["tp", "ep_a2a"])
def test_moe_block_matches_reference(impl):
    jcfg = dataclasses.replace(
        j_get_config("mixtral-8x7b").reduced(),
        moe=dataclasses.replace(j_get_config("mixtral-8x7b").reduced().moe,
                                impl=impl))
    tcfg = t_config(jcfg)
    jp = JM.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(5).standard_normal((2, 24, 256)).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, x: JM.moe_block(p, x, jcfg, j_ctx()))(
        jp, jnp.asarray(x))
    ty, taux = TM.moe_block(tp, torch.from_numpy(x), tcfg, t_ctx())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(taux) - float(jaux)) < 1e-5


# ---------------------------------------------------------------------------
# the model on one device
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def test_forward_logits_match_reference(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg)
    jx, jaux = JT.forward(jp, jnp.asarray(toks), jcfg, j_ctx(), remat=False)
    jl = np.asarray(JT.lm_logits_local(jp, jx, jcfg, j_ctx()))
    tx, taux = TT.forward(tp, torch.from_numpy(toks), tcfg, t_ctx(),
                          remat=False)
    tl = TT.lm_logits_local(tp, tx, tcfg, t_ctx()).numpy()
    real = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), real)
    np.testing.assert_allclose(tl[real], jl[real], atol=1e-5, rtol=1e-5)
    assert abs(float(taux) - float(jaux)) < 1e-5 and float(taux) > 0


@pytest.mark.parametrize("name", ["mixtral", "family"])
def test_three_steps_match_reference(name):
    """``build_train_step`` on one device, 3 AdamW steps, against the
    reference's on a (1, 1) mesh; the loss carries the router aux
    (kimi-k2's 3 steps run on the (2, 2) mesh below)."""
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


def test_decode_matches_forward_and_reference(model):
    """Teacher-forced decode at capacity factor 8 (no token dropped)
    against the port's own forward (2e-3, as the reference's test) and
    the reference's decode step by step (1e-5)."""
    jcfg, _, _, _ = model
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    b, s = 2, 12
    toks = _tokens(jcfg, b, s, seed=1)
    tx, _ = TT.forward(tp, torch.from_numpy(toks), tcfg, t_ctx(),
                       remat=False)
    full = TT.lm_logits_local(tp, tx, tcfg, t_ctx()).numpy()
    jd = JT.DecodeConfig(cache_len_local=s, seq_shard=None)
    td = TT.DecodeConfig(cache_len_local=s)
    jc = JT.init_cache(jcfg, j_ctx(), jd, b)
    tc = TT.init_cache(tcfg, t_ctx(), td, b)
    j_decode = jax.jit(lambda p, c, tok, pos: JT.decode_step(
        p, c, tok, pos, jcfg, j_ctx(), jd))
    for t in range(s):
        jl, jc = j_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                t, tcfg, t_ctx(), td)
        real = np.isfinite(full[:, t])
        np.testing.assert_allclose(tl.numpy()[real], full[:, t][real],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


# request 0 in blocks (4, 7, 1), request 1 in (2, 9, 5); each tick is
# (tokens' row_req, positions, sample_rows); -1 rows are bucket padding,
# routed all the same (they take expert capacity)
TICKS = [
    ([0, 0, 0, 0, 0, 1, 1, 1], [0, 1, 2, 3, 4, 0, 1, 2], [4, 7]),
    ([0, 1, -1, -1], [5, 3, 0, 0], [0, 1]),
    ([1, 0, 1, 1, -1, -1, -1, -1], [4, 6, 5, 6, 0, 0, 0, 0], [1, 3]),
]


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_paged_decode_step_matches_reference(model, impl):
    """The packed step's logits and the pool (the dense prefix at layer
    0) over several ticks, within 1e-4."""
    jcfg, tcfg, jp, tp = model
    tables = np.array([[4, 7, 1], [2, 9, 5]], np.int32)
    jpc = JT.PagedConfig(block_size=8, n_blocks=10, max_blocks_per_req=3)
    pcfg = TT.PagedConfig(block_size=8, n_blocks=10, max_blocks_per_req=3,
                          attn_impl=impl)
    jpool = JT.init_paged_pool(jcfg, j_ctx(), jpc)
    tpool = TT.init_paged_pool(tcfg, t_ctx(), pcfg)
    j_step = jax.jit(lambda p, pool, *a: JT.paged_decode_step(
        p, pool, *a, jcfg, j_ctx(), jpc))
    rng = np.random.default_rng(8)
    for rows, pos, sample in TICKS:
        toks = rng.integers(1, jcfg.vocab, len(rows)).astype(np.int32)
        args = [toks, np.array(pos, np.int32), np.array(rows, np.int32),
                tables, np.array(sample, np.int32)]
        jl, jpool = j_step(jp, jpool, *map(jnp.asarray, args))
        tl, tpool = TT.paged_decode_step(tp, tpool,
                                         *map(torch.from_numpy, args), tcfg,
                                         t_ctx(), pcfg)
        real = np.isfinite(np.asarray(jl))
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=1e-4, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=1e-4)


def _prompts(sizes, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in sizes]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=6)
    eng.run_until_drained()
    fin = eng.finished()
    eng.close()
    return fin


@pytest.mark.parametrize("name", ["mixtral", "kimi"])
def test_engines_match_jax_engines(name):
    """Greedy streams of the wave engine and of the paged engine (dense
    gather and kernel) equal the JAX engines'."""
    jcfg = CFGS[name]()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    prompts = _prompts([5, 3, 9, 2, 7, 12], jcfg.vocab)

    def wave(mod, p, cfg, ctx):
        return _serve(mod.ServeEngine(p, cfg, ctx, mod.ServeConfig(
            slots=4, cache_len=96)), prompts)

    def paged(mod, p, cfg, ctx, **kw):
        return _serve(mod.PagedServeEngine(p, cfg, ctx, mod.PagedServeConfig(
            max_requests=4, cache_len=96, kv_block=16,
            max_tokens_in_flight=16, min_bucket=4, **kw)), prompts)

    assert wave(TE, tp, tcfg, t_ctx()) == wave(JE, jp, jcfg, j_ctx())
    want = paged(JE, jp, jcfg, j_ctx())
    for impl in ("reference", "kernel"):
        got = paged(TE, tp, tcfg, t_ctx(), attn_impl=impl)
        assert got == want, impl
    assert all(len(v) == 6 for v in want.values())


class _SyncCtx:
    """A ctx stand-in that records which reduce each payload takes."""

    def __init__(self):
        self.calls = []

    def grad_all_reduce(self, g):
        self.calls.append(("data", g.numel()))
        return g * 2

    def expert_grad_reduce(self, g):
        self.calls.append(("expert", g.numel()))
        return g

    def issue(self, tag):
        import contextlib
        return contextlib.nullcontext()


@pytest.mark.parametrize("bucket_mb", [0.0, 0.25])
def test_expert_grads_skip_the_data_all_reduce(bucket_mb):
    """On a real ep_a2a tree (reduced kimi-k2) the sync sends the expert
    leaves through ``ctx.expert_grad_reduce`` (the backward all_to_all
    summed them) and every other leaf through the data all-reduce,
    monolithic and bucketed; the bucketed plan, expert buckets marked,
    equals the reference's GradBucketer's."""
    from repro.train.bucketer import GradBucketer as JBucketer
    from repro_torch.train.bucketer import (GradBucketer, is_expert_param,
                                            tree_paths)
    from repro_torch.train.train_step import sync_grads
    jcfg = j_get_config("kimi-k2-1t-a32b").reduced()
    tcfg = t_config(jcfg)
    grads = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ctx = _SyncCtx()
    out = sync_grads(grads, tcfg, ctx, bucket_mb=bucket_mb)
    for path, g in tree_paths(out):
        want = dict(tree_paths(grads))[path]
        scale = 1 if is_expert_param(path) else 2
        assert torch.equal(g, want * scale), path
    n_exp = sum(g.numel() for path, g in tree_paths(grads)
                if is_expert_param(path))
    assert sum(n for kind, n in ctx.calls if kind == "expert") == n_exp > 0
    if bucket_mb:
        jgrads = jax.eval_shape(lambda: j_init_params(
            jax.random.PRNGKey(0), jcfg))
        plan = GradBucketer(grads, bucket_mb=bucket_mb, ep=True)
        jplan = JBucketer(jgrads, bucket_mb=bucket_mb, ep=True)

        def rows(b):
            return [(bk.tag, tuple((p.leaf, p.rows, p.nbytes)
                                   for p in bk.pieces), bk.nbytes, bk.dtype,
                     bk.expert) for bk in b.buckets]
        assert rows(plan) == rows(jplan)
        assert any(bk.expert for bk in plan.buckets)
        assert len(ctx.calls) == len(plan.buckets)


# ---------------------------------------------------------------------------
# ep_a2a on a (data=2, model=2) mesh
# ---------------------------------------------------------------------------

EP_MESH = (2, 2)


@pytest.fixture(scope="module")
def ep_work(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    for sub in ("ckpt", "json"):
        (d / sub).mkdir()
    pinned = str(d / "pinned.json")
    _torch_ranks.pinned_profile(pinned, PROFILE, 2, SHARES,
                                ops=("all_to_all",))
    _torch_ranks.pinned_profile(pinned, PROFILE, 2, SHARES)
    comm = {"profile": PROFILE, "tuning_cache": pinned}
    runs = {"nccl": {"comm": dict(comm, backend="nccl")},
            "flexlink": {"comm": comm, "ckpt": True, "record": True}}
    x = np.random.default_rng(11).integers(0, 8, (4 * 16, 6)).astype(
        np.float32)
    return {"dir": d, "comm": comm, "runs": runs,
            "a2a": {"x": x, "comm": comm}}


@pytest.fixture(scope="module")
def ep_init():
    jcfg = j_get_config("kimi-k2-1t-a32b").reduced()
    return jcfg, jax.tree.map(np.asarray,
                              j_init(jcfg))


def _ref_program(jcfg, mesh, comm):
    """The reference's train program on ``mesh``, as
    ``launch.steps.build_train_program`` builds it (ctx, the param specs
    with the ctx's ep span as the expert axis, ``shard_map``) but jitted
    WITHOUT buffer donation: with ep_a2a experts sharded over data, the
    donated step fails in XLA with the aliasing error of the reference's
    multi-node steps (ROADMAP queue 3)."""
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.launch import shapes as SH
    from repro.launch import steps as JS
    from repro.optim.adamw import AdamWConfig
    from repro.runtime.program import StepProgram
    from repro.train.train_step import make_train_step
    ctx = JS.make_ctx(mesh, j_comm.CommConfig(**comm))
    psp = JT.param_specs(jcfg, data_axis=ctx.ep_spec_axis() or "data")
    osp = JS.opt_state_specs(psp)
    bsp = JS._batch_specs(jcfg, SH.InputShape("t", "train", 32, 4), mesh)

    def builder():
        step = make_train_step(jcfg, ctx, AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=20), remat=True)
        return jax.jit(shard_map(step, mesh=mesh, in_specs=(psp, osp, bsp),
                                 out_specs=(psp, osp, P()),
                                 check_vma=False))
    return StepProgram(builder, ctx, name="flexlink"), ctx


@pytest.fixture(scope="module")
def ep_reference(ep_work, ep_init):
    """The reference on the (2, 2) mesh: the ep_all_to_all forward and
    its gradient, and the flexlink run's losses and recording."""
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.data.pipeline import make_batches
    from repro.launch.mesh import make_mesh
    from repro.models.tp import ParallelCtx
    from repro.optim.adamw import init_state
    from jax.sharding import Mesh
    jcfg, init_np = ep_init
    j_comm.comm_destroy_all()
    ctx = ParallelCtx(tp_axis="model", dp_axis="data", tp_size=2, dp_size=2,
                      comm_config=j_comm.CommConfig(**ep_work["comm"]))
    spec = P(("data", "model"))

    def shard(xs):
        y = ctx.ep_all_to_all(xs, split_axis=0, concat_axis=0)
        w = (lax.axis_index("data") * 2 + lax.axis_index("model")
             + 1).astype(jnp.float32)
        return y, jnp.sum(y * y * w)[None]

    f = jax.jit(shard_map(
        shard, mesh=Mesh(np.asarray(jax.devices()[:4]).reshape(EP_MESH),
                         ("data", "model")),
        in_specs=(spec,), out_specs=(spec, spec), check_vma=False))
    xj = jnp.asarray(ep_work["a2a"]["x"])
    out = {"a2a": (np.asarray(f(xj)[0]), np.asarray(
        jax.grad(lambda xs: jnp.sum(f(xs)[1]))(xj)))}
    j_comm.comm_destroy_all()
    run = ep_work["runs"]["flexlink"]
    mesh = make_mesh(EP_MESH, ("data", "model"))
    program, ctx = _ref_program(jcfg, mesh, run["comm"])
    params = jax.tree.map(jnp.asarray, init_np)
    opt_state = init_state(params)
    batches = make_batches(jcfg, seq_len=32, batch_per_shard=4, seed=7)
    out["losses"] = []
    with mesh:
        for i in range(STEPS):
            params, opt_state, m = program.step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            out["losses"].append(float(m["loss"]))
            if i == 0:
                out["recording"] = _torch_ranks.recording(
                    ctx, "flexlink", str(ep_work["dir"] / "json" / "ref.json"))
    program.close()
    j_comm.comm_destroy_all()
    return out


@pytest.fixture(scope="module")
def ep_port(ep_work, ep_init, ep_reference):
    _, init_np = ep_init
    d = ep_work["dir"]
    return run_ranks(_torch_ranks.moe_ep, 4, backend="gloo", device="cpu",
                     timeout_s=300,
                     args=(init_np, ep_work["runs"], STEPS, ep_work["a2a"],
                           str(d / "ckpt"), str(d / "json")))


def test_ep_all_to_all_matches_reference(ep_port, ep_reference):
    """Forward rows and gradients of the data-axis all_to_all bit for bit
    on every rank (the backward is the same plan's all_to_all)."""
    y, g = ep_reference["a2a"]
    for r, (yr, gr) in enumerate(zip(np.split(y, 4), np.split(g, 4))):
        np.testing.assert_array_equal(ep_port[r]["a2a"]["y"], yr)
        np.testing.assert_array_equal(ep_port[r]["a2a"]["grad"], gr)
    assert np.any(g != 0)


def test_ep_losses_match_reference_and_nccl(ep_port, ep_reference):
    """The flexlink run's losses within 5e-3 of the reference's and of
    the nccl backend's; equal on the ranks of one model index (each
    model rank's aux loss reads its own replicated copies, which drift
    apart as the reference's do)."""
    got = ep_port[0]["flexlink"]["losses"]
    want = ep_reference["losses"]
    assert len(got) == STEPS and np.all(np.isfinite(got))
    assert np.max(np.abs(np.array(got) - np.array(want))) < TOL, (got, want)
    nccl = ep_port[0]["nccl"]["losses"]
    assert np.max(np.abs(np.array(got) - np.array(nccl))) < TOL
    for name in ("nccl", "flexlink"):
        assert ep_port[2][name]["losses"] == ep_port[0][name]["losses"]
        assert ep_port[3][name]["losses"] == ep_port[1][name]["losses"]
    assert got[-1] < got[0]


def test_ep_recording_and_signature_match_reference(ep_port, ep_reference):
    """After one step the data axis recorded the MoE layer's dispatch and
    return all_to_alls (once per trace) and one all-reduce per
    replicated leaf; both axes' calls, plan signatures and saved
    TuningProfile equal the reference's; the all_to_all plan runs primary
    and staged."""
    got = ep_port[0]["flexlink"]["recording"]
    want = ep_reference["recording"]
    for axis in ("model", "data"):
        assert got[axis]["calls"] == want[axis]["calls"], axis
        assert got[axis]["signature"] == want[axis]["signature"], axis
    assert [c[0] for c in got["data"]["calls"]].count("all_to_all") == 2
    a2a = [p for op, _, p in got["data"]["signature"] if op == "all_to_all"]
    assert set(dict(dict(a2a[0])["chunk_units"])) == {"primary", "staged"}
    assert got["profile_json"] == want["profile_json"]


def test_ep_all_to_alls_run_forward_recompute_and_backward(ep_port):
    """A step executes the MoE layer's dispatch and return all_to_alls
    in the forward, again in its checkpoint recompute, and their two
    transposes in the backward."""
    for r in ep_port:
        got = {ph: n for (axis, op, ph), n in r["flexlink"]["executed"].items()
               if op == "all_to_all"}
        assert got == {"forward": 2, "recompute": 2, "backward": 2}, got


def test_ep_checkpoint_round_trips_and_reference_reads_it(ep_port, ep_work,
                                                          ep_init):
    """Every rank restores its own data- and model-sharded shards bit for
    bit, and the reference restores the file as the global tree the
    ranks' shards gather into (experts over data after model)."""
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    from repro.optim.adamw import init_state as j_init_state
    from repro_torch.configs import get_config
    from repro_torch.convert import gather_params
    from repro_torch.models.transformer import param_specs
    jcfg, init_np = ep_init
    specs = param_specs(get_config("kimi-k2-1t-a32b").reduced())
    axes = _torch_ranks.flat_leaves(_spec_tree(specs))
    for r, got in enumerate(ep_port):
        assert got["ckpt"]["step"] == STEPS
        # the file holds an expert leaf's every shard, the other
        # model-sharded leaves from data row 0 and the replicated ones
        # from rank (0, 0): each rank's copies drift apart (its own
        # gradient norm clips its update), as the reference's do
        for tree, leaves in got["ckpt"]["restored"].items():
            for k, v in leaves.items():
                src = {2: r, 1: r % 2, 0: 0}[int(axes[k])]
                want = ep_port[src]["ckpt"]["state"][tree][k]
                np.testing.assert_array_equal(v, want, err_msg=f"{r} {k}")
    jp, jopt, meta = JCkpt(str(ep_work["dir"] / "ckpt")).restore(
        init_np, j_init_state(init_np))
    assert meta["step"] == STEPS
    restored = {"params": jp, "mu": jopt.mu, "nu": jopt.nu}
    for tree in ("params", "mu", "nu"):
        local = [_unflat(r["ckpt"]["state"][tree]) for r in ep_port]
        rows = [gather_params(local[2 * d:2 * d + 2], specs, "model")
                for d in range(2)]
        want = _torch_ranks.flat_leaves(gather_params(rows, specs, "data"))
        got = _torch_ranks.flat_leaves(jax.tree.map(np.asarray,
                                                    restored[tree]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["layers/moe/experts/w_gate"].shape == (1, 4, 256, 512)


def _spec_tree(specs):
    """2 for a leaf sharded over the data axis (ep_a2a experts), 1 for
    one sharded over the model axis only, 0 for a replicated one."""
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    return np.float32(2 if "data" in specs else "model" in specs)


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_train_launcher_ep_smoke_learns(tmp_path, ep_init):
    """``--arch kimi-k2-1t-a32b --smoke --mesh-shape 2,2`` on 4 gloo CPU
    ranks: the loss falls, and the final checkpoint (every rank saves,
    the experts gathered over both axes) restores in the reference with
    its global shapes."""
    import os
    import subprocess
    import sys
    from repro.checkpoint.checkpointer import Checkpointer as JCkpt
    _, init_np = ep_init
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "kimi-k2-1t-a32b", "--smoke", "--device", "cpu", "--dist", "gloo",
         "--mesh-shape", "2,2", "--steps", "6", "--ckpt-dir",
         str(tmp_path)], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("final loss:")][0]
    final, first = (float(v) for v in
                    line.removeprefix("final loss: ").replace(
                        "(from ", "").rstrip(")").split())
    assert np.isfinite(final) and final < first, line
    params, _, meta = JCkpt(str(tmp_path)).restore(init_np)
    assert meta["step"] == 6
    assert params["layers"]["moe"]["experts"]["w_up"].shape == \
        init_np["layers"]["moe"]["experts"]["w_up"].shape
    assert all(np.all(np.isfinite(np.asarray(v)))
               for v in jax.tree.leaves(params))
