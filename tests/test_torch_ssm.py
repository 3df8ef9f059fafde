"""The port's SSM (Mamba2) and hybrid (Zamba2) families against the JAX
reference.

The parameters are the reference's ``init_params`` trees (float32)
carried across by ``convert.py``.  Checked on one device: the chunked
SSD scan at a length that is not a multiple of the chunk (output and
final state within 1e-4, as tests/test_models.py:162-183), one Mamba2
block's prefill and O(1) decode step (1e-5), forward logits (1e-5) of
reduced mamba2-1.3b, reduced zamba2-1.2b and the reference's
``FAMILY_CFGS["hybrid"]`` (3 layers, a shared attention block after
every 2: one group and a remainder layer), 3 train steps (losses
within 5e-3), decode step by step against the port's forward and the
reference's decode, and the wave engine's greedy streams equal to the
JAX engine's (the hold tokens of other slots' prefill advance an SSM
state in both).  On a (data=2) mesh of 2 gloo ranks: 3 steps of reduced
mamba2-1.3b, flexlink and nccl, against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import get_config as j_get_config
from repro.core import communicator as j_comm
from repro.models import single_device_ctx as j_ctx
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch.convert import params_from_reference
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import single_device_ctx as t_ctx
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from test_torch_moe import j_init, t_config

TOL = 5e-3
STEPS = 3


def _family_hybrid():
    from test_models import FAMILY_CFGS
    return FAMILY_CFGS["hybrid"]


CFGS = {"mamba2": lambda: j_get_config("mamba2-1.3b").reduced(),
        "zamba2": lambda: j_get_config("zamba2-1.2b").reduced(),
        "hybrid": _family_hybrid}


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    jcfg = CFGS[request.param]()
    jp = j_init(jcfg)
    return jcfg, t_config(jcfg), jp, params_from_reference(
        jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------------------
# the SSD scan and one block
# ---------------------------------------------------------------------------

def test_ssd_chunked_matches_reference():
    b, s, h, hd, ds = 2, 37, 3, 8, 5
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    bt = (rng.standard_normal((b, s, ds)) * 0.5).astype(np.float32)
    ct = (rng.standard_normal((b, s, ds)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.2).astype(np.float32)
    jy, js = JS._ssd_chunked(*map(jnp.asarray, (xh, bt, ct, dt, a)), chunk=8)
    ty, ts = TS._ssd_chunked(*map(torch.from_numpy, (xh, bt, ct, dt, a)),
                             chunk=8)
    assert ty.shape == (b, s, h, hd) and ts.shape == (b, h, ds, hd)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)


def test_ssd_gradient_matches_reference_past_exp_range():
    """A chunk whose summed decay passes float32's exp range (about 88):
    the masked exponent keeps the port's gradient finite (exp of the raw
    one under the mask gives torch 0 * inf = NaN there) and equal to the
    reference's, and the forward too."""
    b, s, h, hd, ds = 1, 64, 2, 4, 3
    rng = np.random.default_rng(1)
    xh, bt, ct = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, s, h, hd), (b, s, ds), (b, s, ds)))
    dt = np.full((b, s, h), 2.0, np.float32)       # 63 steps x 2 = 126
    a = -np.ones(h, np.float32)
    jy, _ = JS._ssd_chunked(*map(jnp.asarray, (xh, bt, ct, dt, a)),
                            chunk=64)
    args = [torch.from_numpy(v) for v in (xh, bt, ct, dt, a)]
    args[0].requires_grad_(True)
    ty, _ = TS._ssd_chunked(*args, chunk=64)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    ty.sum().backward()
    jg = jax.grad(lambda x: JS._ssd_chunked(
        x, *map(jnp.asarray, (bt, ct, dt, a)), chunk=64)[0].sum())(
            jnp.asarray(xh))
    assert torch.isfinite(args[0].grad).all()
    np.testing.assert_allclose(args[0].grad.numpy(), np.asarray(jg),
                               rtol=1e-4, atol=1e-4)


def test_ssm_block_prefill_and_decode_match_reference():
    """Prefill (the chunked scan, its final state and conv tail) and two
    O(1) decode steps from that state, within 1e-5."""
    jcfg = j_get_config("mamba2-1.3b").reduced()
    tcfg = t_config(jcfg)
    jp = JS.init_ssm(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 45, 256)).astype(np.float32)
    block = jax.jit(lambda p, x, state=None: JS.ssm_block(
        p, x, jcfg, j_ctx(), state=state))
    jy, jst = block(jp, jnp.asarray(x))
    ty, tst = TS.ssm_block(tp, torch.from_numpy(x), tcfg, t_ctx())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-5, rtol=1e-5)
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, 256)).astype(np.float32)
        jy, jst = block(jp, jnp.asarray(x1), jst)
        ty, tst = TS.ssm_block(tp, torch.from_numpy(x1), tcfg, t_ctx(),
                               state=tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model on one device
# ---------------------------------------------------------------------------

def test_forward_logits_match_reference(model):
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 40)).astype(
        np.int32)
    jx, _ = JT.forward(jp, jnp.asarray(toks), jcfg, j_ctx(), remat=False)
    jl = np.asarray(JT.lm_logits_local(jp, jx, jcfg, j_ctx()))
    tx, taux = TT.forward(tp, torch.from_numpy(toks), tcfg, t_ctx(),
                          remat=False)
    tl = TT.lm_logits_local(tp, tx, tcfg, t_ctx()).numpy()
    real = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), real)
    np.testing.assert_allclose(tl[real], jl[real], atol=1e-5, rtol=1e-5)
    assert float(taux) == 0.0


@pytest.mark.parametrize("name", ["mamba2", "hybrid"])
def test_three_steps_match_reference(name):
    """``build_train_step`` on one device, 3 AdamW steps, against the
    reference's on a (1, 1) mesh."""
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
    """Teacher-forced decode step by step against the port's forward
    (2e-3, as the reference's test) and the reference's decode (1e-5),
    and the caches (SSM states, conv tails, the hybrid's attention K/V)
    against the reference's."""
    jcfg, tcfg, jp, tp = model
    b, s = 2, 12
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (b, s)).astype(
        np.int32)
    tx, _ = TT.forward(tp, torch.from_numpy(toks), tcfg, t_ctx(),
                       remat=False)
    full = TT.lm_logits_local(tp, tx, tcfg, t_ctx()).numpy()
    jd = JT.DecodeConfig(cache_len_local=s, seq_shard=None)
    td = TT.DecodeConfig(cache_len_local=s)
    jc = JT.init_cache(jcfg, j_ctx(), jd, b)
    tc = TT.init_cache(tcfg, t_ctx(), td, b)
    assert tc.keys() == jc.keys()
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
    for name in jc:
        assert tc[name].shape == jc[name].shape, name
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=1e-5)


def test_wave_engine_matches_jax(model):
    """Greedy streams of the wave engine equal the JAX engine's, with
    waves of unequal prompts (right-aligned: the shorter ones and the
    idle slots are fed hold tokens, which advance their SSM states in
    both packages alike) and a second wave into freed slots."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab, size=n).tolist()
               for n in (5, 3, 9, 2, 7, 12)]

    def serve(mod, p, cfg, ctx):
        eng = mod.ServeEngine(p, cfg, ctx, mod.ServeConfig(slots=4,
                                                           cache_len=96))
        for prompt in prompts:
            eng.submit(prompt, max_new=6)
        eng.run_until_drained()
        fin = eng.finished()
        eng.close()
        return fin

    got = serve(TE, tp, tcfg, t_ctx())
    assert got == serve(JE, jp, jcfg, j_ctx())
    assert len(got) == 6 and all(len(v) == 6 for v in got.values())


def test_hold_tokens_advance_ssm_states_as_the_reference():
    """The wave engine's quirk, reproduced and not fixed: a prompt
    shorter than its wave's longest is fed hold tokens first, which an
    SSM state cannot mask out, so its greedy stream depends on its wave
    (reference serving/engine.py:165-177).  Served alone and together,
    each package's streams equal the other's, and the short prompt's
    differ between the two ways."""
    jcfg = j_get_config("mamba2-1.3b").reduced()
    tcfg = t_config(jcfg)
    jp = j_init(jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    short, long = (rng.integers(1, jcfg.vocab, size=n).tolist()
                   for n in (5, 9))

    def serve(mod, p, cfg, ctx, prompts):
        eng = mod.ServeEngine(p, cfg, ctx, mod.ServeConfig(slots=2,
                                                           cache_len=32))
        for prompt in prompts:
            eng.submit(prompt, max_new=6)
        eng.run_until_drained()
        fin = eng.finished()
        eng.close()
        return fin[0]

    got = {k: serve(TE, tp, tcfg, t_ctx(), ps)
           for k, ps in (("alone", [short]), ("together", [short, long]))}
    want = {k: serve(JE, jp, jcfg, j_ctx(), ps)
            for k, ps in (("alone", [short]), ("together", [short, long]))}
    assert got == want
    assert got["alone"] != got["together"]


# ---------------------------------------------------------------------------
# data-parallel training on 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_init():
    jcfg = j_get_config("mamba2-1.3b").reduced()
    return jcfg, jax.tree.map(np.asarray,
                              j_init(jcfg))


@pytest.fixture(scope="module")
def dp_reference(dp_init):
    from repro.data.pipeline import make_batches
    from repro.launch import shapes as SH
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_program
    from repro.optim.adamw import AdamWConfig, init_state
    jcfg, init_np = dp_init
    j_comm.comm_destroy_all()
    mesh = make_mesh((2, 1), ("data", "model"))
    program, ctx = build_train_program(
        jcfg, mesh, comm=j_comm.CommConfig(profile="h800"),
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        shape=SH.InputShape("t", "train", 32, 4), name="flexlink")
    params = jax.tree.map(jnp.asarray, init_np)
    opt_state = init_state(params)
    batches = make_batches(jcfg, seq_len=32, batch_per_shard=4, seed=7)
    losses = []
    with mesh:
        for _ in range(STEPS):
            params, opt_state, m = program.step(
                params, opt_state,
                {k: jnp.asarray(v) for k, v in next(batches).items()})
            losses.append(float(m["loss"]))
    sig = tuple((a, _torch_ranks.plain_signature(s))
                for a, s in ctx.plan_signature())
    program.close()
    j_comm.comm_destroy_all()
    return {"losses": losses, "signature": sig}


@pytest.fixture(scope="module")
def dp_port(dp_init, dp_reference):
    _, init_np = dp_init
    runs = {"flexlink": {"comm": {"profile": "h800"}},
            "nccl": {"comm": {"profile": "h800", "backend": "nccl"}}}
    return run_ranks(_torch_ranks.dp_train, 2, backend="gloo", device="cpu",
                     timeout_s=300,
                     args=("mamba2-1.3b", init_np, runs, STEPS))


def test_dp_losses_match_reference_and_nccl(dp_port, dp_reference):
    """The flexlink run's losses on both ranks within 5e-3 of the
    reference's, the nccl backend's within 5e-3 of them; the data axis's
    plan signature equals the reference's."""
    got = dp_port[0]["flexlink"]["losses"]
    assert dp_port[1]["flexlink"]["losses"] == got
    assert np.max(np.abs(np.array(got) - dp_reference["losses"])) < TOL
    nccl = dp_port[0]["nccl"]["losses"]
    assert np.max(np.abs(np.array(got) - np.array(nccl))) < TOL
    assert got[-1] < got[0]
    assert dp_port[0]["flexlink"]["signature"] == dp_reference["signature"]
