"""The port's serving slice against the JAX reference on reduced glm4-9b.

The parameters are the reference's ``init_params`` tree (float32)
carried across by ``convert.py``.  Covered: ``paged_decode_step`` logits
over several ticks (within 1e-4), greedy streams of both port engines
equal to the JAX engines' on the prompts of tests/test_serving.py, the
port's paged engine equal to its wave engine with one build per batch
bucket and balanced KV books, preemption/resume, the copied allocator,
scheduler, configs and StepProgram counters, the bf16 carry-over, the
decode caches at tp = 2, and the launcher.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import single_device_ctx as j_ctx
from repro.models import transformer as JT
from repro.runtime.program import StepProgram as JStepProgram
from repro.serving import engine as JE
from repro.serving import paged_kv as j_kv
from repro.serving import scheduler as j_sched
from repro_torch import configs as t_configs
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_reference, tensor_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.models import single_device_ctx as t_ctx
from repro_torch.models import transformer as TT
from repro_torch.runtime.program import StepProgram as TStepProgram
from repro_torch.serving import engine as TE
from repro_torch.serving import paged_kv as t_kv
from repro_torch.serving import scheduler as t_sched


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("glm4-9b").reduced()
    tcfg = t_get_config("glm4-9b").reduced()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _prompts(sizes, vocab=500, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=s).tolist() for s in sizes]


# ---------------------------------------------------------------------------
# configs, runtime, unported paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_configs_match_reference(arch):
    """The ten CONFIGs and their reduced() variants are the reference's
    data, field for field."""
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert t_configs.ALIASES == j_configs.ALIASES
    j, t = j_get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.vocab_padded, t.head_dim_) == (j.vocab_padded, j.head_dim_)
    assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


def test_step_program_counters_match_reference():
    """The same call sequence gives the same executable-cache and program
    reports (rebuild per bucket, hits on revisits, shape buckets)."""
    reports = []
    for prog_cls, ctx, make in ((JStepProgram, j_ctx(), jnp.zeros),
                                (TStepProgram, t_ctx(), torch.zeros)):
        prog = prog_cls(lambda: (lambda x: x + 1.0), ctx, name="p")
        prog(make(4), shape_key=4)
        prog(make(8), shape_key=8)
        prog.issue(make(4), shape_key=4)
        prog.issue(make(4), shape_key=4)
        outs = prog.await_all()
        assert len(outs) == 2
        reports.append(prog.report())
        prog.close()
    assert reports[0] == reports[1]
    assert reports[1]["executable_cache"]["rebuilds"] == 2
    assert reports[1]["executable_cache"]["hits"] == 2


def test_unported_paths_raise():
    """Serving across devices (a model axis, ROADMAP queue 1 item 11) is
    ported: at tp = 2 the decode caches of dense, vlm, encdec and hybrid
    have the reference's local shapes, sequence-sharded (every KV head)
    and not (this shard's), encdec's cross-attention cache and the
    hybrid's SSM state this shard's; the paged pool this shard's."""
    tp2 = types.SimpleNamespace(tp_size=2)
    for arch in ("glm4-9b", "internvl2-76b", "whisper-medium",
                 "zamba2-1.2b"):
        jcfg = j_get_config(arch).reduced()
        tcfg = t_get_config(arch).reduced()
        for seq in ("model", None):
            got = TT.init_cache(tcfg, tp2, TT.DecodeConfig(
                cache_len_local=8, seq_shard=seq), 1)
            want = JT.init_cache(jcfg, tp2, JT.DecodeConfig(
                cache_len_local=8, seq_shard=seq), 1)
            assert got.keys() == want.keys(), (arch, seq)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (arch, seq, k)
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(want[k].dtype), (arch, seq, k)
        if tcfg.family in TT.PAGED_FAMILIES:
            assert tuple(TT.init_paged_pool(tcfg, tp2, TT.PagedConfig())[
                "k"].shape) == JT.init_paged_pool(jcfg, tp2, JT.PagedConfig(
                ))["k"].shape
    cfg = t_get_config("whisper-medium").reduced()
    c = TT.init_cache(cfg, tp2, TT.DecodeConfig(cache_len_local=8), 1)
    assert c["k"].shape[3] == cfg.n_kv_heads and c["xk"].shape[3] == 1


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_carry_over_matches_port_init(setup):
    """The carried-over reference tree and the port's own init_params
    share keys, shapes and dtypes; the port draws weights at std 0.02."""
    _, tcfg, _, tp = setup
    gen = torch.Generator().manual_seed(0)
    own = TT.init_params(tcfg, gen, "cpu")

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v
    a, b = dict(leaves(tp)), dict(leaves(own))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].shape == b[name].shape, name
        assert a[name].dtype == b[name].dtype == torch.float32, name
    for name in ("embed", "lm_head", "layers/attn/wq", "layers/mlp/w_down"):
        assert abs(float(b[name].std()) - 0.02) < 1e-3, name
    assert torch.all(b["layers/ln1"] == 1.0)


def test_convert_round_trips_bf16():
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 7), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x))
    assert t.dtype == torch.bfloat16 and t.shape == (5, 7)
    back = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    assert np.array_equal(back.view(np.uint16),
                          np.asarray(x).view(np.uint16))


# ---------------------------------------------------------------------------
# paged_decode_step over several ticks
# ---------------------------------------------------------------------------

# request 0 in blocks (4, 7, 1), request 1 in (2, 9, 5); each tick is
# (tokens' row_req, positions, sample_rows); -1 rows are bucket padding
TICKS = [
    ([0, 0, 0, 0, 0, 1, 1, 1], [0, 1, 2, 3, 4, 0, 1, 2], [4, 7]),
    ([0, 1, -1, -1], [5, 3, 0, 0], [0, 1]),
    ([1, 0, 1, 1, -1, -1, -1, -1], [4, 6, 5, 6, 0, 0, 0, 0], [1, 3]),
    ([0, 1, -1, -1], [7, 7, 0, 0], [0, 1]),
]


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_paged_decode_step_matches_jax(setup, impl):
    jcfg, tcfg, jp, tp = setup
    tables = np.array([[4, 7, 1], [2, 9, 5]], np.int32)
    jpool = JT.init_paged_pool(jcfg, j_ctx(), JT.PagedConfig(
        block_size=8, n_blocks=10, max_blocks_per_req=3))
    pcfg = TT.PagedConfig(block_size=8, n_blocks=10, max_blocks_per_req=3,
                          attn_impl=impl)
    tpool = TT.init_paged_pool(tcfg, t_ctx(), pcfg)
    rng = np.random.default_rng(8)
    for rows, pos, sample in TICKS:
        toks = rng.integers(1, jcfg.vocab, len(rows)).astype(np.int32)
        args = [toks, np.array(pos, np.int32), np.array(rows, np.int32),
                tables, np.array(sample, np.int32)]
        j_logits, jpool = JT.paged_decode_step(
            jp, jpool, *map(jnp.asarray, args), jcfg, j_ctx(),
            JT.PagedConfig(block_size=8, n_blocks=10, max_blocks_per_req=3))
        t_logits, tpool = TT.paged_decode_step(
            tp, tpool, *map(torch.from_numpy, args), tcfg, t_ctx(), pcfg)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=1e-4, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), atol=1e-4,
                                   rtol=0)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

PROMPTS = _prompts([5, 3, 9, 2, 7, 12])


def _wave(mod, params, cfg, ctx):
    eng = mod.ServeEngine(params, cfg, ctx,
                          mod.ServeConfig(slots=4, cache_len=96))
    for p in PROMPTS:
        eng.submit(p, max_new=6)
    eng.run_until_drained()
    fin = eng.finished()
    eng.close()
    return fin


def _paged(mod, params, cfg, ctx, **kw):
    eng = mod.PagedServeEngine(params, cfg, ctx, mod.PagedServeConfig(
        max_requests=4, cache_len=96, kv_block=16, max_tokens_in_flight=16,
        min_bucket=4, **kw))
    for p in PROMPTS:
        eng.submit(p, max_new=6)
    eng.run_until_drained()
    fin, rep = eng.finished(), eng.serving_report()
    eng.close()
    return fin, rep


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, _, jp, _ = setup
    return _wave(JE, jp, jcfg, j_ctx()), _paged(JE, jp, jcfg, j_ctx())[0]


def test_wave_engine_matches_jax(setup, jax_streams):
    _, tcfg, _, tp = setup
    assert _wave(TE, tp, tcfg, t_ctx()) == jax_streams[0]


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_paged_engine_matches_jax_and_wave(setup, jax_streams, impl):
    """Greedy streams equal the JAX paged engine's and the port's wave
    engine's; one build per batch bucket (hits > 0); KV books balance."""
    _, tcfg, _, tp = setup
    fin, rep = _paged(TE, tp, tcfg, t_ctx(), attn_impl=impl)
    assert fin == jax_streams[1]
    assert fin == _wave(TE, tp, tcfg, t_ctx())
    assert all(len(v) == 6 for v in fin.values())
    bc = rep["batch_bucket_cache"]
    assert bc["rebuilds"] == len(rep["buckets"]) and bc["hits"] > 0
    kv = rep["kv_blocks"]
    assert kv["allocs"] == kv["frees"] and kv["in_use"] == 0
    assert rep["step_ms"]["median"] > 0


def test_preemption_resume_streams_unchanged(setup):
    """A block-starved pool forces preempt-by-eviction; resume must give
    the streams of the uncontended run (the contract of
    tests/test_serving.py)."""
    _, tcfg, _, tp = setup
    prompts = _prompts([20, 18, 16, 22], seed=4)

    def run(n_blocks):
        eng = TE.PagedServeEngine(tp, tcfg, t_ctx(), TE.PagedServeConfig(
            max_requests=4, cache_len=48, kv_block=8, n_blocks=n_blocks,
            max_tokens_in_flight=16, min_bucket=4))
        for p in prompts:
            eng.submit(p, max_new=12)
        eng.run_until_drained()
        fin, rep = eng.finished(), eng.serving_report()
        eng.close()
        return fin, rep

    fin_starved, rep_starved = run(n_blocks=9)
    fin_ample, rep_ample = run(n_blocks=0)
    assert rep_starved["scheduler"]["preemptions"] > 0
    assert rep_ample["scheduler"]["preemptions"] == 0
    assert fin_starved == fin_ample


def test_scheduler_and_allocator_copies_match_reference():
    """Same calls -> same plans, block tables, reports, under
    preemption pressure."""
    prompts = _prompts([20, 5, 18, 3, 16], seed=9)

    def make(kv_mod, sched_mod):
        kv = kv_mod.PagedKVCache(9, 8, 6, 4)
        sched = sched_mod.ContinuousScheduler(kv, max_requests=4,
                                              max_tokens_in_flight=16)
        for rid, p in enumerate(prompts):
            sched.submit(sched_mod.PagedRequest(rid, list(p), 6 + rid))
        return kv, sched

    (jkv, js), (tkv, ts) = make(j_kv, j_sched), make(t_kv, t_sched)
    ticks = 0
    while js.has_work():
        assert ts.has_work()
        jplan, tplan = js.plan_tick(), ts.plan_tick()
        assert jplan.rows == tplan.rows
        assert jplan.sample_rows == tplan.sample_rows
        assert np.array_equal(jkv.tables, tkv.tables)
        sampled = {row: (7 * row + ticks) % 50 + 1
                   for row in jplan.sample_rows}
        jdone = [r.rid for r in js.commit(jplan, sampled)]
        tdone = [r.rid for r in ts.commit(tplan, sampled)]
        assert jdone == tdone
        ticks += 1
    assert not ts.has_work()
    assert js.report() == ts.report() and jkv.report() == tkv.report()
    assert js.report()["preemptions"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_sampling_on_bf16_logits_matches_reference(temperature):
    """Temperature sampling of bf16 logits: the reference's samplers on an
    ml_dtypes bf16 array (a bf16 array divided by a Python float comes out
    float32) and the port's on the same bits as a torch bf16 tensor
    through ``_host_logits`` (float32) draw the same 200 tokens from one
    numpy seed, in both engines."""
    rng = np.random.default_rng(23)
    rows = (rng.standard_normal((200, 512)) * 3).astype(
        np.float32).astype(ml_dtypes.bfloat16)
    host = TE._host_logits(torch.from_numpy(rows.view(np.int16)).view(
        torch.bfloat16))
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, rows.astype(np.float32))
    for j_cls, t_cls, j_arg, t_arg in (
            (JE.ServeEngine, TE.ServeEngine,
             JE.Request(0, [1], temperature=temperature),
             TE.Request(0, [1], temperature=temperature)),
            (JE.PagedServeEngine, TE.PagedServeEngine, temperature,
             temperature)):
        j_self = types.SimpleNamespace(rng=np.random.default_rng(5))
        t_self = types.SimpleNamespace(rng=np.random.default_rng(5))
        want = [j_cls._sample(j_self, row, j_arg) for row in rows]
        got = [t_cls._sample(t_self, row, t_arg) for row in host]
        assert got == want, t_cls.__name__
        argmax = [int(row.argmax()) for row in host]
        assert (want == argmax) == (temperature == 0.0)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launcher_paged_kernel_smoke_on_cpu(capsys):
    rc = t_serve.main(["--smoke", "--paged", "on", "--attn-impl", "kernel",
                       "--device", "cpu", "--assert-warm"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "[OK] --assert-warm" in out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_launcher_paged_refuses_ssm_and_hybrid(arch):
    """``--paged on`` refuses the ssm and hybrid families with the
    reference's ValueError (they stay on the wave engine), as the
    reference's launcher does; ``--paged off`` serves them."""
    from repro.launch import serve as j_serve
    argv = ["--arch", arch, "--smoke", "--paged", "on", "--requests", "2"]
    with pytest.raises(ValueError, match="stay on the wave engine"):
        j_serve.main(argv)
    with pytest.raises(ValueError, match="stay on the wave engine"):
        t_serve.main(argv + ["--device", "cpu"])
    assert t_serve.main(["--arch", arch, "--smoke", "--requests", "2",
                         "--max-new", "3", "--device", "cpu"]) == 0


def test_launcher_without_card_exits_nonzero(monkeypatch, capsys):
    """The default device is the card; with none present the launcher
    refuses instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_serve.main(["--smoke", "--paged", "on"]) != 0
    assert "no CUDA card" in capsys.readouterr().err
